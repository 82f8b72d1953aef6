"""K7, K6's backward (``csrc/fused_mlp.cu`` with ``mlp_hidden.cuh``,
``mlp_wg.cuh``, ``gemm.cuh``): twice K6's products (no recompute counted)."""

from benchmark.kernels import sizes

PATTERNS = ("mlp_hidden_bwd_kernel", "mlp_tail_kernel", "wg_gemm_kernel", "colsum_kernel",
            "reduce_partials_kernel")
COUNTER = ("pangu_tpu_torch.ops.fused_mlp", "BWD_LAUNCHES")


def work(st, c, heads, shifted, batch):
    s = sizes(st, c, heads, shifted, batch)
    r = s["r"]
    return 32 * r * c * c, 0, 3 * s["act"] + 8 * r + 2 * s["w_mlp"] + 2 * s["ln"]
