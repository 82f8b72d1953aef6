"""K3, K2's backward (``csrc/block_attention.cu`` with ``attention_bwd.cuh``):
twice K2's products (no recompute counted); reads x, dy, the tables and
weights, writes dx, the earth-bias gradient and the weight gradients."""

from benchmark.kernels import sizes

PATTERNS = ("attention_bwd_regs_kernel", "wg_gemm_kernel", "colsum_kernel",
            "reduce_partials_kernel")
COUNTER = ("pangu_tpu_torch.ops.fused_block_attention", "ATTN_BWD_LAUNCHES")


def work(st, c, heads, shifted, batch):
    s = sizes(st, c, heads, shifted, batch)
    r = s["r"]
    return (16 * r * c * c + 8 * r * s["t"] * c, 0,
            3 * s["act"] + 2 * s["tables"] + 2 * s["w_attn"])
