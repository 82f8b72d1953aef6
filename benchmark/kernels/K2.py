"""K2, the training window attention (``ops/fused_block_attention.py::
fused_block_attention``, ``csrc/block_attention.cu``): qkv, scores with the
earth bias, softmax, PV, projection."""

from benchmark.kernels import sizes

PATTERNS = ("window_attention_kernel", "wg_gemm_kernel")
COUNTER = ("pangu_tpu_torch.ops.fused_block_attention", "ATTN_FWD_LAUNCHES")


def work(st, c, heads, shifted, batch):
    s = sizes(st, c, heads, shifted, batch)
    r = s["r"]
    return 8 * r * c * c + 4 * r * s["t"] * c, 0, 2 * s["act"] + s["tables"] + s["w_attn"]
