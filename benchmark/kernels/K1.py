"""K1, the inference block in one call (``ops/fused_block_attention.py::
fused_earth_block``, ``csrc/fused_earth_block.cu``): window attention with
the earth bias, projection, residual LayerNorm, MLP, residual LayerNorm."""

from benchmark.kernels import sizes

PATTERNS = ("window_attention_kernel", "mlp_tail_kernel")
COUNTER = ("pangu_tpu_torch.ops.fused_block_attention", "LAUNCHES")


def work(st, c, heads, shifted, batch):
    s = sizes(st, c, heads, shifted, batch)
    r = s["r"]
    return (24 * r * c * c + 4 * r * s["t"] * c, 0,
            2 * s["act"] + s["tables"] + s["w_attn"] + s["w_mlp"] + 2 * s["ln"])
