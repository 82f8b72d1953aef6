"""K6, the MLP tail ``x + s * LN(MLP(x))`` (``ops/fused_mlp.py::
fused_mlp_postnorm``, ``csrc/fused_mlp.cu``)."""

from benchmark.kernels import sizes

PATTERNS = ("mlp_tail_kernel",)
COUNTER = ("pangu_tpu_torch.ops.fused_mlp", "FWD_LAUNCHES")


def work(st, c, heads, shifted, batch):
    s = sizes(st, c, heads, shifted, batch)
    r = s["r"]
    return 16 * r * c * c, 0, 2 * s["act"] + 4 * r + s["w_mlp"] + s["ln"]
