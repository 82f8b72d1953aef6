"""K4, the first residual ``x + s * LN(y)`` (``ops/fused_epilogue.py::
fused_residual_postnorm``, ``csrc/fused_epilogue.cu``)."""

from benchmark.kernels import sizes

PATTERNS = ("residual_postnorm_fwd_kernel",)
COUNTER = ("pangu_tpu_torch.ops.fused_epilogue", "FWD_LAUNCHES")


def work(st, c, heads, shifted, batch):
    s = sizes(st, c, heads, shifted, batch)
    return 0, 10 * s["r"] * c, 3 * s["act"] + 4 * s["r"] + s["ln"]
