"""K5, K4's backward (``csrc/fused_epilogue.cu``)."""

from benchmark.kernels import sizes

PATTERNS = ("residual_postnorm_bwd_kernel", "reduce_partials_kernel")
COUNTER = ("pangu_tpu_torch.ops.fused_epilogue", "BWD_LAUNCHES")


def work(st, c, heads, shifted, batch):
    s = sizes(st, c, heads, shifted, batch)
    return 0, 16 * s["r"] * c, 3 * s["act"] + 8 * s["r"] + 2 * s["ln"]
