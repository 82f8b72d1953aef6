"""Device ms per traced step launched inside Aurora's
``aurora.block.attention`` ranges: each block's work between its qkv and
output projections (the pad, the roll, the window partition, the shift
mask, ``scaled_dot_product_attention``, the reverse, the roll back and the
crop; ``_spans``)."""

from benchmark.metrics._spans import read_ranges


def read(rec):
    return read_ranges(rec, ["aurora.block.attention"])
