"""Device ms per traced step launched inside FuXi's ``fuxi.block.attention``
ranges: each block's work between its qkv and output projections (the
cosine normalization and temperature, the gathers that shift and partition
the windows and put them back, the position bias and mask, the softmax and
the two window products; ``_spans``)."""

from benchmark.metrics._spans import read_ranges


def read(rec):
    return read_ranges(rec, ["fuxi.block.attention"])
