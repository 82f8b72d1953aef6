"""Device ms per traced step launched inside the blocks' ``pangu.block.shift``
ranges: each block's pad re-zero and, in a shifted block, its roll and roll
back (``_spans``)."""

from benchmark.metrics._spans import read_ranges


def read(rec):
    return read_ranges(rec, ["pangu.block.shift"])
