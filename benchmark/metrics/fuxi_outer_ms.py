"""Device ms per traced step launched outside FuXi's blocks: the
normalization in and the cube embedding, the Down Block, the Up Block, the
head with its interpolation and the normalization back (``fuxi.embed``,
``fuxi.down``, ``fuxi.up``, ``fuxi.head``; ``_spans``)."""

from benchmark.metrics._spans import read_ranges


def read(rec):
    return read_ranges(rec, ["fuxi.embed", "fuxi.down", "fuxi.up", "fuxi.head"])
