"""Device ms per traced step launched inside FuXi's ``fuxi.block`` ranges:
the 48 Swin V2 blocks whole, their attention included (``_spans``)."""

from benchmark.metrics._spans import read_ranges


def read(rec):
    return read_ranges(rec, ["fuxi.block"])
