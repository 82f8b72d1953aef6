"""Device ms per traced step launched inside Aurora's ``aurora.block``
ranges: the 48 AdaLN 3D Swin blocks whole, their attention included
(``_spans``)."""

from benchmark.metrics._spans import read_ranges


def read(rec):
    return read_ranges(rec, ["aurora.block"])
