"""Device ms per traced step launched inside the train step's forward and
loss of each microbatch (``pangu.train.forward``; ``_spans``)."""

from benchmark.metrics._spans import read_ranges


def read(rec):
    return read_ranges(rec, ["pangu.train.forward"])
