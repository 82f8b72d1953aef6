"""Device ms per traced step launched, on any thread, while the train step's
``backward()`` of a microbatch runs (``pangu.train.backward``): the autograd
engine's thread launches the backward, recompute included (``_spans``)."""

from benchmark.metrics._spans import read_ranges


def read(rec):
    return read_ranges(rec, ["pangu.train.backward"], any_thread=True)
