"""Device ms per traced step launched outside the four layers: the patch
embedding, the down- and upsampling, the skip concat and the recovery, and
``norm_back_data`` (``pangu.embed``, ``pangu.resample``, ``pangu.recovery``,
``pangu.norm_back``; ``_spans``)."""

from benchmark.metrics._spans import read_ranges


def read(rec):
    return read_ranges(rec, ["pangu.embed", "pangu.resample", "pangu.recovery",
                             "pangu.norm_back"])
