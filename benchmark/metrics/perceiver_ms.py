"""Device ms per traced step launched inside Aurora's ``aurora.encode`` and
``aurora.decode`` ranges: the normalization in, the embeddings, the
encodings and the encoder Perceiver; the decoder Perceiver, the heads, the
unpatchify and the normalization back (``_spans``)."""

from benchmark.metrics._spans import read_ranges


def read(rec):
    return read_ranges(rec, ["aurora.encode", "aurora.decode"])
