"""The share of their roofline of the train step's kernels, K2-K7 with the
products they launch (``_roofline.share``)."""

from benchmark.metrics._roofline import share


def read(rec):
    return share(rec, ["K2", "K3", "K4", "K5", "K6", "K7"])
