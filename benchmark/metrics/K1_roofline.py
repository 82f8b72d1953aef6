"""K1's share of its roofline in the forecast step (``_roofline.share``)."""

from benchmark.metrics._roofline import share


def read(rec):
    return share(rec, ["K1"])
