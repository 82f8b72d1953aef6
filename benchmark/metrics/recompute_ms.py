"""Device ms per traced step of the checkpoints' replays: the launches of the
``pangu.block.stages`` ranges that lie inside a ``pangu.train.backward``
interval, each on its own (the autograd engine's) thread (``_spans``)."""

from benchmark.metrics import _spans

NAMES = ["pangu.block.stages"]


def read(rec):
    if rec.profile is None:
        return None
    events = rec.profile.events
    replays = _spans.inside(_spans.ranges(events, NAMES),
                            _spans.ranges(events, ["pangu.train.backward"]))
    return _spans.ms_per_step(rec, replays, NAMES)
