"""The readers of the program's named ranges (``metrics/_spans.py``) on
synthetic traces: which launches each range holds by its thread rule, the
replays the recompute counts, and None where the ranges are absent or their
count does not divide over the traced steps."""

import pytest

from benchmark import harness, trace
from benchmark.metrics import _spans
from benchmark.tests import test_portbench_layout as layout
from benchmark.tests import tiny
from benchmark.tests.test_portbench_metrics import kern, launch, op, read, record

NEW = ["shift_ms.forecast", "outer_ms.forecast", "forward_ms.train", "backward_ms.train",
       "recompute_ms.train"]


def rng(name, ts, dur, tid=1):
    return op(name, ts, dur, cat="user_annotation", tid=tid)


def train_events():
    """One step on the main thread (tid 1): a forward that launches k1, then
    a backward range while the autograd thread (tid 2) launches k2 and a
    checkpoint's replay that launches k3; k4 launches in the optimizer."""
    return [rng(trace.STEP_SPAN, 0, 1000),
            rng("pangu.train.forward", 10, 190), launch(20, 5, 1),
            rng("pangu.block.stages", 30, 40), launch(40, 5, 5),
            rng("pangu.train.backward", 300, 500),
            launch(350, 5, 2, tid=2), rng("pangu.block.stages", 400, 100, tid=2),
            launch(420, 5, 3, tid=2),
            rng("Optimizer.step#Adam.step", 850, 100), launch(860, 5, 4),
            kern("k1", 30, 10, 1), kern("k5", 50, 1, 5), kern("k2", 360, 20, 2),
            kern("k3", 430, 40, 3), kern("k4", 900, 80, 4)]


def test_backward_reads_every_thread_and_forward_its_own():
    rec = record(cell="finetune_b1", profile=trace.Profile(train_events(), 1, 1e-3))
    assert read("forward_ms.train", rec) == pytest.approx(0.011)  # k1 + k5
    assert read("backward_ms.train", rec) == pytest.approx(0.060)  # k2 + k3, on tid 2
    assert read("recompute_ms.train", rec) == pytest.approx(0.040)  # k3 alone
    assert read("optimizer_ms.train", rec) == pytest.approx(0.080)


@pytest.mark.parametrize("name,own", [("pangu.train.forward", 0.011), ("pangu.block.shift", 0.0),
                                      ("pangu.embed", 0.0)])
def test_a_same_thread_range_over_the_backward_holds_none_of_its_kernels(name, own):
    """A range of the waiting thread (tid 1) laid over the backward's
    interval reads only what that thread launched."""
    events = train_events() + [rng(name, 300, 500)]
    rec = record(cell="finetune_b1", profile=trace.Profile(events, 1, 1e-3))
    assert _spans.read_ranges(rec, [name]) == pytest.approx(own)
    assert read("backward_ms.train", rec) == pytest.approx(0.060)


def test_a_replay_outside_every_backward_is_no_recompute():
    events = [e for e in train_events() if e.get("name") != "pangu.block.stages"
              or e["tid"] != 2]
    events.append(rng("pangu.block.stages", 400, 100, tid=3))  # inside, another thread
    events.append(launch(420, 5, 3, tid=3))
    rec = record(cell="finetune_b1", profile=trace.Profile(events, 1, 1e-3))
    assert read("recompute_ms.train", rec) == pytest.approx(0.040)
    events = [e for e in train_events() if e.get("name") != "pangu.train.backward"]
    events.append(rng("pangu.train.backward", 300, 50))  # ends before the replay
    rec.profile.events = events
    assert read("recompute_ms.train", rec) is None


def forecast_events(steps, shifts_per_step=3):
    """``steps`` forecast steps of 100 us: each with one range of every outer
    name and ``shifts_per_step`` shift ranges, each launching one 1 us kernel."""
    out, corr = [], 0
    outer = ["pangu.embed", "pangu.resample", "pangu.resample", "pangu.recovery",
             "pangu.norm_back"]
    for s in range(steps):
        t0 = 1000 * s
        names = outer + ["pangu.block.shift"] * shifts_per_step
        for i, n in enumerate(names):
            corr += 1
            ts = t0 + 10 * i
            out += [rng(n, ts, 8), launch(ts + 1, 1, corr), kern("k", ts + 2, 1, corr)]
    return out


@pytest.mark.parametrize("steps", [1, 3])
def test_the_forecast_readers_read_per_step(steps):
    rec = record(profile=trace.Profile(forecast_events(steps), steps, 1e-3))
    assert read("shift_ms.forecast", rec) == pytest.approx(0.003)
    assert read("outer_ms.forecast", rec) == pytest.approx(0.005)


@pytest.mark.parametrize("name", NEW)
def test_a_missing_range_or_a_count_off_the_steps_reads_none(name):
    cell = "forecast_b1" if name.endswith("forecast") else "finetune_b1"
    events = forecast_events(3) if cell == "forecast_b1" else train_events() * 3
    assert read(name, record(cell=cell, profile=None)) is None
    assert read(name, record(cell=cell, profile=trace.Profile([], 3, 1e-3))) is None
    assert read(name, record(cell=cell, profile=trace.Profile(events, 2, 1e-3))) is None
    assert read(name, record(cell=cell, profile=trace.Profile(events, 3, 1e-3))) is not None


def test_the_new_metrics_keep_the_contract():
    layout.test_benchmark_json_keeps_its_contract()
    spec = tiny.spec()
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    assert list(per_layer)[-len(NEW):] == NEW
    for name in NEW:
        m = per_layer[name]
        assert m["source"] == "device_trace" and m["unit"] == "ms"
        for w in m["workloads"]:
            assert name in [x["name"] for x in harness.load_cell(spec, w, tiny.ROOT).per_layer]
