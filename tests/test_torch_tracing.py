"""The port's named ranges (``utils/profiling.py``: ``span`` and ``Spans``)
on a tiny geometry: which ranges a forecast step and a train step open under
``torch.profiler``, as the exported Chrome trace holds them, and that with
no profiler running they cost nothing but a flag read: no
``record_function`` is built, and ``Spans.mark`` without a totals dict
neither synchronizes nor reads the clock.

On the CPU the autograd engine runs the backward on the thread that called
``backward()``; on the card it runs it on its own thread, which the test
marked ``gpu`` checks.
"""

import dataclasses
import json
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.config import pangu_tiny
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.rollout import make_forecast_step
from pangu_tpu_torch.train import Batch, make_optimizer, make_train_step
from pangu_tpu_torch.utils import profiling
from pangu_tpu_torch.utils.profiling import Spans, span

DEPTHS = (2, 2, 2, 2)  # 8 blocks, 4 of them shifted
STEP = "test.step"


def build(device="cpu", **model):
    torch.manual_seed(0)
    cfg = pangu_tiny(depths=DEPTHS, **model)
    m = cfg.model
    aux = synthetic_aux_constants(m, cfg.train, device=device)
    net = PanguModel(m).to(device)
    upper = torch.randn(1, m.upper_vars, m.levels, m.lat, m.lon, device=device)
    surface = torch.randn(1, m.surface_vars, m.lat, m.lon, device=device)
    return cfg, aux, net, upper, surface


def traced(fn, steps, path):
    """The complete events of ``steps`` calls of ``fn``, each inside a
    ``STEP`` range, from the exported Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(steps):
            with torch.profiler.record_function(STEP):
                fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def named(events, name):
    return [e for e in events if e.get("name") == name and e.get("cat") == "user_annotation"]


def holds(outer, e):
    return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("steps", [1, 2])
def test_a_forecast_step_opens_the_ranges_of_its_plain_ops(tmp_path, steps):
    _, aux, net, upper, surface = build()
    step = make_forecast_step(net, aux)
    step(upper, surface)
    events = traced(lambda: step(upper, surface), steps, tmp_path / "t.json")
    counts = Counter(e["name"] for e in events
                     if e.get("cat") == "user_annotation" and e["name"].startswith("pangu."))
    blocks = sum(DEPTHS)
    assert counts == {"pangu.embed": steps, "pangu.resample": 2 * steps,
                      "pangu.recovery": steps, "pangu.norm_back": steps,
                      "pangu.block.shift": (blocks + blocks // 2) * steps}
    windows = named(events, STEP)
    assert len(windows) == steps
    assert all(any(holds(w, e) for w in windows) for e in named(events, "pangu.block.shift"))


@pytest.mark.parametrize("steps", [1, 2])
def test_on_the_k1_route_each_block_opens_one_shift_range_a_step(tmp_path, steps):
    """bf16 with ``use_kernel``: K1 takes the shift and the pad re-zero, so a
    shifted block opens no second range for a roll back."""
    _, aux, net, upper, surface = build(compute_dtype="bfloat16", use_pallas_attention=True)
    step = make_forecast_step(net, aux)
    step(upper, surface)
    events = traced(lambda: step(upper, surface), steps, tmp_path / "t.json")
    shifts = named(events, "pangu.block.shift")
    assert len(shifts) == sum(DEPTHS) * steps
    windows = named(events, STEP)
    assert all(any(holds(w, e) for w in windows) for e in shifts)


@pytest.mark.parametrize("remat,accum", [(True, 1), (False, 1), (True, 2)])
def test_a_train_step_splits_into_forward_backward_and_recompute(tmp_path, remat, accum):
    cfg, aux, net, upper, surface = build(remat=remat)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, accumulation_steps=accum))
    optimizer = make_optimizer(net, cfg)
    step = make_train_step(net, cfg, optimizer)
    if accum > 1:
        upper, surface = (torch.stack([x] * accum) for x in (upper, surface))
    batch = Batch(upper, surface, upper, surface)
    gen = torch.Generator().manual_seed(1)
    events = traced(lambda: step(batch, aux, gen), 1, tmp_path / "t.json")
    forward, backward = named(events, "pangu.train.forward"), named(events, "pangu.train.backward")
    assert len(forward) == len(backward) == accum
    for phase in ("forward_backward", "update"):
        assert len(named(events, f"pangu.train.{phase}")) == 1
    replays = [s for s in named(events, "pangu.block.stages")
               if any(holds(b, s) for b in backward)]
    assert bool(replays) == remat


def test_no_record_function_is_built_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler")

    _, aux, net, upper, surface = build()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    make_forecast_step(net, aux)(upper, surface)
    timer = Spans("eval")
    for _ in timer.iterate("load", [1, 2]):
        with timer("score"):
            pass
    with span("pangu.test"):
        pass
    with pytest.raises(AssertionError):  # and a running profiler does build one
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with span("pangu.test"):
                pass


@pytest.mark.parametrize("totals", [None, {}])
def test_spans_synchronize_only_for_a_totals_dict(monkeypatch, totals):
    syncs, clock = [], []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a))
    real = profiling.time.perf_counter
    monkeypatch.setattr(profiling, "time",
                        SimpleNamespace(perf_counter=lambda: clock.append(1) or real()))
    timer = Spans("fit", totals, torch.device("cuda", 0))
    for _ in timer.iterate("load", [1, 2]):
        with timer("h2d"):
            pass
    timer.mark("save")
    if totals is None:
        assert syncs == [] and clock == []
    else:
        assert len(syncs) == 5 and sorted(totals) == ["h2d", "load", "save"]
        assert all(v >= 0 for v in totals.values())


def test_spans_phases_are_ranges_on_the_trace_without_totals(tmp_path):
    timer = Spans("eval")

    def loop():
        for _ in timer.iterate("load", [1, 2, 3]):
            with timer("h2d"):
                pass

    events = traced(loop, 1, tmp_path / "t.json")
    assert len(named(events, "pangu.eval.load")) == 4  # the fetch that finds the end too
    assert len(named(events, "pangu.eval.h2d")) == 3


@pytest.mark.gpu
def test_on_the_card_the_replays_run_on_the_autograd_thread(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: on the CPU the backward runs on the calling thread")
    cfg, aux, net, upper, surface = build("cuda", remat=True)
    step = make_train_step(net, cfg, make_optimizer(net, cfg))
    batch = Batch(upper, surface, upper, surface)
    gen = torch.Generator(device="cuda").manual_seed(1)
    step(batch, aux, gen)
    events = traced(lambda: step(batch, aux, gen), 1, tmp_path / "t.json")
    (backward,) = named(events, "pangu.train.backward")
    replays = [s for s in named(events, "pangu.block.stages") if holds(backward, s)]
    assert replays and all(s["tid"] != backward["tid"] for s in replays)
