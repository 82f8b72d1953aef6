"""Aurora in the benchmark at its architecture's tiny geometry on the CPU: the
module keeps the contract, a sound run of ``aurora_b1`` is correct and an
altered one (its forecast, its passed-through state or its clock) is not,
the fp8 control fails, the FLOP count is the reference's own products, a
train cell is refused by name, and the three span readers read their
ranges."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import arch as contract
from benchmark import control, harness, trace
from benchmark.arch import aurora
from benchmark.reference import aurora as reference
from benchmark.tests import tiny
from benchmark.tests.test_portbench_metrics import kern, launch, op, read, record

CPU = torch.device("cpu")
CELL = "aurora_b1"
SEED = 2**31 + 11


def test_the_architecture_keeps_the_forecast_contract():
    c = tiny.cell(CELL)
    assert c.config["architecture"] == "aurora" and c.config["reduced"] == []
    assert harness.architecture(c.config) is aurora
    assert all(hasattr(aurora, f) for f in contract.FORECAST)
    assert not any(hasattr(aurora, f) for f in contract.TRAINING)
    assert c.traffic["loop"] == "rollout" and c.chips == 1
    assert c.config["model"]["compute_dtype"] == "bfloat16" and not c.config["allow_tf32"]


def test_the_model_is_built_through_the_programs_step():
    c = tiny.cell(CELL)
    cfg, model = aurora.build_model(c, 5, CPU)
    shapes = reference.param_shapes(c.config["model"])
    assert {n: tuple(t.shape) for n, t in model.state_dict().items()} == shapes
    k = aurora.constants(c.config, 5, CPU)
    (state,) = aurora.states(c.config, k, 5, CPU, 1, 1)
    assert state[4].item() % 6 == 0 and aurora.CLOCK_HOURS[0] <= state[4].item() < 482136
    out = aurora.forecast_step(model, aurora.aux_constants(k))(*state)
    assert out[0] is state[2] and out[1] is state[3] and out[4].item() == state[4].item() + 6
    assert model.decoder.atmos_head.weight.dtype == torch.bfloat16
    with torch.no_grad():
        ref = aurora.reference_step(aurora.weights(c.config, 5, CPU), c.config, state, k)
    gaps = aurora.forecast_gaps(out, ref, k)
    assert 1e-4 < gaps["rel_rms"] < c.limits["rel_rms"], gaps


def test_a_sound_run_is_correct():
    rec = tiny.run(tiny.cell(CELL), seed=SEED)
    assert rec.compared >= 1 and rec.correct, rec.checks


def _altered(real):
    def forecast_step(model, aux):
        step = real(model, aux)

        def wrong(*state):
            u, s, u1, s1, h = step(*state)
            u1 = u1.clone()
            u1[:, 0, 3] += 0.25 * aux.upper_std[0, 0, 3]
            return u, s, u1, s1, h

        return wrong

    return forecast_step


def _passed_through_altered(real):
    def forecast_step(model, aux):
        step = real(model, aux)

        def wrong(*state):
            u, s, u1, s1, h = step(*state)
            return u, s + 0.25 * aux.surface_std, u1, s1, h

        return wrong

    return forecast_step


def _clock_left(real):
    def forecast_step(model, aux):
        step = real(model, aux)

        def wrong(*state):
            return (*step(*state)[:4], state[4])

        return wrong

    return forecast_step


@pytest.mark.parametrize("fault", [_altered, _passed_through_altered, _clock_left])
def test_an_altered_run_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(aurora, "forecast_step", fault(aurora.forecast_step))
    rec = tiny.run(tiny.cell(CELL), seed=SEED)
    assert rec.compared >= 1 and not rec.correct, rec.checks
    assert rec.checks["max_abs"][0] >= 0.2


def test_the_fp8_control_fails():
    c = tiny.cell(CELL)
    for seed in (1, 2, 3):
        (rec,) = control.verdicts(c, seed, CPU, "fp8").values()
        assert rec.compared == 5 and not rec.correct, (seed, rec.checks)


def test_the_flop_count_is_the_references_products():
    """Every product the reference makes (a dispatch counter over mm and
    bmm), at batch 2."""
    c = tiny.cell(CELL)
    params = aurora.weights(c.config, 1, CPU)
    k = aurora.constants(c.config, 1, CPU)
    (state,) = aurora.states(c.config, k, 1, CPU, 1, 2)
    with FlopCounterMode(display=False) as counted:
        reference.forward(params, c.config["model"], *state, k)
    assert counted.get_total_flops() == aurora.forward_matmul_flops(c.config, batch=2)


def test_the_published_step_counts_its_products():
    c = harness.load_cell(tiny.spec(), CELL, tiny.ROOT)
    assert aurora.forward_matmul_flops(c.config) == pytest.approx(94.487e12, rel=1e-4)


def test_a_train_cell_is_refused_by_name():
    c = tiny.cell(CELL)
    with pytest.raises(AttributeError, match="'aurora'.*train_step"):
        harness.architecture(c.config, contract.TRAINING)


NEW = ["aurora_block_ms.forecast", "aurora_attention_ms.forecast", "perceiver_ms.forecast"]


def aurora_events(steps, blocks=2):
    """``steps`` steps of 1000 us: the encode, resample and decode ranges each
    launch one 1 us kernel; each block range launches one 2 us kernel of its
    own and holds an attention range that launches one 5 us kernel."""
    out, corr = [], 0

    def ranged(name, ts, dur, us):
        nonlocal corr
        corr += 1
        return [op(name, ts, dur, cat="user_annotation"), launch(ts + 1, 1, corr),
                kern("k", ts + 2, us, corr)]

    for s in range(steps):
        t = 1000 * s
        out += ranged("aurora.encode", t, 8, 1)
        for b in range(blocks):
            tb = t + 100 + 100 * b
            out += ranged("aurora.block", tb, 60, 2) + ranged("aurora.block.attention", tb + 20,
                                                                30, 5)
        out += ranged("aurora.resample", t + 700, 8, 1) + ranged("aurora.decode", t + 820, 8, 1)
    return out


@pytest.mark.parametrize("steps", [1, 3])
def test_the_span_readers_read_their_ranges_per_step(steps):
    rec = record(cell=CELL, profile=trace.Profile(aurora_events(steps), steps, 1e-3))
    assert read("aurora_block_ms.forecast", rec) == pytest.approx(0.014)  # 2 x (2 + 5) us
    assert read("aurora_attention_ms.forecast", rec) == pytest.approx(0.010)
    assert read("perceiver_ms.forecast", rec) == pytest.approx(0.002)  # the resample is not read


@pytest.mark.parametrize("name", NEW)
def test_a_missing_range_reads_none(name):
    assert read(name, record(cell=CELL, profile=None)) is None
    assert read(name, record(cell=CELL, profile=trace.Profile([], 3, 1e-3))) is None
    events = [e for e in aurora_events(3) if e.get("name") not in (
        "aurora.block.attention", "aurora.block", "aurora.decode")]
    assert read(name, record(cell=CELL, profile=trace.Profile(events, 3, 1e-3))) is None
    fuxi_only = [op("fuxi.block", 0, 5, cat="user_annotation")]
    assert read(name, record(cell=CELL, profile=trace.Profile(fuxi_only, 1, 1e-3))) is None


def test_the_cell_reports_its_metrics_and_the_shared_ones():
    c = tiny.cell(CELL)
    assert [m["name"] for m in c.end_to_end] == ["forecast_rate", "forecast_step_p95_ms",
                                                 "setup_s"]
    assert [m["name"] for m in c.per_layer] == ["dispatch_ms.forecast", "mfu.forecast",
                                                "idle_pct.forecast", "peak_gib.forecast"] + NEW
    for m in c.per_layer:
        harness.metric_reader(m["name"])
