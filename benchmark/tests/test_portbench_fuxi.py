"""FuXi in the benchmark at its architecture's tiny geometry on the CPU: the
module keeps the contract, a sound run of ``fuxi_short_b1`` is correct and
an altered one is not, the fp8 control fails, the FLOP count is the
reference's own products, a train cell is refused by name, and the three
span readers read their ranges."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import arch as contract
from benchmark import control, harness, trace
from benchmark.arch import fuxi
from benchmark.reference import fuxi as reference
from benchmark.tests import tiny
from benchmark.tests.test_portbench_metrics import kern, launch, op, read, record

CPU = torch.device("cpu")
CELL = "fuxi_short_b1"


def test_the_architecture_keeps_the_forecast_contract():
    c = tiny.cell(CELL)
    assert c.config["architecture"] == "fuxi" and c.config["reduced"] == []
    assert harness.architecture(c.config) is fuxi
    assert all(hasattr(fuxi, f) for f in contract.FORECAST)
    assert not any(hasattr(fuxi, f) for f in contract.TRAINING)
    assert c.traffic["loop"] == "rollout" and c.chips == 1


def test_the_model_is_built_through_the_programs_step():
    c = tiny.cell(CELL)
    cfg, model = fuxi.build_model(c, 5, CPU)
    shapes = reference.param_shapes(c.config["model"])
    assert {n: tuple(t.shape) for n, t in model.state_dict().items()} == shapes
    k = fuxi.constants(c.config, 5, CPU)
    ((prev, cur),) = fuxi.states(c.config, k, 5, CPU, 1, 1)
    out = fuxi.forecast_step(model, fuxi.aux_constants(k))(prev, cur)
    assert out[0] is cur and model.head.weight.dtype == torch.bfloat16
    with torch.no_grad():
        ref = fuxi.reference_step(fuxi.weights(c.config, 5, CPU), c.config, (prev, cur), k)
    gaps = fuxi.forecast_gaps(out, ref, k)
    assert 1e-4 < gaps["rel_rms"] < c.limits["rel_rms"], gaps


def test_a_sound_run_is_correct():
    rec = tiny.run(tiny.cell(CELL), seed=2**31 + 11)
    assert rec.compared >= 1 and rec.correct, rec.checks


def _altered(real):
    def forecast_step(model, aux):
        step = real(model, aux)

        def wrong(prev, cur):
            cur, nxt = step(prev, cur)
            nxt = nxt.clone()
            nxt[:, 0] += 0.25 * aux.std[0, 0]
            return cur, nxt

        return wrong

    return forecast_step


def _passed_through_altered(real):
    def forecast_step(model, aux):
        step = real(model, aux)

        def wrong(prev, cur):
            cur, nxt = step(prev, cur)
            return cur + 0.25 * aux.std, nxt

        return wrong

    return forecast_step


@pytest.mark.parametrize("fault", [_altered, _passed_through_altered])
def test_an_altered_run_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(fuxi, "forecast_step", fault(fuxi.forecast_step))
    rec = tiny.run(tiny.cell(CELL), seed=2**31 + 11)
    assert rec.compared >= 1 and not rec.correct, rec.checks
    assert rec.checks["max_abs"][0] >= 0.2


def test_the_fp8_control_fails():
    c = tiny.cell(CELL)
    for seed in (1, 2, 3):
        (rec,) = control.verdicts(c, seed, CPU, "fp8").values()
        assert rec.compared == 5 and not rec.correct, (seed, rec.checks)


def test_the_flop_count_is_the_references_products():
    """Every product the reference makes (a dispatch counter over mm, bmm
    and the convolutions) but the position-bias MLP's, whose tables the
    program makes once per model."""
    c = tiny.cell(CELL)
    m = c.config["model"]
    params = fuxi.weights(c.config, 1, CPU)
    k = fuxi.constants(c.config, 1, CPU)
    (state,) = fuxi.states(c.config, k, 1, CPU, 1, 2)
    with FlopCounterMode(display=False) as whole:
        reference.forward(params, m, *state, k)
    with FlopCounterMode(display=False) as tables:
        for i in range(m["depth"]):
            reference.position_bias(params, f"blocks.{i}.attn.", m["window"][0], m["heads"], "f32")
    counted = whole.get_total_flops() - tables.get_total_flops()
    assert tables.get_total_flops() > 0
    assert counted == fuxi.forward_matmul_flops(c.config, batch=2)


def test_a_train_cell_is_refused_by_name():
    c = tiny.cell(CELL)
    with pytest.raises(AttributeError, match="'fuxi'.*train_step"):
        harness.architecture(c.config, contract.TRAINING)


NEW = ["swin_ms.forecast", "cosine_attention_ms.forecast", "fuxi_outer_ms.forecast"]


def fuxi_events(steps, blocks=2):
    """``steps`` steps of 1000 us: the outer ranges each launch one 1 us
    kernel; each block range launches one 2 us kernel of its own and holds
    an attention range that launches one 5 us kernel."""
    out, corr = [], 0

    def ranged(name, ts, dur, us):
        nonlocal corr
        corr += 1
        return [op(name, ts, dur, cat="user_annotation"), launch(ts + 1, 1, corr),
                kern("k", ts + 2, us, corr)]

    for s in range(steps):
        t = 1000 * s
        out += ranged("fuxi.embed", t, 8, 1) + ranged("fuxi.down", t + 10, 8, 1)
        for b in range(blocks):
            tb = t + 100 + 100 * b
            out += ranged("fuxi.block", tb, 60, 2) + ranged("fuxi.block.attention", tb + 20, 30, 5)
        out += ranged("fuxi.up", t + 800, 8, 1) + ranged("fuxi.head", t + 820, 8, 1)
    return out


@pytest.mark.parametrize("steps", [1, 3])
def test_the_span_readers_read_their_ranges_per_step(steps):
    rec = record(cell=CELL, profile=trace.Profile(fuxi_events(steps), steps, 1e-3))
    assert read("swin_ms.forecast", rec) == pytest.approx(0.014)  # 2 x (2 + 5) us
    assert read("cosine_attention_ms.forecast", rec) == pytest.approx(0.010)
    assert read("fuxi_outer_ms.forecast", rec) == pytest.approx(0.004)


@pytest.mark.parametrize("name", NEW)
def test_a_missing_range_reads_none(name):
    assert read(name, record(cell=CELL, profile=None)) is None
    assert read(name, record(cell=CELL, profile=trace.Profile([], 3, 1e-3))) is None
    events = [e for e in fuxi_events(3) if e.get("name") not in ("fuxi.block.attention",
                                                                  "fuxi.block", "fuxi.head")]
    assert read(name, record(cell=CELL, profile=trace.Profile(events, 3, 1e-3))) is None
    pangu_only = [op("pangu.embed", 0, 5, cat="user_annotation")]
    assert read(name, record(cell=CELL, profile=trace.Profile(pangu_only, 1, 1e-3))) is None


def test_the_cell_reports_its_metrics_and_the_shared_ones():
    c = tiny.cell(CELL)
    assert [m["name"] for m in c.end_to_end] == ["forecast_rate", "forecast_step_p95_ms",
                                                 "setup_s"]
    assert [m["name"] for m in c.per_layer] == ["dispatch_ms.forecast", "mfu.forecast",
                                                "idle_pct.forecast", "peak_gib.forecast"] + NEW
    for m in c.per_layer:
        harness.metric_reader(m["name"])
