"""The metric arithmetic on synthetic windows and traces."""

import math
import statistics

import pytest

from benchmark import harness, kernels, trace, work
from benchmark.arch import pangu
from benchmark.tests import tiny

PEAKS = {"bfloat16": 989e12, "float32": 67e12, "bytes_per_s": 3.35e12}


def record(cell="forecast_b1", steps=200, seconds=16.0, step_ms=None, profile=None,
           peak_bytes=3 * 2**30):
    c = tiny.cell(cell)
    w = harness.Window(steps, seconds, step_ms or [80.0] * steps)
    return harness.Record(cell=c, setup_s=30.0, window=w, samples_per_step=1,
                          flops_per_step=8.0e12, window_peak_bytes=peak_bytes, peaks=PEAKS,
                          profile=profile)


def read(name, rec):
    return harness.metric_reader(name)(rec)


def test_rates_and_tail():
    ms = [float(i) for i in range(1, 201)]
    rec = record(steps=200, seconds=16.0, step_ms=ms)
    assert read("forecast_rate", rec) == pytest.approx(12.5)
    assert read("train_rate", rec) == pytest.approx(12.5)
    assert read("forecast_step_p95_ms", rec) == pytest.approx(
        statistics.quantiles(ms, n=100, method="inclusive")[94])
    assert 190 < read("forecast_step_p95_ms", rec) < 191
    assert read("setup_s", rec) == 30.0
    assert read("peak_gib.forecast", rec) == 3.0
    rec.held_bytes = 2**30  # the check's copies are left out
    assert read("peak_gib.forecast", rec) == 2.0


def test_mfu_is_the_whole_windows_flops_over_the_peak():
    rec = record(steps=100, seconds=10.0)
    assert read("mfu.forecast", rec) == pytest.approx(100 * 8.0e12 * 10 / 989e12)
    rec.cell.config["model"]["compute_dtype"] = "float32"
    assert read("mfu.forecast", rec) == pytest.approx(100 * 8.0e12 * 10 / 67e12)
    rec.peaks = None
    assert read("mfu.forecast", rec) is None


def kern(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


def launch(ts, dur, corr, tid=1, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": tid, "args": {"correlation": corr}}


def op(name, ts, dur, cat="cpu_op", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def test_busy_idle_and_the_kernels_split():
    events = [kern("void a_kernel<1>(int)", 0, 100, 1), kern("b", 50, 100, 2),
              kern("c", 300, 100, 3), {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
                                       "ts": 500, "dur": 100}, op("aten::mm", 0, 10)]
    assert trace.busy_us(events) == 350
    prof = trace.Profile(events, 1, 1000e-6)
    rec = record(profile=prof)
    assert read("idle_pct.forecast", rec) == pytest.approx(65.0)
    assert trace.kernel_us(events, ["a_kernel"]) == 100
    assert trace.kernel_us(events, ["a_kernel"], inside=False) == 200
    assert trace.top_device_ops(events, top=2) == [["a_kernel", pytest.approx(1e-4)],
                                                   ["b", pytest.approx(1e-4)]]


def test_idle_gaps_are_named_by_the_op_that_launched_the_next_kernel():
    events = [op(trace.STEP_SPAN, 0, 1000, cat="user_annotation"), op("aten::roll", 100, 50),
              launch(110, 5, 2), kern("k1", 10, 40, 1), kern("k2", 250, 10, 2),
              kern("k3", 260, 10, 3)]
    assert trace.idle_gaps(events) == [["aten::roll", pytest.approx(200e-6)]]


def test_optimizer_span_and_dispatch():
    events = [op(trace.STEP_SPAN, 0, 1000, cat="user_annotation"),
              op("Optimizer.step#Adam.step", 600, 300, cat="user_annotation"),
              launch(100, 5, 1), launch(200, 5, 2), launch(300, 505, 3), launch(700, 5, 4),
              kern("x", 150, 30, 1), kern("multi_tensor_apply_kernel", 900, 40, 4),
              kern("y", 950, 10, 3)]
    assert trace.under_span_us(events, "Optimizer.step") == 40
    assert trace.under_span_us(events, "nothing") is None
    rec = record(cell="finetune_b1", profile=trace.Profile(events, 2, 1e-3))
    assert read("optimizer_ms.train", rec) == pytest.approx(0.02)
    assert read("dispatch_ms.forecast", rec) is None
    rec.dispatch_ms = [9.0, 30.0, 8.0, 10.0]
    assert read("dispatch_ms.forecast", rec) == pytest.approx(9.5)


def test_dispatch_times_each_call_and_not_the_card():
    import torch

    calls = []
    out = harness.dispatch_ms(calls.append, 5, 3, torch.device("cpu"))
    assert calls == [5, 6, 7] and len(out) == 3 and all(ms >= 0 for ms in out)


def test_a_roofline_reads_100_at_exactly_the_bound():
    rec = record(profile=trace.Profile([], 2, 1.0, {"K1": 32}))
    bound = sum(work.bound_s(kernels.load("K1").work(st, c, h, sh, 1), PEAKS)
                for st, c, h, sh in pangu.blocks(rec.cell.config))
    half = bound * 1e6  # us per step, as two kernels of one step each
    rec.profile.events = [kern("window_attention_kernel", 0, half, 1),
                          kern("mlp_tail_kernel", 0, half, 2), kern("roll_cuda_kernel", 0, 5, 3)]
    assert read("K1_roofline", rec) == pytest.approx(100.0)
    assert read("plain_ops_ms.forecast", rec) == pytest.approx(5e-3 / 2)
    rec.profile.launches = {"K1": 0}
    assert read("K1_roofline", rec) is None


def test_kernel_work_counts_no_recompute():
    """A backward counts twice its forward's products."""
    st, c, h, sh = pangu.blocks(tiny.cell("finetune_b1").config)[1]
    mm = {n: kernels.load(n).work(st, c, h, sh, 1)[0] for n in ("K2", "K3", "K6", "K7")}
    assert mm["K3"] == 2 * mm["K2"] and mm["K7"] == 2 * mm["K6"]
    assert kernels.load("K1").work(st, c, h, sh, 1)[0] == mm["K2"] + mm["K6"]


def test_flops_are_the_programs_count():
    from pangu_tpu_torch import pangu_pretrain
    from pangu_tpu_torch.utils.flops import forward_matmul_flops, train_matmul_flops

    cfg = pangu_pretrain(24).model
    flagship = harness.load_cell(tiny.spec(), "forecast_b1", tiny.ROOT).config
    assert pangu.forward_matmul_flops(flagship, 2) == forward_matmul_flops(cfg, 2)["total"]
    assert pangu.train_matmul_flops(flagship) == train_matmul_flops(cfg)
    assert math.isclose(pangu.forward_matmul_flops(flagship) / 1e12, 8.659, rel_tol=1e-3)


def test_unknown_card_has_no_peaks():
    assert work.peaks("NVIDIA H100 80GB HBM3")["bfloat16"] == 989e12
    with pytest.raises(KeyError):
        work.peaks("cpu")
