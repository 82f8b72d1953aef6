"""The port's profiling tools on the CPU: the phase cuts of the kernels this
tree launches each apply once, a tree without such a kernel is refused, the
library swap of the cut builds restores the loader, and ``kernel_ms``
and ``named_kernels_ms`` refuse a profile whose kernel events the calls do
not divide (a named error, not an empty list the caller would index, nor a
mean over a lost launch). ``utils.profiling`` (the port of
``pangu_tpu/utils/profiling.py``): the device-busy split of a synthetic
Kineto trace, exact; None for a CPU-only trace and for no trace; a real
``trace`` on the CPU; the memory counters without a card; the host
snapshot and the monitor, as tests/test_utils.py holds the JAX ones.

Imports torch only; the cut builds and the timings themselves need the card
(``profile_bwd_split --cuts``)."""

import contextlib
import ctypes.util
import gzip
import json
import logging
import os
from types import SimpleNamespace
from unittest import mock

import pytest
import torch
from torch.profiler import DeviceType

from pangu_tpu_torch.ops import _build
from pangu_tpu_torch.scripts import profile_attn_ab
from pangu_tpu_torch.scripts import profile_bwd_split as pbs
from pangu_tpu_torch.scripts import profile_train_step
from pangu_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_every_phase_cut_entry_finds_its_kernel_in_this_tree():
    """No entry of PHASE_CUTS points at code the tree no longer has: each
    one's ``find`` text is in its source, and each is a kernel's."""
    for kernel, spec in pbs.PHASE_CUTS.items():
        path, text = spec["find"]
        with open(os.path.join(REPO, "pangu_tpu_torch", "csrc", path)) as f:
            assert text in f.read(), kernel
    assert set(pbs.cut_kernels(REPO)) == set(pbs.PHASE_CUTS)


def test_phase_cuts_of_this_tree_apply_once_each():
    found = pbs.cut_kernels(REPO)
    assert set(found) == {"attention_bwd_regs_kernel", "window_attention_kernel (mma.sync)",
                          "mlp_tail_kernel (K12 row pass)", "local_accum_kernel"}
    for kernel, spec in found.items():
        with open(os.path.join(REPO, "pangu_tpu_torch", "csrc", spec["header"])) as f:
            text = f.read()
        for k, (phase, edits) in enumerate(spec["phases"].items(), start=1):
            for old, new in edits:
                assert text.count(old) == 1, (kernel, phase)
                assert f"CUT_{k}" in new, (kernel, phase)


def test_cut_kernels_refuses_a_tree_without_them(tmp_path):
    csrc = tmp_path / "pangu_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    for name in ("block_attention.cu", "window_attention.cuh"):
        (csrc / name).write_text("// no kernel\n")
    with pytest.raises(ValueError):
        pbs.cut_kernels(str(tmp_path))
    with pytest.raises(ValueError):
        pbs.cut_kernels(REPO, only="no such kernel")


def test_with_library_swaps_one_source_and_restores_the_loader():
    libc = ctypes.util.find_library("c")
    load = _build.load_library
    with pbs.with_library("a.cu", libc), pbs.with_library("b.cu", libc):
        assert _build.load_library("a.cu")._name == libc
        assert _build.load_library("b.cu")._name == libc
    assert _build.load_library is load


def _fake_profile(n_events: int):
    """A stand-in for torch.profiler.profile that records ``n_events``
    kernel events of 2 µs each, named k0, k1, ... in launch order."""
    events = [SimpleNamespace(device_type=DeviceType.CUDA, name=f"k{i % 2}",
                              time_range=SimpleNamespace(start=i, elapsed_us=lambda: 2.0))
              for i in range(n_events)]

    @contextlib.contextmanager
    def profile(**_):
        yield SimpleNamespace(events=lambda: events)
    return profile


@pytest.mark.parametrize("n_events", [0, 5])
def test_kernel_ms_raises_when_the_calls_do_not_divide_the_kernel_events(n_events):
    with mock.patch.object(pbs, "profile", _fake_profile(n_events)), \
            mock.patch.object(torch.cuda, "synchronize", lambda *a, **k: None):
        with pytest.raises(pbs.NoKernelEvents):
            pbs.kernel_ms(lambda: None, n=3)


@pytest.mark.parametrize("n_events", [0, 4])
def test_named_kernels_ms_raises_when_the_calls_do_not_divide_its_launches(n_events):
    # k0 and k1 alternate: 4 events hold two k0 launches, not one per call
    with mock.patch.object(pbs, "profile", _fake_profile(n_events)), \
            mock.patch.object(torch.cuda, "synchronize", lambda *a, **k: None):
        with pytest.raises(pbs.NoKernelEvents):
            pbs.named_kernels_ms(lambda: None, "k0", n=3)


def test_named_kernels_ms_sums_the_named_launches_of_a_call():
    with mock.patch.object(pbs, "profile", _fake_profile(6)), \
            mock.patch.object(torch.cuda, "synchronize", lambda *a, **k: None):
        assert pbs.named_kernels_ms(lambda: None, "k1", n=3) == 0.002


def test_kernel_ms_averages_each_launch_over_the_calls():
    with mock.patch.object(pbs, "profile", _fake_profile(6)), \
            mock.patch.object(torch.cuda, "synchronize", lambda *a, **k: None):
        assert pbs.kernel_ms(lambda: None, n=3) == [("k0", 0.002), ("k1", 0.002)]


def test_profile_attn_ab_sums_the_kernels_of_a_call_beside_the_wrapper_ms():
    with mock.patch.object(pbs, "profile", _fake_profile(10)), \
            mock.patch.object(torch.cuda, "synchronize", lambda *a, **k: None), \
            mock.patch.object(profile_attn_ab, "cuda_times_ms", lambda fn: 0.5):
        got = profile_attn_ab.timed(lambda: None)
    assert got["kernels"] == [("k0", 0.002), ("k1", 0.002)]  # 5 calls of 2 launches
    assert got["device_ms"] == pytest.approx(0.004) and got["wrapper_ms"] == 0.5


def test_profile_attn_ab_times_each_mxu_variant_per_call_and_per_sweep():
    """The S3 part times each variant's call of ``SWEEPS`` sweeps (here on
    the CPU, where the wrapper runs the plain version, through a stand-in
    timer that runs the call once) and divides by the sweeps."""
    from pangu_tpu_torch.scripts import bench_mxu_micro as micro

    shapes = []

    def timer(fn):
        shapes.append(tuple(fn().shape))
        return {"kernels": [("k", 2.56)], "device_ms": 2.56, "wrapper_ms": 5.12}

    before = dict(micro.LAUNCHES)
    got = profile_attn_ab.mxu_part(torch.device("cpu"), timer=timer)
    assert list(got) == list(micro.VARIANTS) and shapes == [(144, 144)] * 4
    assert micro.LAUNCHES == before  # CPU tensors: the plain version, no launch
    for r in got.values():
        assert r["sweeps"] == micro.SWEEPS == 256
        assert r["device_ms_per_sweep"] == pytest.approx(0.01)
        assert r["wrapper_ms_per_sweep"] == pytest.approx(0.02)


def test_profile_attn_ab_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        profile_attn_ab.main([])
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        profile_attn_ab.main([".", "--parts", "mxu"])


def _write_trace(path, events):
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_trace_device_busy_split_of_a_kineto_trace(tmp_path):
    """Two kernels on two streams that overlap by 50 us, a memcpy and a
    memset on the card; a GPU annotation spanning them, host ops and runtime
    calls, which must not count. Busy is the union (150 + 30 + 10 us), ops
    the kernels' sum (200 us), copy the memcpy and memset (40 us)."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "k0", "pid": 0, "tid": 7, "ts": 1000.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "pid": 0, "tid": 8, "ts": 1050.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "pid": 0, "tid": 7,
         "ts": 1200.0, "dur": 30.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "pid": 0, "tid": 7, "ts": 1240.0,
         "dur": 10.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "step", "pid": 0, "tid": 9,
         "ts": 900.0, "dur": 500.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 0.0,
         "dur": 5000.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
         "ts": 990.0, "dur": 5.0},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
    ]
    _write_trace(tmp_path / "host.123.pt.trace.json.gz", events)
    split = profiling.trace_device_busy_split(str(tmp_path))
    assert split == {"modules_ms": 0.19, "ops_ms": 0.2, "copy_ms": 0.04}


def test_trace_device_busy_split_reads_the_newest_trace(tmp_path):
    old = [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 0.0, "dur": 400.0}]
    new = [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 0.0, "dur": 100.0}]
    _write_trace(tmp_path / "a" / "w.1.pt.trace.json.gz", old)
    _write_trace(tmp_path / "b" / "w.2.pt.trace.json.gz", new)
    os.utime(tmp_path / "a" / "w.1.pt.trace.json.gz", (1, 1))
    assert profiling.trace_device_busy_split(str(tmp_path))["ops_ms"] == 0.1


def test_trace_device_busy_split_is_none_without_device_events(tmp_path):
    _write_trace(tmp_path / "w.1.pt.trace.json.gz", [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 0.0,
         "dur": 50.0}])
    assert profiling.trace_device_busy_split(str(tmp_path)) is None
    assert profiling.trace_device_busy_split(str(tmp_path / "empty")) is None


def test_trace_writes_a_gzipped_chrome_trace(tmp_path):
    """On the CPU: a trace with the host's ops and no device events."""
    if torch.cuda.is_available():
        pytest.skip("the CPU-only trace; the card's is read by chip_smoke.py phase 18")
    with profiling.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    paths = list(tmp_path.glob("**/*.trace.json.gz"))
    assert len(paths) == 1
    with gzip.open(paths[0], "rt") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert profiling.trace_device_busy_split(str(tmp_path)) is None


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0), ([(0, 10)], 10.0), ([(0, 10), (5, 20)], 20.0), ([(5, 20), (0, 10)], 20.0),
    ([(0, 10), (2, 3), (20, 25)], 15.0), ([(0, 10), (10, 12)], 12.0)])
def test_busy_us_is_the_union_of_the_intervals(intervals, want):
    assert profiling.busy_us(intervals) == want


def test_profile_train_step_takes_the_union_from_the_profiling_tools():
    assert profile_train_step.busy_us is profiling.busy_us


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("the CPU-only result")
    assert profiling.device_memory_stats() == {}


def test_system_snapshot_and_monitor(caplog):
    snap = profiling.system_snapshot()
    assert snap["disk_total_gb"] > 0
    assert 0 <= snap["disk_free_gb"] <= snap["disk_total_gb"] - snap["disk_used_gb"] + 0.1
    assert len(snap["loadavg"]) == 3
    assert isinstance(snap["devices"], dict)
    logger = logging.getLogger("test-torch-profiling-monitor")
    with caplog.at_level(logging.INFO, logger="test-torch-profiling-monitor"):
        profiling.monitor_system(interval=0.01, duration=0.02, logger=logger)
    assert any("disk" in r.message for r in caplog.records)
