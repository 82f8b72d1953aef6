"""Profiling and system monitoring (port of ``pangu_tpu/utils/profiling.py``;
role of the reference's nvidia-smi/df polling, monitor_system in
models/pangu_sample.py:21-72): the port's named ranges (``span``, and the
loop phases of ``Spans``), a ``torch.profiler`` trace context, the
device-busy split of a trace, CUDA memory counters, and a host/disk
snapshot.

Tracing is on exactly while a ``torch.profiler`` runs (``trace``,
``Trainer(profile_dir=...)``, a benchmark's traced steps): a ``span`` is
then a ``record_function`` range on the profiler's clock, beside the card's
kernels, which its launches link to by correlation id. With no profiler it
is a no-op that costs one attribute read.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import shutil
import time
from typing import ContextManager, Dict, Iterable, Iterator, Optional, Tuple, TypeVar

import torch
from torch.autograd import profiler as _autograd_profiler

#: Kineto event categories of the card's work: kernels, and the copy engines'
#: memcpy and memset
KERNEL_CATEGORIES = ("kernel",)
COPY_CATEGORIES = ("gpu_memcpy", "gpu_memset")

_OFF = contextlib.nullcontext()
T = TypeVar("T")


def span(name: str) -> ContextManager:
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler runs, else a shared no-op context (no ``record_function`` is
    built: building one costs several times the flag read, even with no
    profiler). The port's names
    start with ``pangu.``. A range opened inside a block that
    ``torch.utils.checkpoint`` replays opens again during the replay, on the
    autograd engine's thread."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


class Spans:
    """The phases of a loop, one after another. Each ``with spans(phase):``
    block is a ``pangu.<scope>.<phase>`` range (``span``) on a running
    profiler's trace and ends with ``mark(phase)``. With ``totals`` (a dict),
    ``mark`` adds the wall seconds since the previous mark (or since the
    object was made) to ``totals[phase]``, after a synchronize of ``device``,
    so that a phase holds the work queued in it. Without ``totals``, ``mark``
    neither synchronizes nor reads the clock."""

    def __init__(self, scope: str, totals: Optional[Dict[str, float]] = None,
                 device: Optional[torch.device] = None):
        self.scope, self.totals, self.device = scope, totals, device
        self.t = time.perf_counter() if totals is not None else 0.0

    @contextlib.contextmanager
    def __call__(self, phase: str) -> Iterator[None]:
        with span(f"pangu.{self.scope}.{phase}"):
            yield
        self.mark(phase)

    def mark(self, phase: str) -> None:
        """End ``phase``: with ``totals``, add its wall seconds."""
        if self.totals is None:
            return
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.totals[phase] = self.totals.get(phase, 0.0) + now - self.t
        self.t = now

    def iterate(self, phase: str, items: Iterable[T]) -> Iterator[T]:
        """The items of ``items``, each fetch a ``phase``; the fetch that
        finds the end is a range too, but adds no seconds."""
        it, end = iter(items), object()
        while True:
            with span(f"pangu.{self.scope}.{phase}"):
                item = next(it, end)
            if item is end:
                return
            self.mark(phase)
            yield item


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the enclosed code with ``torch.profiler``: host activity, and
    the card's when there is one; writes a gzipped Chrome trace
    (``*.pt.trace.json.gz``, for Perfetto or TensorBoard) under ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir, use_gzip=True)):
        yield
        if cuda:
            torch.cuda.synchronize()


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def trace_device_busy_split(log_dir: str) -> Optional[Dict[str, float]]:
    """{"modules_ms", "ops_ms", "copy_ms"} of the card's time in the newest
    ``*.trace.json.gz`` under ``log_dir``.

    ``modules_ms`` -- the union of the intervals of every kernel, memcpy and
    memset: the time the card was busy (the role of the JAX trace's "XLA
    Modules" lane). ``ops_ms`` -- the sum of the kernels' durations, which
    counts twice where kernels of two streams overlap. ``copy_ms`` -- the sum
    of the memcpy and memset durations.

    Returns None when there is no trace or the trace holds no device events
    (a CPU run) -- callers treat the fields as optional."""
    paths = glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"), recursive=True)
    if not paths:
        return None
    with gzip.open(max(paths, key=os.path.getmtime), "rt") as f:
        events = json.load(f).get("traceEvents", [])
    spans, ops_us, copy_us = [], 0.0, 0.0
    for e in events:
        cat = str(e.get("cat", "")).lower()
        if e.get("ph") != "X" or cat not in KERNEL_CATEGORIES + COPY_CATEGORIES:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        spans.append((ts, ts + dur))
        if cat in KERNEL_CATEGORIES:
            ops_us += dur
        else:
            copy_us += dur
    if not spans:
        return None
    return {"modules_ms": busy_us(spans) / 1e3, "ops_ms": ops_us / 1e3,
            "copy_ms": copy_us / 1e3}


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per CUDA device, the JAX package's memory counters from PyTorch's
    caching allocator: ``bytes_in_use`` and ``peak_bytes_in_use`` (allocated
    tensor bytes, now and at the peak since the last reset), ``bytes_limit``
    (the card's total memory) and ``largest_alloc_size`` (the largest live
    allocation). ``{}`` without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        blocks = [b["size"] for seg in torch.cuda.memory_snapshot()
                  if seg["device"] == i for b in seg["blocks"] if b["state"] == "active_allocated"]
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.mem_get_info(i)[1]),
            "largest_alloc_size": int(max(blocks, default=0)),
        }
    return out


def system_snapshot(path: str = ".") -> Dict[str, object]:
    """Host-side disk/load snapshot (role of df -h polling): the disk that
    holds ``path`` (default: the working directory; total, used and free to
    this process), the load average and :func:`device_memory_stats`."""
    du = shutil.disk_usage(path)
    return {
        "time": time.strftime("%Y-%m-%d %H:%M:%S"),
        "disk_total_gb": round(du.total / 2**30, 1),
        "disk_used_gb": round(du.used / 2**30, 1),
        "disk_free_gb": round(du.free / 2**30, 1),
        "loadavg": os.getloadavg(),
        "devices": device_memory_stats(),
    }


def monitor_system(interval: float = 5.0, duration: float = 60.0, logger=None) -> None:
    """Poll and print/log system snapshots (reference models/pangu_sample.py:47-72)."""
    end = time.time() + duration
    while time.time() < end:
        snap = system_snapshot()
        msg = (
            f"[{snap['time']}] disk {snap['disk_used_gb']}/{snap['disk_total_gb']}GB "
            f"load {snap['loadavg']} devices {snap['devices']}"
        )
        (logger.info if logger else print)(msg)
        time.sleep(interval)
