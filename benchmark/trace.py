"""The traced stretch of a run and the arithmetic on its trace.

A traced run profiles a few steps right after its measured window closes,
with ``torch.profiler`` (host and card), each step under a
``record_function`` span named ``STEP_SPAN``. The trace is exported as a
Chrome trace into the run's ``TMPDIR``, read back as a list of events and
deleted. The functions below take such a list, so the tests can hand them
synthetic traces.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

STEP_SPAN = "bench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
#: Kineto categories of the host's CUDA API calls (runtime and lower level)
#: start so; ``cuda_sync`` marks the card's waits instead
LAUNCH_PREFIX = "cuda_"
#: host ops searched back from a launch for the op that holds it
_SCAN = 2000


@dataclass
class Profile:
    """The traced stretch: its events, steps, wall seconds (host clock, from a
    synchronize before the first step to one after the last) and the
    program's launch counters' increase over it."""

    events: List[dict]
    steps: int
    wall_s: float
    launches: Dict[str, int] = field(default_factory=dict)


def read_counter(counter: Tuple[str, str]) -> int:
    import importlib

    module, attr = counter
    return int(getattr(importlib.import_module(module), attr))


def profile_steps(step: Callable[[int], object], first: int, count: int, sync: Callable[[], None],
                  counters: Dict[str, Tuple[str, str]]) -> Profile:
    """Run ``step(first) .. step(first + count - 1)`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    before = {k: read_counter(c) for k, c in counters.items()}
    with profile(activities=activities) as prof:
        sync()
        t0 = time.perf_counter()
        for i in range(first, first + count):
            with record_function(STEP_SPAN):
                step(i)
        sync()
        wall = time.perf_counter() - t0
    launches = {k: read_counter(c) - before[k] for k, c in counters.items()}
    fd, path = tempfile.mkstemp(suffix=".trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return Profile(events, count, wall, launches)


def _complete(events: Iterable[dict], cats: Sequence[str]) -> List[dict]:
    return [e for e in events
            if e.get("ph") == "X" and str(e.get("cat", "")).lower() in cats and "dur" in e]


def _launches(events: Iterable[dict]) -> List[dict]:
    out = []
    for e in events:
        cat = str(e.get("cat", "")).lower()
        if (e.get("ph") == "X" and "dur" in e and cat.startswith(LAUNCH_PREFIX)
                and cat != "cuda_sync"):
            out.append(e)
    return out


def device_events(events: Iterable[dict]) -> List[dict]:
    return _complete(events, DEVICE_CATS)


def kernels(events: Iterable[dict]) -> List[dict]:
    return _complete(events, ("kernel",))


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def busy_us(events: Iterable[dict]) -> float:
    """The time the card was busy: the union of its kernels, copies and sets."""
    return union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in device_events(events))


def matches(name: str, patterns: Sequence[str]) -> bool:
    return any(re.search(p, name) for p in patterns)


def kernel_us(events: Iterable[dict], patterns: Sequence[str], inside: bool = True) -> float:
    """Summed duration of the kernels whose names match one of ``patterns``
    (``inside=False``: of the kernels that match none)."""
    return sum(float(e["dur"]) for e in kernels(events)
               if matches(str(e.get("name", "")), patterns) == inside)


def _correlation(e: dict) -> Optional[int]:
    c = (e.get("args") or {}).get("correlation")
    return None if c is None else int(c)


def under_span_us(events: Sequence[dict], prefix: str) -> Optional[float]:
    """Device time of the kernels launched inside the host spans whose names
    start with ``prefix`` (launches linked to kernels by correlation id);
    None when no such span is in the trace."""
    spans = [e for e in _complete(events, HOST_CATS) if str(e.get("name", "")).startswith(prefix)]
    if not spans:
        return None
    inside = set()
    for r in _launches(events):
        t, c = float(r["ts"]), _correlation(r)
        if c is not None and any(s.get("tid") == r.get("tid")
                                 and float(s["ts"]) <= t <= float(s["ts"]) + float(s["dur"])
                                 for s in spans):
            inside.add(c)
    return sum(float(k["dur"]) for k in kernels(events) if _correlation(k) in inside)


def short_name(name: str, limit: int = 64) -> str:
    """A kernel or op name without its return type, template and arguments."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name.strip())
    name = re.split(r"[<(]", name, maxsplit=1)[0] or name
    return name[:limit]


def top_device_ops(events: Sequence[dict], top: int = 10) -> List[List]:
    """[name, seconds] of the device operations that took most time."""
    by_name = defaultdict(float)
    for e in device_events(events):
        by_name[short_name(str(e.get("name", "")))] += float(e["dur"]) * 1e-6
    return [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(events: Sequence[dict], top: int = 10) -> List[List]:
    """[what the host was doing, seconds] of the card's idle gaps between
    its operations, summed by the innermost host op that launched the
    operation ending the gap, largest first."""
    dev = sorted(device_events(events), key=lambda e: float(e["ts"]))
    host = sorted(_complete(events, HOST_CATS), key=lambda e: float(e["ts"]))
    starts = [float(h["ts"]) for h in host]
    launch_at = {_correlation(r): r for r in _launches(events)}
    by_label = defaultdict(float)
    end = None
    for e in dev:
        ts = float(e["ts"])
        if end is not None and ts > end:
            r = launch_at.get(_correlation(e))
            label = "unlinked"
            if r is not None:
                # ranges on one thread nest, so the latest-starting one that
                # holds the launch is the innermost
                t, i, label = float(r["ts"]), bisect.bisect_right(starts, float(r["ts"])), None
                for h in reversed(host[max(0, i - _SCAN):i]):
                    if h.get("tid") == r.get("tid") and t <= float(h["ts"]) + float(h["dur"]):
                        label = short_name(str(h["name"]))
                        break
                label = label or "outside any op"
            by_label[label] += (ts - end) * 1e-6
        end = max(end if end is not None else ts, ts + float(e["dur"]))
    return [[n, s] for n, s in sorted(by_label.items(), key=lambda kv: -kv[1])[:top]]
