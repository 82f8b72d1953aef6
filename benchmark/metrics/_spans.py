"""Device time of the work launched inside the program's named ranges
(``pangu.*``: ``span`` and ``Spans`` of ``pangu_tpu_torch.utils.profiling``,
``record_function`` ranges while a profiler runs): the card's kernels,
copies and sets whose launch (the host's CUDA API call, linked to them by
correlation id) lies inside such a range.

A range holds the launches of its own thread, or with ``any_thread`` every
launch inside its interval: the backward's kernels are launched by the
autograd engine's thread while the thread that called ``backward()`` waits
inside its range."""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark import trace


def ranges(events: Sequence[dict], names: Sequence[str]) -> List[dict]:
    """The host ranges named one of ``names``."""
    return [e for e in events
            if e.get("ph") == "X" and "dur" in e and e.get("name") in names
            and str(e.get("cat", "")).lower() in trace.HOST_CATS]


def _end(e: dict) -> float:
    return float(e["ts"]) + float(e["dur"])


def _union(rs: Sequence[dict]) -> Tuple[List[float], List[float]]:
    """The union of the ranges' intervals as sorted starts and their ends."""
    starts: List[float] = []
    ends: List[float] = []
    for r in sorted(rs, key=lambda e: float(e["ts"])):
        if ends and float(r["ts"]) <= ends[-1]:
            ends[-1] = max(ends[-1], _end(r))
        else:
            starts.append(float(r["ts"]))
            ends.append(_end(r))
    return starts, ends


def _holds(union: Tuple[List[float], List[float]], t: float) -> bool:
    starts, ends = union
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


def inside(rs: Sequence[dict], outer: Sequence[dict]) -> List[dict]:
    """The ranges of ``rs`` that lie wholly inside one of ``outer``, on any
    thread."""
    starts, ends = _union(outer)
    out = []
    for r in rs:
        i = bisect.bisect_right(starts, float(r["ts"])) - 1
        if i >= 0 and _end(r) <= ends[i]:
            out.append(r)
    return out


def launched_us(events: Sequence[dict], rs: Sequence[dict], any_thread: bool = False) -> float:
    """Summed device time of the kernels, copies and sets launched inside
    ``rs``."""
    by_thread: Dict[object, List[dict]] = defaultdict(list)
    for r in rs:
        by_thread[None if any_thread else r.get("tid")].append(r)
    unions = {tid: _union(group) for tid, group in by_thread.items()}
    held = set()
    for launch in trace._launches(events):
        union = unions.get(None if any_thread else launch.get("tid"))
        c = trace._correlation(launch)
        if union is not None and c is not None and _holds(union, float(launch["ts"])):
            held.add(c)
    return sum(float(e["dur"]) for e in trace.device_events(events)
               if trace._correlation(e) in held)


def ms_per_step(rec, rs: Sequence[dict], names: Sequence[str],
                any_thread: bool = False) -> Optional[float]:
    """Device ms per traced step launched inside ``rs``; None when a name of
    ``names`` has no range among them, or a count that is not a whole
    multiple of the traced steps."""
    prof = rec.profile
    if prof is None:
        return None
    counts = Counter(r.get("name") for r in rs)
    if any(counts[n] == 0 or counts[n] % prof.steps for n in names):
        return None
    return launched_us(prof.events, rs, any_thread) * 1e-3 / prof.steps


def read_ranges(rec, names: Sequence[str], any_thread: bool = False) -> Optional[float]:
    """Device ms per traced step launched inside the ranges named ``names``."""
    if rec.profile is None:
        return None
    return ms_per_step(rec, ranges(rec.profile.events, names), names, any_thread)
