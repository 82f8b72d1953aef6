"""What every cell shares: finding a cell's files by the names in
``BENCHMARK.json`` and its architecture module by the name in its
configuration file, the measured window, the record the metric readers
read, and the comparison's verdict.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    and limits read from their files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(spec: dict, name: str, root: str = ".") -> Cell:
    """The cell ``name`` of the benchmark ``spec``: its configuration file
    (the configuration's ``file``), ``traffic/<traffic>.json`` and
    ``limits/<cell>.json``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; there are {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(name=name, chips=int(w["chips"]),
                config=_read(os.path.join(root, cfg["file"])),
                traffic=_read(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
                limits=_read(os.path.join(HERE, "limits", f"{name}.json")),
                end_to_end=[m for m in spec["end_to_end"] if _reported(m, name)],
                per_layer=[m for m in spec["per_layer"] if _reported(m, name)])


def architecture(config: dict, parts: Sequence[str] = ()):
    """The module ``arch/<name>.py`` of the configuration's ``architecture``
    ("pangu" where the file names none), holding the contract's forecast
    part (``arch.FORECAST``) and ``parts`` (``arch.TRAINING`` for a train
    cell)."""
    from benchmark import arch

    name = config.get("architecture", "pangu")
    path = os.path.join(HERE, "arch", f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no architecture {name!r} under {HERE}/arch")
    mod = importlib.import_module(f"benchmark.arch.{name}")
    missing = [f for f in arch.FORECAST + tuple(parts) if not hasattr(mod, f)]
    if missing:
        raise AttributeError(f"architecture {name!r} ({path}) has no {', '.join(missing)} "
                             "of the contract in benchmark/arch/__init__.py")
    return mod


def set_precision(config: dict) -> None:
    """TF32 as the configuration states it, for the program and the
    reference alike."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = bool(config["allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["allow_tf32"])


# ---- the window ----------------------------------------------------------------------


class Timeline:
    """Marks on the card's stream (CUDA events, read after the window), or on
    the host's clock where the device is the CPU, which runs in order."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        self.torch = torch
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


@dataclass
class Window:
    """The measured window: steps enqueued and completed, its seconds on the
    host's clock from a synchronize before the first step to one after the
    last, and each step's latency (end of the step before to its own end, on
    the card's stream)."""

    steps: int
    seconds: float
    step_ms: List[float]


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device, reset: bool = False) -> int:
    """The most memory the process's tensors held on ``device`` since the
    last reset (0 on the CPU); ``reset`` starts a new count after reading."""
    import torch

    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return peak


def release(device) -> None:
    """Hand the cached blocks of freed tensors back to the card."""
    import torch

    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_window(step: Callable[[int], object], seconds: float, device) -> Window:
    """Call ``step(0), step(1), ...`` until ``seconds`` have passed on the
    host's clock, with no synchronize between steps; the window ends when
    the card has finished the last."""
    tl = Timeline(device)
    sync(device)
    t0 = time.perf_counter()
    tl.mark()
    i = 0
    while True:
        step(i)
        tl.mark()
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    t1 = time.perf_counter()
    return Window(i, t1 - t0, tl.intervals_ms())


def dispatch_ms(step: Callable[[int], object], first: int, count: int, device) -> List[float]:
    """The host's ms to enqueue each of ``step(first) .. step(first + count - 1)``
    (its call on the host's clock), each started on an idle card. In the
    window the host runs ahead of the card until the launch queue is full
    and then waits in a launch for the card, so a call there reads the
    card's pace and not the host's work."""
    out = []
    for i in range(first, first + count):
        sync(device)
        t0 = time.perf_counter()
        step(i)
        out.append((time.perf_counter() - t0) * 1e3)
    sync(device)
    return out


# ---- the record and the metrics ------------------------------------------------------


@dataclass
class Record:
    """What a run hands the metric readers."""

    cell: Cell
    setup_s: float
    window: Window
    samples_per_step: int
    flops_per_step: float
    window_peak_bytes: int
    setup_peak_bytes: int = 0
    #: bytes of the benchmark's own buffers held through the window (the
    #: check's copies), which no deployment holds
    held_bytes: int = 0
    peaks: Optional[Dict[str, float]] = None
    profile: Optional[object] = None
    dispatch_ms: Optional[List[float]] = None
    checks: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    compared: int = 0
    failed: int = 0

    @property
    def model(self) -> dict:
        return self.cell.config["model"]

    @property
    def batch(self) -> int:
        return int(self.cell.traffic["batch"])

    @property
    def correct(self) -> bool:
        return self.compared > 0 and all(math.isfinite(v) and v <= lim
                                         for v, lim in self.checks.values())


def judge(rec: Record, readings: List[Dict[str, float]]) -> None:
    """Hold the worst of each number compared over the answers compared to
    the cell's limit of that number."""
    limits = rec.cell.limits
    worst: Dict[str, float] = {}
    for r in readings:
        for n in limits:
            v = r.get(n, math.inf)
            worst[n] = max(worst.get(n, -math.inf), v if math.isfinite(v) else math.inf)
    rec.compared = len(readings)
    rec.checks = {n: (worst.get(n, math.inf), float(lim)) for n, lim in limits.items()}
    rec.failed = sum(1 for r in readings
                     if any(not r.get(n, math.inf) <= lim for n, lim in limits.items()))


def metric_reader(name: str) -> Callable:
    """``read(record)`` of ``metrics/<name>.py``, else of the file named by
    the part of ``name`` before its first dot (``mfu.train`` -> ``mfu.py``)."""
    for base in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{base}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{base}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {HERE}/metrics")


def read_metrics(rec: Record, metrics: List[dict], required: bool) -> Dict[str, dict]:
    """Each metric's value by its reader; a reader that finds nothing returns
    None and the metric is left out, which is an error where ``required``."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"])(rec)
        if value is None:
            if required:
                raise RuntimeError(f"metric {m['name']} read nothing in {rec.cell.name}")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
