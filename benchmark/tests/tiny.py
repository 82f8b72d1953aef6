"""A cell of the benchmark cut to a geometry the CPU runs in seconds: its
architecture module's ``TINY``."""

from __future__ import annotations

import copy
import json
import os
import time
from types import SimpleNamespace

import torch

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str, **model) -> harness.Cell:
    """The cell ``name`` at its architecture's tiny geometry (``model``
    overrides more), its forecasts cut to 2 steps so that a short window
    holds the checked steps."""
    c = copy.deepcopy(harness.load_cell(spec(), name, ROOT))
    c.config["model"].update(harness.architecture(c.config).TINY, **model)
    if "lead_steps" in c.traffic:
        c.traffic["lead_steps"] = 2
    return c


def run(c: harness.Cell, seed: int = 7, seconds: float = 0.2, trace: bool = False):
    """One run of ``c`` on the CPU, through the cell's loop."""
    from benchmark import run as bench_run

    torch.manual_seed(0)
    ctx = SimpleNamespace(cell=c, seed=seed, seconds=seconds, trace=trace,
                          device=torch.device("cpu"), peaks=None, t0=time.perf_counter(),
                          counters=bench_run.counters())
    import importlib

    return importlib.import_module(f"benchmark.loops.{c.traffic['loop']}").run(ctx)
