"""The comparisons that decide ``correct``: the numbers compared, each later
held to its limit in ``limits/<cell>.json``.

Forecast: a served step's next state against the reference's from the same
input, by the architecture module's ``forecast_gaps``: ``rel_rms`` the RMS
of the difference over the RMS of the reference's, ``max_abs`` the widest
difference.

Training: ``loss_gap`` the widest relative gap of a step's loss over the
first steps; ``grad_norm_gap`` and ``update_norm_gap`` the worst leaf's gap
between the program's and the reference's norms (of the first gradient as
the optimizer took it, and of the parameters' change over the first steps)
over the larger of the reference's norm of that leaf and of the median
leaf. The change leaves out leaves whose first reference gradient is under
a thousandth of the median leaf's: Adam moves them by round-off alone.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import torch

NEGLIGIBLE_GRADIENT = 1e-3


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.detach().double().norm()) for n, t in tensors.items()}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             names: Optional[List[str]] = None) -> float:
    names = list(ref) if names is None else names
    med = statistics.median(ref[n] for n in names)
    gaps = [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names]
    return max(gaps) if all(map(math.isfinite, gaps)) else math.inf


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (a float per step),
    ``grad`` (first-gradient norm per leaf) and ``update`` (norm of each
    leaf's change over the steps)."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    if not all(map(math.isfinite, prog["losses"])):
        loss_gap = math.inf
    med = statistics.median(ref["grad"].values())
    moving = [n for n, g in ref["grad"].items() if g >= NEGLIGIBLE_GRADIENT * med]
    return {"loss_gap": loss_gap, "grad_norm_gap": leaf_gap(prog["grad"], ref["grad"]),
            "update_norm_gap": leaf_gap(prog["update"], ref["update"], moving)}
