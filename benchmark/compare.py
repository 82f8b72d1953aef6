"""The comparisons that decide ``correct``: the numbers compared, each later
held to its limit in ``limits/<cell>.json``.

Forecast: a served step's fields against the reference's from the same
input, in normalized units (a field's deviation over its statistics'
spread): ``rel_rms`` the RMS of the difference over the RMS of the
reference's fields, ``max_abs`` the widest difference.

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

from benchmark.reference.pangu import Constants

NEGLIGIBLE_GRADIENT = 1e-3


@torch.no_grad()
def forecast_gaps(prog_u: torch.Tensor, prog_s: torch.Tensor, ref_u: torch.Tensor,
                  ref_s: torch.Tensor, k: Constants) -> Dict[str, float]:
    """``prog_*`` physical fields of the program, ``ref_*`` the reference's
    normalized fields."""
    du = (prog_u - k.upper_mean) / k.upper_std - ref_u
    ds = (prog_s - k.surface_mean) / k.surface_std - ref_s
    num = du.double().square().sum() + ds.double().square().sum()
    den = ref_u.double().square().sum() + ref_s.double().square().sum()
    return {"rel_rms": math.sqrt(float(num / den)),
            "max_abs": max(float(du.abs().max()), float(ds.abs().max()))}


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
