"""Matplotlib field visualizations (reference era5_data/utils.py:61-126:
``visuailze``/``visuailze_surface`` triptychs of input / prediction / ground
truth / bias for one variable).

The port's own copy of ``pangu_tpu/eval/visualize.py`` (the port imports nothing of the
JAX package); tests/test_torch_port_modules.py holds it to the original.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from pangu_tpu_torch.config import ERA5_SURFACE_VARIABLES, ERA5_UPPER_VARIABLES


def _plot_panels(fields, titles, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(fields)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 3))
    if n == 1:
        axes = [axes]
    for ax, f, t in zip(axes, fields, titles):
        im = ax.imshow(f, cmap="RdBu_r")
        ax.set_title(t)
        ax.axis("off")
        fig.colorbar(im, ax=ax, fraction=0.04)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def plot_upper(
    output: np.ndarray,  # (Vu, L, lat, lon)
    target: np.ndarray,
    input_: Optional[np.ndarray],
    var: str,
    level: int,
    step,
    path: str,
    var_names: Sequence[str] = ERA5_UPPER_VARIABLES,
) -> str:
    os.makedirs(path, exist_ok=True)
    vi = list(var_names).index(var)
    fields = [output[vi, level], target[vi, level], output[vi, level] - target[vi, level]]
    titles = [f"{var} output", f"{var} target", "bias"]
    if input_ is not None:
        fields.insert(0, input_[vi, level])
        titles.insert(0, f"{var} input")
    out = os.path.join(path, f"{var}_{level}_{step}.png")
    _plot_panels(fields, titles, out)
    return out


def plot_surface(
    output: np.ndarray,  # (Vs, lat, lon)
    target: np.ndarray,
    input_: Optional[np.ndarray],
    var: str,
    step,
    path: str,
    var_names: Sequence[str] = ERA5_SURFACE_VARIABLES,
) -> str:
    os.makedirs(path, exist_ok=True)
    vi = list(var_names).index(var)
    fields = [output[vi], target[vi], output[vi] - target[vi]]
    titles = [f"{var} output", f"{var} target", "bias"]
    if input_ is not None:
        fields.insert(0, input_[vi])
        titles.insert(0, f"{var} input")
    out = os.path.join(path, f"{var}_{step}.png")
    _plot_panels(fields, titles, out)
    return out
