"""Autoregressive forecasting (port of
``pangu_tpu/rollout/autoregressive.py``).

The forecast step maps physical fields at t to physical fields at
t + horizon: the model forward, then ``norm_back_data``. Every rollout, eval
and serving path is built on it.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from pangu_tpu_torch.aux import AuxConstants, norm_back_data
from pangu_tpu_torch.model.pangu import check_kernel_widths

Fields = Tuple[torch.Tensor, torch.Tensor]


def make_forecast_step(model: nn.Module, aux: AuxConstants) -> Callable[[torch.Tensor, torch.Tensor], Fields]:
    """``step(upper, surface) -> (upper', surface')``, physical units,
    under ``torch.inference_mode`` with the model in eval mode (the JAX
    package's ``deterministic=True``). On the card it first checks that the
    kernels take the model's widths (``check_kernel_widths``)."""
    if next(model.parameters()).is_cuda:
        check_kernel_widths(model.cfg)

    @torch.inference_mode()
    def step(upper: torch.Tensor, surface: torch.Tensor) -> Fields:
        model.eval()
        ou, os_ = model(upper, surface, aux)
        return norm_back_data(ou, os_, aux)

    return step


def rollout(model: nn.Module, upper: torch.Tensor, surface: torch.Tensor,
            aux: AuxConstants, steps: int, keep_trajectory: bool = True) -> Fields:
    """``steps`` autoregressive steps. Returns the stacked (steps, ...)
    trajectories when ``keep_trajectory``, else the final fields (as
    ``pangu_tpu.rollout.autoregressive.rollout_scan``)."""
    step = make_forecast_step(model, aux)
    traj_u, traj_s = [], []
    for _ in range(steps):
        upper, surface = step(upper, surface)
        if keep_trajectory:
            traj_u.append(upper)
            traj_s.append(surface)
    if keep_trajectory:
        return torch.stack(traj_u), torch.stack(traj_s)
    return upper, surface
