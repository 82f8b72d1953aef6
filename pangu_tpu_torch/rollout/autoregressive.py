"""Autoregressive forecasting (port of
``pangu_tpu/rollout/autoregressive.py``).

The forecast step maps physical fields at t to physical fields at
t + horizon: the model forward, then ``norm_back_data``. Every rollout, eval
and serving path is built on it. A model of two input states (FuXi,
``model.fuxi``) steps ``(x_{t-1}, x_t) -> (x_t, x_{t+1})`` instead, and one
of two states and a clock (Aurora, ``model.aurora``) ``(u_{t-1}, s_{t-1},
u_t, s_t, hours) -> (u_t, s_t, u_{t+1}, s_{t+1}, hours + lead)``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from pangu_tpu_torch.aux import AuxConstants, norm_back_data
from pangu_tpu_torch.model.pangu import check_kernel_widths
from pangu_tpu_torch.utils.profiling import span

Fields = Tuple[torch.Tensor, torch.Tensor]


def make_forecast_step(model: nn.Module, aux: AuxConstants) -> Callable[[torch.Tensor, torch.Tensor], Fields]:
    """``step(upper, surface) -> (upper', surface')``, physical units,
    under ``torch.inference_mode`` with the model in eval mode (the JAX
    package's ``deterministic=True``). On the card it first checks that the
    kernels take the model's widths (``check_kernel_widths``). Under a
    running profiler ``norm_back_data`` is a ``pangu.norm_back`` range.

    A model that takes two states (``model.input_states == 2``: FuXi, with
    ``aux`` its ``FuxiConstants``) gives :func:`_two_state_step` instead, and
    one that also keeps a clock (``model.lead_hours``: Aurora, with ``aux``
    its ``AuroraConstants``) :func:`_clocked_step`."""
    if getattr(model, "input_states", 1) == 2:
        if hasattr(model, "lead_hours"):
            return _clocked_step(model, aux)
        return _two_state_step(model, aux)
    if next(model.parameters()).is_cuda:
        check_kernel_widths(model.cfg)

    @torch.inference_mode()
    def step(upper: torch.Tensor, surface: torch.Tensor) -> Fields:
        model.eval()
        ou, os_ = model(upper, surface, aux)
        with span("pangu.norm_back"):
            return norm_back_data(ou, os_, aux)

    return step


def _two_state_step(model: nn.Module, aux) -> Callable[[torch.Tensor, torch.Tensor], Fields]:
    """``step(x_prev, x_cur) -> (x_cur, x_next)``, physical f32 states, under
    ``torch.inference_mode``; ``x_cur`` comes back as the same tensor. The
    model's weights are cast to its compute dtype here, once and in place
    (``freeze``), so the model serves forecasts only after this. Its blocks
    run the cosine window attention kernel on the card, whose wrapper checks
    its own widths before any launch; nothing is checked here."""
    model.eval()
    model.freeze()

    @torch.inference_mode()
    def step(x_prev: torch.Tensor, x_cur: torch.Tensor) -> Fields:
        return x_cur, model(x_prev, x_cur, aux)

    return step


def _clocked_step(model: nn.Module, aux) -> Callable[..., Tuple[torch.Tensor, ...]]:
    """``step(u_prev, s_prev, u, s, hours) -> (u, s, u', s', hours + lead)``:
    physical f32 upper and surface states at t - lead and t, and the clock at
    t (hours since 1970, a (B,) f32 tensor on the model's device), under
    ``torch.inference_mode``; ``u`` and ``s`` come back as the same tensors
    and the clock advances on the device, so a step reads nothing back to
    the host. The weights are cast once, here (``freeze``), as for
    :func:`_two_state_step`."""
    model.eval()
    model.freeze()
    lead = model.lead_hours

    @torch.inference_mode()
    def step(u_prev: torch.Tensor, s_prev: torch.Tensor, u: torch.Tensor, s: torch.Tensor,
             hours: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return (u, s, *model(u_prev, s_prev, u, s, hours, aux), hours + lead)

    return step


def rollout(model: nn.Module, state: Tuple[torch.Tensor, ...], aux: AuxConstants, steps: int,
            keep_trajectory: bool = True) -> Tuple[torch.Tensor, ...]:
    """``steps`` autoregressive steps from ``state`` ((upper, surface),
    FuXi's (x_prev, x_cur) or Aurora's (u_prev, s_prev, u, s, hours)).
    Returns each field's stacked (steps, ...) trajectory when
    ``keep_trajectory`` (for FuXi the second holds the forecasts, for Aurora
    the third and fourth, and the fifth the clock), else the final state (as
    ``pangu_tpu.rollout.autoregressive.rollout_scan``)."""
    step = make_forecast_step(model, aux)
    traj = []
    for _ in range(steps):
        state = step(*state)
        if keep_trajectory:
            traj.append(state)
    if keep_trajectory:
        return tuple(torch.stack(field) for field in zip(*traj))
    return tuple(state)
