"""The toy architecture's plain reference: its step as a function of a
state dict, written apart from ``ToyNet``."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def param_shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    c, h = sum(m["split"]), m["hidden"]
    return {"fc1.weight": (h, c), "fc1.bias": (h,), "fc2.weight": (c, h), "fc2.bias": (c,)}


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w.T + b``; below "f32" the operands rounded to bfloat16 first."""
    if precision != "f32":
        x, w = x.bfloat16().float(), w.bfloat16().float()
    return x @ w.t() + b


def forward(P: dict, m: dict, state: tuple, precision: str = "f32") -> tuple:
    """The fields joined on their channels, a residual tanh MLP on each
    point's channels, split back."""
    x = torch.cat(state, dim=1).transpose(1, 2)
    h = torch.tanh(linear(x, P["fc1.weight"], P["fc1.bias"], precision))
    x = x + linear(h, P["fc2.weight"], P["fc2.bias"], precision)
    return tuple(x.transpose(1, 2).split(m["split"], dim=1))
