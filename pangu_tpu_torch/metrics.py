"""Forecast scores (port of ``pangu_tpu/metrics.py``; so far only what the
training loss needs)."""

from __future__ import annotations

import torch


def wind_speed(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sqrt(u^2 + v^2)."""
    return torch.sqrt(u * u + v * v)
