"""Parameters for the port: converted from a JAX param tree, or drawn from a
seed (port-side counterpart of ``pangu_tpu/interop/torch_import.py``).

The port's state dict IS the reference torch state dict, so the JAX package's
own exporter ``state_dict_from_params`` is the converter; only numpy arrays
cross the boundary.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from pangu_tpu.config import ModelConfig
from pangu_tpu.interop.torch_import import state_dict_from_params
from pangu_tpu_torch.model.attention import EarthAttention3D


def load_jax_params(model: nn.Module, cfg: ModelConfig, jax_params: Mapping) -> None:
    """Load a JAX ``{'params': ...}`` tree of numpy arrays into ``model``
    (strict: every reference key, nothing else)."""
    state = state_dict_from_params(cfg, jax_params)
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)


@torch.no_grad()
def init_params(model: nn.Module, seed: int) -> None:
    """Seeded synthetic parameters with the JAX package's initializers:
    truncated normal (std 0.02, cut at 2 std) for Dense/Conv kernels and
    earth-specific biases, zeros for biases, ones/zeros for LayerNorms.
    Drawn on the CPU, so one seed gives the same weights on any device."""
    gen = torch.Generator().manual_seed(seed)

    def trunc_normal(p: torch.Tensor) -> None:
        cpu = torch.empty(p.shape, dtype=torch.float32)
        nn.init.trunc_normal_(cpu, std=0.02, a=-0.04, b=0.04, generator=gen)
        p.copy_(cpu)

    for m in model.modules():
        if isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv1d)):
            trunc_normal(m.weight)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, EarthAttention3D):
            trunc_normal(m.earth_specific_bias)
