"""Parameters and optimizer state for the port: converted from a JAX tree,
or drawn from a seed (port-side counterpart of
``pangu_tpu/interop/torch_import.py``).

The port's state dict IS the reference torch state dict, so the exporter
``state_dict_from_params`` (the port's copy of the JAX package's
``interop/torch_import.py``) is the converter; only numpy arrays cross the
boundary.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from pangu_tpu_torch.config import ModelConfig
from pangu_tpu_torch.interop import npz_io
from pangu_tpu_torch.interop.torch_import import params_from_state_dict, state_dict_from_params
from pangu_tpu_torch.model.attention import EarthAttention3D


def load_jax_params(model: nn.Module, cfg: ModelConfig, jax_params: Mapping) -> None:
    """Load a JAX ``{'params': ...}`` tree of numpy arrays into ``model``
    (strict: every reference key, nothing else)."""
    state = state_dict_from_params(cfg, jax_params)
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)


def save_params_npz(path: str, model: nn.Module) -> None:
    """Write ``model``'s weights as the JAX package's ``.npz`` param tree
    (``params_from_state_dict``, keys flattened by ``npz_io.flatten_tree``): a
    file either package writes loads in both. Stored uncompressed: float
    weights deflate by ~7%, and deflating the flagship's 1.06 GB takes ~45 s."""
    state = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
    np.savez(path, **npz_io.flatten_tree(params_from_state_dict(model.cfg, state)))


def _adam_state(opt_state: Any):
    """The element of an optax state that holds Adam's ``count``, ``mu``
    and ``nu`` (found by its fields, so that no optax import is needed)."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def load_jax_opt_state(optimizer: torch.optim.Optimizer, model: nn.Module, cfg: ModelConfig,
                       opt_state: Any) -> None:
    """Load the Adam moments and update count of an optax state (the JAX
    train step's ``add_decayed_weights -> scale_by_adam -> scale_by_schedule``
    chain) into ``optimizer``, a ``torch.optim.Adam`` over ``model``'s
    parameters: a JAX run resumes in the port with the same next update. The
    moment trees convert like the params, through ``state_dict_from_params``."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("opt_state holds no Adam state (count, mu, nu)")
    mu, nu = state_dict_from_params(cfg, adam.mu), state_dict_from_params(cfg, adam.nu)
    count = float(np.asarray(adam.count))
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.tensor(mu[name], device=p.device),
            "exp_avg_sq": torch.tensor(nu[name], device=p.device),
        }


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
