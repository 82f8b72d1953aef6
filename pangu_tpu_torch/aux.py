"""Auxiliary constants on a device: normalization statistics and constant
fields (port of ``pangu_tpu/aux.py``).

Orientations are the JAX package's canonical ones:

  * ``upper_mean/std``:   (1, V, L, 1, 1) in data level order;
  * ``surface_mean/std``: (1, V, 1, 1);
  * ``surface_mask``:     (3, lat + lat_pad, lon);
  * ``const_h``:          (1, levels, lat, lon).

``synthetic_aux_constants`` draws the same numpy random sequence as the JAX
package, so both packages see identical constants for one seed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from pangu_tpu_torch.config import ModelConfig, TrainConfig
from pangu_tpu_torch.geometry import compute_geometry


@dataclass
class AuxConstants:
    """Constants consumed by the model and the de-normalization, as tensors
    on one device (role of the reference's ``loadAllConstants`` dict)."""

    surface_mean: torch.Tensor  # (1, Vs, 1, 1)
    surface_std: torch.Tensor  # (1, Vs, 1, 1)
    upper_mean: torch.Tensor  # (1, Vu, L, 1, 1)
    upper_std: torch.Tensor  # (1, Vu, L, 1, 1)
    surface_mask: torch.Tensor  # (Cs_const, lat_padded, lon)
    const_h: torch.Tensor  # (Cu_const, L, lat, lon)
    upper_weights: torch.Tensor  # (1, Vu, 1, 1, 1)
    surface_weights: torch.Tensor  # (1, Vs, 1, 1)
    upper_loss_weight: float = 1.0
    surface_loss_weight: float = 0.25
    custom_mask: Optional[torch.Tensor] = None  # (lat, lon) or None


def _variable_weights(train: TrainConfig):
    uw = np.asarray(train.upper_weights, np.float32).reshape(1, -1, 1, 1, 1)
    sw = np.asarray(train.surface_weights, np.float32).reshape(1, -1, 1, 1)
    return uw, sw, float(train.upper_loss_weight), float(train.surface_loss_weight)


def _on(device, **arrays) -> dict:
    return {k: (None if v is None else torch.from_numpy(np.ascontiguousarray(v)).to(device))
            for k, v in arrays.items()}


def synthetic_aux_constants(model_cfg: ModelConfig, train_cfg: TrainConfig,
                            seed: int = 0, device="cuda") -> AuxConstants:
    """Deterministic stand-in constants, equal to
    ``pangu_tpu.aux.synthetic_aux_constants`` for the same seed, on
    ``device`` (the card unless the caller asks for the CPU)."""
    g = compute_geometry(model_cfg)
    rng = np.random.default_rng(seed)
    vs, vu, L = model_cfg.surface_vars, model_cfg.upper_vars, model_cfg.levels
    # draw order must stay that of the JAX package (keyword evaluation order)
    surface_mean = rng.normal(size=(1, vs, 1, 1)).astype(np.float32)
    surface_std = (1.0 + rng.uniform(0.5, 1.5, size=(1, vs, 1, 1))).astype(np.float32)
    upper_mean = rng.normal(size=(1, vu, L, 1, 1)).astype(np.float32)
    upper_std = (1.0 + rng.uniform(0.5, 1.5, size=(1, vu, L, 1, 1))).astype(np.float32)
    surface_mask = rng.normal(
        size=(model_cfg.surface_const_channels, model_cfg.lat + g.lat_pad, model_cfg.lon)
    ).astype(np.float32)
    const_h = rng.normal(
        size=(model_cfg.upper_const_channels, L, model_cfg.lat, model_cfg.lon)
    ).astype(np.float32)
    uw, sw, ulw, slw = _variable_weights(train_cfg)
    return AuxConstants(
        **_on(device, surface_mean=surface_mean, surface_std=surface_std,
              upper_mean=upper_mean, upper_std=upper_std,
              surface_mask=surface_mask, const_h=const_h,
              upper_weights=uw, surface_weights=sw),
        upper_loss_weight=ulw, surface_loss_weight=slw, custom_mask=None,
    )


def load_aux_constants(model_cfg: ModelConfig, train_cfg: TrainConfig,
                       aux_dir: Optional[str] = None, horizon: int = 24,
                       device="cuda") -> AuxConstants:
    """Real constants from ``aux_dir`` (the files the ONNX importer writes:
    surface_mean/std.npy, upper_mean/std.npy, constantMask{h}.npy,
    Constant_17_output_0.npy, optional custom_mask.npy), else synthetic; on
    ``device`` (the card unless the caller asks for the CPU)."""
    if not (aux_dir and os.path.isdir(aux_dir)):
        return synthetic_aux_constants(model_cfg, train_cfg, device=device)

    def rd(name):
        return np.load(os.path.join(aux_dir, name)).astype(np.float32)

    surface_mean = rd("surface_mean.npy").reshape(1, model_cfg.surface_vars, 1, 1)
    surface_std = rd("surface_std.npy").reshape(1, model_cfg.surface_vars, 1, 1)
    # raw upper stats are (L, 1, 1, V), levels top-to-bottom: flip to data
    # level order and move V forward (pangu_tpu/aux.py:117-123)
    um = np.transpose(rd("upper_mean.npy")[::-1], (1, 3, 0, 2))[..., None]
    us = np.transpose(rd("upper_std.npy")[::-1], (1, 3, 0, 2))[..., None]
    surface_mask = rd(f"constantMask{horizon}.npy")
    surface_mask = surface_mask.reshape(model_cfg.surface_const_channels,
                                        *surface_mask.shape[-2:])
    const_h = rd("Constant_17_output_0.npy").reshape(
        model_cfg.upper_const_channels, model_cfg.levels, model_cfg.lat, model_cfg.lon)
    custom_path = os.path.join(aux_dir, "custom_mask.npy")
    custom = np.load(custom_path).astype(np.float32) if os.path.exists(custom_path) else None
    uw, sw, ulw, slw = _variable_weights(train_cfg)
    return AuxConstants(
        **_on(device, surface_mean=surface_mean, surface_std=surface_std,
              upper_mean=um, upper_std=us, surface_mask=surface_mask,
              const_h=const_h, upper_weights=uw, surface_weights=sw,
              custom_mask=custom),
        upper_loss_weight=ulw, surface_loss_weight=slw,
    )


def norm_data(upper: torch.Tensor, surface: torch.Tensor,
              aux: AuxConstants) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standardize raw-physical-unit fields."""
    return ((upper - aux.upper_mean) / aux.upper_std,
            (surface - aux.surface_mean) / aux.surface_std)


def norm_back_data(upper: torch.Tensor, surface: torch.Tensor,
                   aux: AuxConstants) -> Tuple[torch.Tensor, torch.Tensor]:
    """De-standardize model-space fields back to physical units."""
    return (upper * aux.upper_std + aux.upper_mean,
            surface * aux.surface_std + aux.surface_mean)
