"""The Pangu-Weather backbone (port of ``pangu_tpu/model/pangu.py``).

embed -> layer0 (C, full grid) -> skip -> down -> layer1 -> layer2 (2C, half
grid) -> up -> layer3 (C, full grid) -> concat skip -> recovery.

Submodule names are the reference's (``_input_layer``, ``layers``,
``downsample``, ``upsample``, ``_output_layer``), so ``state_dict()`` keys and
shapes equal ``pangu_tpu_torch.interop.torch_import.reference_key_map``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from pangu_tpu_torch.config import ModelConfig
from pangu_tpu_torch.geometry import compute_geometry
from pangu_tpu_torch import dtype_of
from pangu_tpu_torch.aux import AuxConstants
from pangu_tpu_torch.model.blocks import DownSample, EarthSpecificLayer, UpSample
from pangu_tpu_torch.model.embeddings import PatchEmbedding, PatchRecovery


def drop_path_rates(cfg: ModelConfig) -> Tuple[Tuple[float, ...], ...]:
    """Linear stochastic-depth ramp over all blocks, per layer
    (pangu_tpu/model/pangu.py:39-49)."""
    ramp = np.linspace(0.0, cfg.drop_path_max, sum(cfg.depths))
    out, off = [], 0
    for d in cfg.depths:
        out.append(tuple(float(r) for r in ramp[off:off + d]))
        off += d
    return tuple(out)


class PanguModel(nn.Module):
    """Parameters are f32; activations run in ``cfg.compute_dtype``. With
    ``cfg.use_pallas_attention`` and bf16 compute, eval blocks run the fused
    block kernel and training blocks the training kernels. In training,
    blocks are checkpointed when ``cfg.remat`` and drop paths follow the
    linear ramp up to ``cfg.drop_path_max``, drawn from the generator passed
    to ``forward``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        g = self.geom = compute_geometry(cfg)
        stages = (g.outer, g.inner, g.inner, g.outer)
        rates = drop_path_rates(cfg)
        self._input_layer = PatchEmbedding(cfg, g)
        self.layers = nn.ModuleDict({
            f"EarthSpecificLayer{i}": EarthSpecificLayer(
                stages[i], cfg.dims[i], cfg.heads[i], rates[i], mlp_ratio=cfg.mlp_ratio,
                use_kernel=cfg.use_pallas_attention, remat=cfg.remat,
                dropout_rate=cfg.dropout_rate)
            for i in range(4)
        })
        self.downsample = DownSample(cfg.dims[0], g.h_down_pad)
        self.upsample = UpSample(cfg.dims[2], cfg.dims[3], g.h)
        self._output_layer = PatchRecovery(cfg, g)

    def forward(self, upper: torch.Tensor, surface: torch.Tensor, aux: AuxConstants,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Physical (B, Vu, L, lat, lon) and (B, Vs, lat, lon) -> normalized
        next-state fields of the same shapes, f32. ``generator`` draws the
        drop paths in training (required when a rate is above 0)."""
        layers = list(self.layers.values())
        x = self._input_layer(upper, surface, aux, self.compute_dtype)
        x = layers[0](x, generator)
        skip = x
        x = self.downsample(x)
        x = layers[1](x, generator)
        x = layers[2](x, generator)
        x = self.upsample(x)
        x = layers[3](x, generator)
        return self._output_layer(torch.cat([skip, x], dim=-1))
