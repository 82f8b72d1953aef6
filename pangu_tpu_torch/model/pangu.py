"""The Pangu-Weather backbone (port of ``pangu_tpu/model/pangu.py``).

embed -> layer0 (C, full grid) -> skip -> down -> layer1 -> layer2 (2C, half
grid) -> up -> layer3 (C, full grid) -> concat skip -> recovery.

Submodule names are the reference's (``_input_layer``, ``layers``,
``downsample``, ``upsample``, ``_output_layer``), so ``state_dict()`` keys and
shapes equal ``pangu_tpu.interop.torch_import.reference_key_map``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from pangu_tpu.config import ModelConfig
from pangu_tpu.geometry import compute_geometry
from pangu_tpu_torch import dtype_of
from pangu_tpu_torch.aux import AuxConstants
from pangu_tpu_torch.model.blocks import DownSample, EarthSpecificLayer, UpSample
from pangu_tpu_torch.model.embeddings import PatchEmbedding, PatchRecovery


class PanguModel(nn.Module):
    """Parameters are f32; activations run in ``cfg.compute_dtype``. With
    ``cfg.use_pallas_attention`` and bf16 compute, inference blocks run the
    fused block kernel."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        g = self.geom = compute_geometry(cfg)
        stages = (g.outer, g.inner, g.inner, g.outer)
        self._input_layer = PatchEmbedding(cfg, g)
        self.layers = nn.ModuleDict({
            f"EarthSpecificLayer{i}": EarthSpecificLayer(
                stages[i], cfg.depths[i], cfg.dims[i], cfg.heads[i],
                mlp_ratio=cfg.mlp_ratio, use_kernel=cfg.use_pallas_attention)
            for i in range(4)
        })
        self.downsample = DownSample(cfg.dims[0], g.h_down_pad)
        self.upsample = UpSample(cfg.dims[2], cfg.dims[3], g.h)
        self._output_layer = PatchRecovery(cfg, g)

    def forward(self, upper: torch.Tensor, surface: torch.Tensor,
                aux: AuxConstants) -> Tuple[torch.Tensor, torch.Tensor]:
        """Physical (B, Vu, L, lat, lon) and (B, Vs, lat, lon) -> normalized
        next-state fields of the same shapes, f32."""
        layers = list(self.layers.values())
        x = self._input_layer(upper, surface, aux, self.compute_dtype)
        x = layers[0](x)
        skip = x
        x = self.downsample(x)
        x = layers[1](x)
        x = layers[2](x)
        x = self.upsample(x)
        x = layers[3](x)
        return self._output_layer(torch.cat([skip, x], dim=-1))
