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
from pangu_tpu_torch.geometry import Geometry, compute_geometry
from pangu_tpu_torch import dtype_of
from pangu_tpu_torch.aux import AuxConstants
from pangu_tpu_torch.model.blocks import DownSample, EarthSpecificLayer, UpSample
from pangu_tpu_torch.model.embeddings import PatchEmbedding, PatchRecovery


#: the widths the CUDA kernels take: tokens per window, head dim, channels, MLP ratio
KERNEL_WINDOW_TOKENS, KERNEL_HEAD_DIM, KERNEL_DIMS, KERNEL_MLP_RATIO = 144, 32, (192, 384), 4


def check_kernel_widths(cfg: ModelConfig) -> None:
    """Raise ValueError when ``cfg`` routes bf16 blocks to the CUDA kernels
    (``use_pallas_attention`` with bf16 compute) at widths they do not take:
    they take 144-token windows, head dim 32, C in (192, 384) and an MLP
    hidden of 4C. Called where the model meets the card, before any launch;
    the CPU runs the kernels' plain versions at any width."""
    if not (cfg.use_pallas_attention and cfg.compute_dtype == "bfloat16"):
        return
    tokens = int(np.prod(cfg.window))
    head_dims = tuple(c // h for c, h in zip(cfg.dims, cfg.heads))
    if (tokens != KERNEL_WINDOW_TOKENS or any(d != KERNEL_HEAD_DIM for d in head_dims)
            or any(c not in KERNEL_DIMS for c in cfg.dims) or cfg.mlp_ratio != KERNEL_MLP_RATIO):
        raise ValueError(
            f"the CUDA kernels take {KERNEL_WINDOW_TOKENS}-token windows, head dim "
            f"{KERNEL_HEAD_DIM}, C in {KERNEL_DIMS} and an MLP hidden of {KERNEL_MLP_RATIO}C; "
            f"this model has window {tuple(cfg.window)} ({tokens} tokens), dims "
            f"{tuple(cfg.dims)}, heads {tuple(cfg.heads)} (head dims {head_dims}) and MLP "
            f"ratio {cfg.mlp_ratio}: pass use_pallas_attention=False to run it on the card")


def drop_path_rates(cfg: ModelConfig) -> Tuple[Tuple[float, ...], ...]:
    """Linear stochastic-depth ramp over all blocks, per layer
    (pangu_tpu/model/pangu.py:39-49)."""
    ramp = np.linspace(0.0, cfg.drop_path_max, sum(cfg.depths))
    out, off = [], 0
    for d in cfg.depths:
        out.append(tuple(float(r) for r in ramp[off:off + d]))
        off += d
    return tuple(out)


def backbone_module(cfg: ModelConfig, g: Geometry, op: str) -> nn.Module:
    """The module of one op of the backbone chain (the JAX package's
    ``backbone_modules`` names: ``patch_embed``, ``layer0``-``layer3``,
    ``downsample``, ``upsample``, ``patch_recovery``), as the whole model
    holds it; a pipeline stage builds only its own ops."""
    if op == "patch_embed":
        return PatchEmbedding(cfg, g)
    if op == "downsample":
        return DownSample(cfg.dims[0], g.h_down_pad)
    if op == "upsample":
        return UpSample(cfg.dims[2], cfg.dims[3], g.h)
    if op == "patch_recovery":
        return PatchRecovery(cfg, g)
    i = int(op.removeprefix("layer"))
    return EarthSpecificLayer(
        (g.outer, g.inner, g.inner, g.outer)[i], cfg.dims[i], cfg.heads[i],
        drop_path_rates(cfg)[i], mlp_ratio=cfg.mlp_ratio, use_kernel=cfg.use_pallas_attention,
        remat=cfg.remat, dropout_rate=cfg.dropout_rate, save_attention=cfg.remat_save_attention,
        save_mlp=cfg.remat_save_mlp)


class PanguModel(nn.Module):
    """Parameters are f32; activations run in ``cfg.compute_dtype``. With
    ``cfg.use_pallas_attention`` and bf16 compute, eval blocks run the fused
    block kernel and training blocks the training kernels. In training,
    blocks are checkpointed when ``cfg.remat`` (but for the outputs that
    ``cfg.remat_save_attention`` and ``cfg.remat_save_mlp`` keep) and drop
    paths follow the linear ramp up to ``cfg.drop_path_max``, drawn from the
    generator passed to ``forward``. On a CUDA input the model first checks
    that the kernels take its widths (:func:`check_kernel_widths`)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        g = self.geom = compute_geometry(cfg)
        self._input_layer = backbone_module(cfg, g, "patch_embed")
        self.layers = nn.ModuleDict({f"EarthSpecificLayer{i}": backbone_module(cfg, g, f"layer{i}")
                                     for i in range(4)})
        self.downsample = backbone_module(cfg, g, "downsample")
        self.upsample = backbone_module(cfg, g, "upsample")
        self._output_layer = backbone_module(cfg, g, "patch_recovery")

    def forward(self, upper: torch.Tensor, surface: torch.Tensor, aux: AuxConstants,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Physical (B, Vu, L, lat, lon) and (B, Vs, lat, lon) -> normalized
        next-state fields of the same shapes, f32. ``generator`` draws the
        drop paths and dropout masks in training (required when a rate is
        above 0 or an unmerged adapter has dropout)."""
        if upper.is_cuda:
            check_kernel_widths(self.cfg)
        layers = list(self.layers.values())
        x = self._input_layer(upper, surface, aux, self.compute_dtype)
        x = layers[0](x, generator)
        skip = x
        x = self.downsample(x, generator)
        x = layers[1](x, generator)
        x = layers[2](x, generator)
        x = self.upsample(x, generator)
        x = layers[3](x, generator)
        return self._output_layer(torch.cat([skip, x], dim=-1))
