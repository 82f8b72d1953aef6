"""Patch embedding and recovery (port of ``pangu_tpu/model/embeddings.py``,
reshape path).

The JAX package's one-hot einsum path exists only to avoid TPU lane
relayouts; on the GPU the exact reshape path is the one path. Flattened
patch-feature orders are the reference's, so its Conv1d kernels load as is:

  * surface embed features:  (var, lat-offset, lon-offset)
  * upper embed features:    (var, z-offset, lat-offset, lon-offset)
  * upper recovery channels: (var, z-offset, lat-offset, lon-offset)
  * surface recovery:        (var, lat-offset, lon-offset)
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pangu_tpu_torch.config import ModelConfig
from pangu_tpu_torch.geometry import Geometry
from pangu_tpu_torch.aux import AuxConstants
from pangu_tpu_torch.ops.fused_block_attention import dense


def _project(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """A per-token 1x1 Conv1d, as a Dense."""
    return dense(x, conv.weight[:, :, 0], conv.bias)


class PatchEmbedding(nn.Module):
    """Normalize, append the constant fields, pad, patchify, project.
    Output: (B, Z, H, W, C) token grid with the surface plane at z=0."""

    def __init__(self, cfg: ModelConfig, geom: Geometry):
        super().__init__()
        self.cfg, self.geom = cfg, geom
        c = cfg.dims[0]
        self.conv = nn.Conv1d(cfg.embed_upper_channels, c, 1)
        self.conv_surface = nn.Conv1d(cfg.embed_surface_channels, c, 1)

    def forward(self, upper: torch.Tensor, surface: torch.Tensor, aux: AuxConstants,
                cdt: torch.dtype) -> torch.Tensor:
        cfg, g = self.cfg, self.geom
        pz, ph, pw = cfg.patch
        b = surface.shape[0]

        surface = ((surface - aux.surface_mean) / aux.surface_std).to(cdt)
        surface = F.pad(surface, (0, 0, 0, g.lat_pad))
        masks = aux.surface_mask[None].expand(b, *aux.surface_mask.shape).to(cdt)
        surface = torch.cat([surface, masks], dim=1)  # (B, 7, latp, lon)
        cs = surface.shape[1]
        surface = surface.reshape(b, cs, g.h, ph, g.w, pw).permute(0, 2, 4, 1, 3, 5)
        surface_tok = _project(surface.reshape(b, g.h, g.w, cs * ph * pw), self.conv_surface)

        upper = ((upper - aux.upper_mean) / aux.upper_std).to(cdt)
        const_h = aux.const_h[None].expand(b, *aux.const_h.shape).to(cdt)
        upper = torch.cat([upper, const_h], dim=1)  # (B, 6, L, lat, lon)
        upper = F.pad(upper, (0, 0, 0, g.lat_pad, 0, g.level_pad))
        cu = upper.shape[1]
        upper = upper.reshape(b, cu, g.z_upper, pz, g.h, ph, g.w, pw)
        upper = upper.permute(0, 2, 4, 6, 1, 3, 5, 7)
        upper_tok = _project(upper.reshape(b, g.z_upper, g.h, g.w, cu * pz * ph * pw),
                             self.conv)
        return torch.cat([surface_tok[:, None], upper_tok], dim=1)


class PatchRecovery(nn.Module):
    """Project tokens (B, Z, H, W, 2C) back to fields and crop the pads.
    Outputs are f32 in normalized space (callers apply ``norm_back_data``)."""

    def __init__(self, cfg: ModelConfig, geom: Geometry):
        super().__init__()
        self.cfg, self.geom = cfg, geom
        cin = cfg.dims[0] + cfg.dims[3]  # skip concat + layer 3
        self.conv = nn.Conv1d(cin, cfg.recovery_upper_channels, 1)
        self.conv_surface = nn.Conv1d(cin, cfg.recovery_surface_channels, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, g = self.cfg, self.geom
        pz, ph, pw = cfg.patch
        b = x.shape[0]
        vu, vs = cfg.upper_vars, cfg.surface_vars

        up = _project(x[:, 1:], self.conv)
        up = up.reshape(b, g.z_upper, g.h, g.w, vu, pz, ph, pw)
        up = up.permute(0, 4, 1, 5, 2, 6, 3, 7)  # (B, var, Zu, dz, H, dy, W, dx)
        up = up.reshape(b, vu, g.z_upper * pz, g.h * ph, g.w * pw)
        up = up[:, :, :cfg.levels, :cfg.lat]

        sf = _project(x[:, 0], self.conv_surface)
        sf = sf.reshape(b, g.h, g.w, vs, ph, pw).permute(0, 3, 1, 4, 2, 5)
        sf = sf.reshape(b, vs, g.h * ph, g.w * pw)[:, :, :cfg.lat]
        return up.float(), sf.float()
