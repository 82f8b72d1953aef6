"""Training loss family (port of ``pangu_tpu/train/loss.py``).

All variants are weighted L1 on normalized fields:

  * standard: per-variable weights, then upper * 1.0 + surface * 0.25;
  * wind-speed-only: L1 on sqrt(u^2 + v^2), surface plus upper;
  * region-masked: sum over the masked points / (valid points x batch).
"""

from __future__ import annotations

from typing import Optional

import torch

from pangu_tpu_torch.aux import AuxConstants
from pangu_tpu_torch.metrics import wind_speed


def weighted_l1_loss(out_upper: torch.Tensor, out_surface: torch.Tensor,
                     tgt_upper: torch.Tensor, tgt_surface: torch.Tensor, aux: AuxConstants,
                     only_wind_speed: bool = False,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar loss; ``mask`` (lat, lon) marks the scored points with 1."""
    if only_wind_speed:
        # surface u10/v10 are channels 1/2; upper u/v are variables 3/4
        l_s = (wind_speed(out_surface[:, 1], out_surface[:, 2])
               - wind_speed(tgt_surface[:, 1], tgt_surface[:, 2])).abs()
        l_u = (wind_speed(out_upper[:, 3], out_upper[:, 4])
               - wind_speed(tgt_upper[:, 3], tgt_upper[:, 4])).abs()
        if mask is not None:
            valid = mask.sum() * l_s.shape[0]
            return (l_s * mask[None]).sum() / valid + (l_u * mask[None, None]).sum() / valid
        return l_s.mean() + l_u.mean()

    l_s = (out_surface - tgt_surface).abs() * aux.surface_weights
    l_u = (out_upper - tgt_upper).abs() * aux.upper_weights
    if mask is not None:
        valid = mask.sum() * l_s.shape[0]
        w_s = (l_s * mask[None, None]).sum() / valid
        w_u = (l_u * mask[None, None, None]).sum() / valid
    else:
        w_s = l_s.mean()
        w_u = l_u.mean()
    return w_u * aux.upper_loss_weight + w_s * aux.surface_loss_weight
