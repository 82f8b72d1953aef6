"""Window partition/reverse layout transforms (port of
``pangu_tpu/ops/windows.py``).

Token order inside a window is (z, h, w)-major; the type axis enumerates
(z-window, h-window) pairs, type index ``zi * hn + hi`` — the reference's
permute chain, so earth-specific biases import unchanged.
"""

from __future__ import annotations

from typing import Tuple

import torch


def window_partition(x: torch.Tensor, window: Tuple[int, int, int]) -> torch.Tensor:
    """(B, Z, Hp, W, C) -> (B, n_lon, n_type, T, C)."""
    wz, wh, ww = window
    b, z, h, w, c = x.shape
    x = x.reshape(b, z // wz, wz, h // wh, wh, w // ww, ww, c)
    x = x.permute(0, 5, 1, 3, 2, 4, 6, 7)  # (B, Wn, Zn, Hn, wz, wh, ww, C)
    return x.reshape(b, w // ww, (z // wz) * (h // wh), wz * wh * ww, c)


def window_reverse(x: torch.Tensor, window: Tuple[int, int, int],
                   z: int, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`: -> (B, Z, Hp, W, C)."""
    wz, wh, ww = window
    b, c = x.shape[0], x.shape[-1]
    x = x.reshape(b, w // ww, z // wz, h // wh, wz, wh, ww, c)
    x = x.permute(0, 2, 4, 3, 5, 1, 6, 7)
    return x.reshape(b, z, h, w, c)
