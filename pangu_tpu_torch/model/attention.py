"""3D windowed attention with Earth-Specific bias (port of
``pangu_tpu/model/attention.py``).

``EarthAttention3D`` consumes the padded token grid (B, Z, Hp, W, C). In
training with bf16 compute and ``use_kernel`` set it runs the training
attention K2 (``ops.fused_block_attention.fused_block_attention``), whose
backward is the flash backward K3; otherwise the plain windowed path
(partition, per-head scores + earth bias [+ shift mask], f32 softmax,
reverse), the JAX package's XLA path. With ``epilogue=(ln_scale, ln_bias)``
and ``use_kernel`` set it runs K2's LN-epilogue mode ``x + LN(attn(x))`` in
any mode; without ``use_kernel`` the epilogue raises, as the JAX module
asserts. The fused inference block does not call it: ``EarthSpecificBlock``
hands its weights to the block kernel instead.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from pangu_tpu_torch.geometry import StageGeometry
from pangu_tpu_torch.ops.fused_block_attention import dense, dot_f32, fused_block_attention
from pangu_tpu_torch.ops.windows import window_partition, window_reverse


@functools.lru_cache(maxsize=None)
def shift_attention_mask(stage: StageGeometry) -> np.ndarray:
    """Static additive mask (n_type, T, T) for the shifted-window pass.

    Reproduces the reference's region labelling, including its non-Swin
    middle latitude slice ``[wh, Hp - wh/2)``; longitude needs no mask (the
    roll is circular, as the sphere is). Fill value -100, not -inf."""
    wz, wh, ww = stage.window
    z, hp = stage.z, stage.h_pad
    label = np.zeros((z, hp), np.int32)
    cnt = 0
    z_slices = (slice(0, -wz), slice(-wz, -wz // 2), slice(-wz // 2, None))
    h_slices = (slice(0, -wh), slice(wh, -wh // 2), slice(-wh // 2, None))
    for zs in z_slices:
        for hs in h_slices:
            label[zs, hs] = cnt
            cnt += 1
    # (Zn, wz, Hn, wh) -> type-major token labels, broadcast over longitude
    lab = label.reshape(z // wz, wz, hp // wh, wh)
    lab = lab.transpose(0, 2, 1, 3).reshape(stage.n_type_windows, wz, wh)
    lab = np.broadcast_to(lab[..., None], (stage.n_type_windows, wz, wh, ww))
    lab = lab.reshape(stage.n_type_windows, stage.tokens_per_window)
    diff = lab[:, :, None] - lab[:, None, :]
    return np.where(diff != 0, np.float32(-100.0), np.float32(0.0))


class EarthAttention3D(nn.Module):
    """Multi-head window attention with a dense bias per window type.

    Parameters as in the reference state dict: ``linear1`` (3C, C) qkv,
    ``linear2`` (C, C) projection, ``earth_specific_bias``
    (1, n_type, heads, T, T)."""

    def __init__(self, dim: int, heads: int, stage: StageGeometry, use_kernel: bool = False,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dim, self.heads, self.window = dim, heads, stage.window
        self.use_kernel, self.dropout_rate = use_kernel, dropout_rate
        self.linear1 = nn.Linear(dim, 3 * dim)
        self.linear2 = nn.Linear(dim, dim)
        t = stage.tokens_per_window
        self.earth_specific_bias = nn.Parameter(
            torch.zeros(1, stage.n_type_windows, heads, t, t))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                epilogue: Optional[tuple] = None) -> torch.Tensor:
        """(B, Z, Hp, W, C) in the compute dtype -> same shape and dtype;
        ``epilogue`` (ln_scale, ln_bias) adds the block's post-norm residual
        ``x + LN(.)``."""
        cdt = x.dtype
        b, z, hp, w, c = x.shape
        d = c // self.heads
        if self.training and self.dropout_rate > 0.0:
            raise NotImplementedError("attention dropout in training is not ported")
        if epilogue is not None and not self.use_kernel:
            raise ValueError("the fused epilogue needs the kernel route (use_kernel)")
        if epilogue is not None or (self.training and self.use_kernel and cdt == torch.bfloat16):
            ln_s, ln_b = (None, None) if epilogue is None else (epilogue[0].float(),
                                                                epilogue[1].float())
            return fused_block_attention(
                x, self.linear1.weight.to(cdt), self.linear1.bias.to(cdt),
                self.linear2.weight.to(cdt), self.linear2.bias.to(cdt),
                self.earth_specific_bias[0].float(), mask, ln_s, ln_b,
                self.window, self.heads, d ** -0.5)
        xw = window_partition(x, self.window)  # (B, nW, nT, T, C)
        n_w, n_t, t = xw.shape[1:4]
        qkv = dense(xw, self.linear1.weight, self.linear1.bias)
        q, k, v = qkv.reshape(b, n_w, n_t, t, 3, self.heads, d).permute(4, 0, 1, 2, 5, 3, 6)
        attn = dot_f32(q * d ** -0.5, k.transpose(-1, -2))
        attn = attn + self.earth_specific_bias[0].float()
        if mask is not None:
            attn = attn + mask.float()[:, None]
        attn = torch.softmax(attn, dim=-1).to(cdt)
        out = dot_f32(attn, v).to(cdt)  # (B, nW, nT, heads, T, d)
        out = out.permute(0, 1, 2, 4, 3, 5).reshape(b, n_w, n_t, t, c)
        out = dense(out, self.linear2.weight, self.linear2.bias)
        return window_reverse(out, self.window, z, hp, w)
