"""The whole Earth-Specific block in training (port of
``pangu_tpu/ops/fused_block_train.py``).

``fused_earth_block_train`` (K11) runs one training block on the (possibly
rolled) window-padded grid ``x`` (B, Z, Hp, W, C), with per-sample
stochastic-depth branch scales ``s1``, ``s2`` ((B,) or (B, 1) f32, ones when
drop path is inactive):

    x1  = x + s1 * LN1(attn(x))
    out = x1 + s2 * LN2(GELU(x1 @ W1 + b1) @ W2 + b2)

with the rounding points of the Pallas body: q|k|v, the probabilities, the
attention output, ``a = attn @ Wproj + bproj``, ``x1`` and the GELU hidden
(rounded after an f32 GELU) in x's dtype; LayerNorm statistics (E[y^2] -
mu^2), residual adds and every sum f32. Its ``torch.autograd`` backward is
the flash backward K12: the block recomputed from its inputs, then all 16
gradients -- dx, dWqkv, dbqkv, dWproj, dbproj, dbias, dgamma1, dbeta1, dW1,
db1, dW2, db2, dgamma2, dbeta2, ds1, ds2. The Function saves only its
inputs, so a block on this route needs no checkpoint around it.

On a CUDA tensor each direction launches the hand-written sm_90a kernels of
``csrc/fused_block_train.cu`` (built with nvcc at first use) or raises; on a
CPU tensor it runs its plain PyTorch version. There is no fallback from a
kernel to its plain version.

Weights use nn.Linear's (out, in) layout: wqkv (3C, C), wproj (C, C), w1
(4C, C), w2 (C, 4C); bias (nT, heads, T, T) and mask (nT, T, T) f32;
LayerNorm parameters f32. The mask has no gradient.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pangu_tpu_torch.ops.fused_block_attention import (
    _check,
    _check_kernel_args,
    _geometry,
    dot_f32,
    fused_block_attention_reference,
    layer_norm_f32,
)
from pangu_tpu_torch.ops.fused_mlp import gelu_grad
from pangu_tpu_torch.ops.windows import window_partition, window_reverse

_SOURCE = "fused_block_train.cu"
_LN_EPS = 1e-5

#: A/B switch (the JAX package's name and default): True routes every bf16
#: training block with dropout 0 through K11/K12 (model/blocks.py)
_TRAIN_FUSION = False

#: kernel launches of the forward (K11) and the backward (K12) in this process
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

GRAD_NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias", "dln1_s", "dln1_b",
              "dw1", "db1", "dw2", "db2", "dln2_s", "dln2_b", "ds1", "ds2")


def _per_sample(s: torch.Tensor, b: int) -> torch.Tensor:
    """A (B,) or (B, 1) branch scale as (B, 1, 1, 1, 1) f32."""
    return s.reshape(b, 1, 1, 1, 1).float()


def fused_earth_block_train_reference(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                      ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b, s1, s2,
                                      window: Tuple[int, int, int], heads: int,
                                      scale: float) -> torch.Tensor:
    """Plain PyTorch version of K11, dtype-generic: the XLA composition
    ``_xla_block_train`` with the Pallas body's rounding points in bf16 (the
    GELU hidden rounded after the f32 GELU); f32 in is a true-f32
    computation."""
    dt, b = x.dtype, x.shape[0]
    a = fused_block_attention_reference(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                        window, heads, scale)
    y1 = layer_norm_f32(a.float(), ln1_s.float(), ln1_b.float())
    x1 = (x.float() + _per_sample(s1, b) * y1).to(dt)
    h = F.gelu(dot_f32(x1, w1.t()) + b1.float()).to(dt)
    y2 = layer_norm_f32(dot_f32(h, w2.t()) + b2.float(), ln2_s.float(), ln2_b.float())
    return (x1.float() + _per_sample(s2, b) * y2).to(dt)


def _ln_stats(y: torch.Tensor):
    mu = y.mean(-1, keepdim=True)
    var = (y * y).mean(-1, keepdim=True) - mu * mu
    return mu, torch.rsqrt(var + _LN_EPS)


def _ln_bwd(gb, yhat, r, gamma):
    """LayerNorm backward of the normalized input from gb = dL/d(LN out)."""
    dyhat = gb * gamma
    return r * (dyhat - dyhat.mean(-1, keepdim=True)
                - yhat * (dyhat * yhat).mean(-1, keepdim=True))


def fused_earth_block_train_bwd_reference(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                          ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b,
                                          s1, s2, g, window: Tuple[int, int, int], heads: int,
                                          scale: float):
    """Plain PyTorch version of K12: the Pallas backward body written out
    with its rounding points (not autograd). From ``g`` = dL/dout returns the
    16 gradients of :data:`GRAD_NAMES`: weight and bias grads in nn.Linear's
    layout rounded to their argument's dtype, dbias summed over batch and lon
    windows, the LayerNorm grads in their parameter's dtype, ds1/ds2 per
    sample in the shape and dtype of s1/s2. a and x1 are rounded to x's dtype;
    p stays f32 for dS while its rounded copy feeds P v and dv; dO is rounded
    per head; dy2, dh2, da and dqkv are rounded where they feed a product;
    dx = dqkv Wqkv + dx1 in f32 with one rounding."""
    dt = x.dtype
    b, z, hp, w, c = x.shape
    d = c // heads
    xw = window_partition(x, window)  # (B, nW, nT, T, C)
    gw = window_partition(g, window).float()
    n_w, n_t, t = xw.shape[1:4]
    s1b, s2b = _per_sample(s1, b), _per_sample(s2, b)
    gamma1, gamma2 = ln1_s.float(), ln2_s.float()

    def per_head(y):  # (..., T, C) -> (..., heads, T, d)
        return y.reshape(b, n_w, n_t, t, heads, d).transpose(3, 4)

    def per_token(y):  # (..., heads, T, d) -> (..., T, C)
        return y.transpose(3, 4).reshape(b, n_w, n_t, t, c)

    def rows(y):
        return y.reshape(-1, y.shape[-1])

    def per_sample_sum(y, like):
        return y.reshape(b, -1).sum(1).reshape(like.shape)

    # ---- the forward, recomputed
    qkv = (dot_f32(xw, wqkv.t()) + bqkv.float()).to(dt)
    q, k, v = qkv.reshape(b, n_w, n_t, t, 3, heads, d).permute(4, 0, 1, 2, 5, 3, 6)
    del qkv
    sc = dot_f32(q, k.transpose(-1, -2)) * scale + bias.float()
    if mask is not None:
        sc = sc + mask.float()[:, None]
    p = torch.softmax(sc, dim=-1)  # f32
    del sc
    pw = p.to(dt)
    acc = per_token(dot_f32(pw, v)).to(dt)
    a = (dot_f32(acc, wproj.t()) + bproj.float()).to(dt)
    af = a.float()
    del a
    mu1, r1 = _ln_stats(af)
    yhat1 = (af - mu1) * r1
    del af
    ln1_out = yhat1 * gamma1 + ln1_b.float()
    x1 = (xw.float() + s1b * ln1_out).to(dt)
    h2 = dot_f32(x1, w1.t()) + b1.float()
    act = F.gelu(h2).to(dt)
    y2 = dot_f32(act, w2.t()) + b2.float()
    mu2, r2 = _ln_stats(y2)
    yhat2 = (y2 - mu2) * r2
    del y2

    # ---- the MLP tail
    ds2 = per_sample_sum(gw * (yhat2 * gamma2 + ln2_b.float()), s2)
    gb2 = gw * s2b
    dln2_s, dln2_b = rows(gb2 * yhat2).sum(0), rows(gb2).sum(0)
    dy2 = _ln_bwd(gb2, yhat2, r2, gamma2)
    del gb2, yhat2
    dy2w = dy2.to(dt)
    db2 = rows(dy2).sum(0)
    del dy2
    dw2 = dot_f32(rows(dy2w).t(), rows(act))
    del act
    dh2 = dot_f32(dy2w, w2) * gelu_grad(h2)
    del h2, dy2w
    dh2w = dh2.to(dt)
    db1 = rows(dh2).sum(0)
    del dh2
    dw1 = dot_f32(rows(dh2w).t(), rows(x1))
    dx1 = gw + dot_f32(dh2w, w1)
    del dh2w, x1

    # ---- the attention-side epilogue
    ds1 = per_sample_sum(dx1 * ln1_out, s1)
    gb1 = dx1 * s1b
    dln1_s, dln1_b = rows(gb1 * yhat1).sum(0), rows(gb1).sum(0)
    da = _ln_bwd(gb1, yhat1, r1, gamma1)
    del gb1, yhat1, ln1_out
    daw = da.to(dt)
    dbproj = rows(da).sum(0)
    del da

    # ---- the attention (flash; g := da)
    do = per_head(dot_f32(daw, wproj)).to(dt)
    dwproj = dot_f32(rows(daw).t(), rows(acc))
    del daw, acc
    dp = dot_f32(do, v.transpose(-1, -2))
    dv = dot_f32(pw.transpose(-1, -2), do)
    del pw, do
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    del dp, p
    dbias = ds.sum(dim=(0, 1))
    dsw = ds.to(dt)
    del ds
    dq = dot_f32(dsw, k) * scale
    dk = dot_f32(dsw.transpose(-1, -2), q) * scale
    del dsw
    dqkv = torch.cat([per_token(dq), per_token(dk), per_token(dv)], dim=-1)  # f32
    del dq, dk, dv
    dbqkv = rows(dqkv).sum(0)
    dqkvw = dqkv.to(dt)
    del dqkv
    dwqkv = dot_f32(rows(dqkvw).t(), rows(xw))
    dx = window_reverse((dot_f32(dqkvw, wqkv) + dx1).to(dt), window, z, hp, w)
    return (dx, dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype), dwproj.to(wproj.dtype),
            dbproj.to(bproj.dtype), dbias.to(bias.dtype), dln1_s.to(ln1_s.dtype),
            dln1_b.to(ln1_b.dtype), dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype), dln2_s.to(ln2_s.dtype), dln2_b.to(ln2_b.dtype),
            ds1.to(s1.dtype), ds2.to(s2.dtype))


def _library() -> ctypes.CDLL:
    from pangu_tpu_torch.ops._build import load_library

    lib = load_library(_SOURCE)
    if lib.pangu_block_train_fwd.argtypes is None:
        tail = [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        lib.pangu_block_train_fwd.argtypes = [ctypes.c_void_p] * 19 + tail
        lib.pangu_block_train_fwd.restype = ctypes.c_int
        lib.pangu_block_train_bwd_scratch.argtypes = [ctypes.c_int] * 9
        lib.pangu_block_train_bwd_scratch.restype = ctypes.c_longlong
        lib.pangu_block_train_bwd.argtypes = [ctypes.c_void_p] * 45 + tail
        lib.pangu_block_train_bwd.restype = ctypes.c_int
    return lib


def _check_scales(x, s1, s2) -> None:
    b = x.shape[0]
    for name, s in (("s1", s1), ("s2", s2)):
        if s.numel() != b or s.dim() > 2 or (s.dim() == 2 and s.shape[1] != 1):
            raise ValueError(f"{name} must be ({b},) or ({b}, 1), got {tuple(s.shape)}")
        if s.dtype != torch.float32 or s.device != x.device:
            raise ValueError(f"{name} must be f32 on {x.device}, got {s.dtype} on {s.device}")


def _kernel_scales(name, x, args, s1, s2, window, heads):
    """Raise ValueError on what the kernels do not take (bf16 activations,
    144-token windows, head dim 32, C in (192, 384), hidden 4C, contiguous
    32-byte aligned tensors, a multiple of 64 token rows); return the
    per-sample scales as contiguous (B,) f32."""
    s1c, s2c = s1.reshape(-1).contiguous(), s2.reshape(-1).contiguous()
    _check_kernel_args(name, (x, *args, s1c, s2c), x, window, heads)
    c = x.shape[-1]
    if args[8].shape[0] != 4 * c:
        raise ValueError(f"the CUDA kernel takes an MLP hidden of 4C, got {args[8].shape[0]}")
    return s1c, s2c


def _ptrs(tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def _fwd_launch(x, args, s1, s2, window, heads, scale) -> torch.Tensor:
    global FWD_LAUNCHES
    s1c, s2c = _kernel_scales("fused_earth_block_train", x, args, s1, s2, window, heads)
    geom = _geometry(x, window, heads)
    lib = _library()
    attn = torch.empty_like(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pangu_block_train_fwd(*_ptrs((x, *args, s1c, s2c)), attn.data_ptr(),
                                       out.data_ptr(), *geom, ctypes.c_float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"fused_earth_block_train CUDA launch failed: cudaError_t {rc}")
    FWD_LAUNCHES += 1
    return out


def _bwd_launch(x, args, s1, s2, g, window, heads, scale):
    global BWD_LAUNCHES
    s1c, s2c = _kernel_scales("fused_earth_block_train_bwd", x, (*args, g), s1, s2, window,
                              heads)
    geom = _geometry(x, window, heads)
    lib = _library()
    (wqkv, bqkv, wproj, bproj, bias, mask, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b) = args
    c, dev, dt = x.shape[-1], x.device, x.dtype
    rows = x.numel() // c
    with torch.cuda.device(dev):
        n_scratch = lib.pangu_block_train_bwd_scratch(*geom)
        if n_scratch <= 0:
            raise RuntimeError("fused_earth_block_train_bwd: no scratch size for this shape")
        f32 = torch.float32
        bufs = (*(torch.empty(rows, c, dtype=dt, device=dev) for _ in range(5)),  # acc a x1 dy2 da
                torch.empty(rows, 4 * c, dtype=dt, device=dev),   # GELU(h)
                torch.empty(rows, 4 * c, dtype=dt, device=dev),   # dh
                torch.empty(rows, 3 * c, dtype=dt, device=dev),   # dqkv
                torch.empty(rows, c, dtype=f32, device=dev),      # dx1
                torch.empty(2 * rows, dtype=f32, device=dev),     # ds1, ds2 per row
                torch.empty(n_scratch, dtype=f32, device=dev))
        grads = tuple(torch.empty_like(t) for t in (x, wqkv, bqkv, wproj, bproj, bias, ln1_s,
                                                     ln1_b, w1, b1, w2, b2, ln2_s, ln2_b, s1c, s2c))
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pangu_block_train_bwd(
            *_ptrs((x, g, wqkv, bqkv, wproj, bproj, bias, mask, ln1_s, ln1_b, w1, b1, w2, b2,
                    ln2_s, ln2_b, s1c, s2c)),
            *_ptrs(bufs), *_ptrs(grads), *geom, ctypes.c_float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"fused_earth_block_train_bwd CUDA launch failed: cudaError_t {rc}")
    BWD_LAUNCHES += 1
    return grads[:14] + (grads[14].reshape(s1.shape), grads[15].reshape(s2.shape))


def _check_all(x, args, s1, s2, window, heads) -> None:
    """Raise ValueError on any argument the functions do not take."""
    _check(x, *args, window, heads)
    _check_scales(x, s1, s2)


def fused_earth_block_train_bwd(x, wqkv, bqkv, wproj, bproj, bias, mask: Optional[torch.Tensor],
                                ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b, s1, s2, g,
                                window: Tuple[int, int, int], heads: int, scale: float):
    """K12 from ``g`` = dL/dout: the 16 gradients of :data:`GRAD_NAMES`, as
    :func:`fused_earth_block_train_bwd_reference` returns them."""
    args = (wqkv, bqkv, wproj, bproj, bias, mask, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b)
    _check_all(x, args, s1, s2, window, heads)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must be {tuple(x.shape)} {x.dtype} on {x.device}, "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    if x.device.type == "cpu":
        return fused_earth_block_train_bwd_reference(x, *args, s1, s2, g, window, heads, scale)
    return _bwd_launch(x, args, s1, s2, g, window, heads, scale)


class _BlockTrain(torch.autograd.Function):
    """K11 forward, K12 backward (the plain versions on CPU tensors); saves
    only the inputs."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, bias, mask, ln1_s, ln1_b,
                w1, b1, w2, b2, ln2_s, ln2_b, s1, s2, window, heads, scale):
        args = (wqkv, bqkv, wproj, bproj, bias, mask, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b)
        ctx.statics = (window, heads, scale)
        ctx.save_for_backward(x, *args, s1, s2)
        if x.device.type == "cpu":
            return fused_earth_block_train_reference(x, *args, s1, s2, window, heads, scale)
        return _fwd_launch(x, args, s1, s2, window, heads, scale)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = fused_earth_block_train_bwd(*saved, g.contiguous(), *ctx.statics)
        return grads[:6] + (None,) + grads[6:] + (None, None, None)


def fused_earth_block_train(x, wqkv, bqkv, wproj, bproj, bias, mask: Optional[torch.Tensor],
                            ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b, s1, s2,
                            window: Tuple[int, int, int], heads: int,
                            scale: float) -> torch.Tensor:
    """One Earth-Specific block with stochastic depth, trainable:
    ``x -> x + s1 LN1(attn(x)) -> (+ s2 LN2(MLP(.)))`` on the window-padded
    grid, differentiable in x, every weight, bias and LayerNorm parameter,
    the earth bias and the branch scales (not the mask). See the module
    docstring for the layouts; raises ValueError on any argument the
    functions do not take."""
    args = (wqkv, bqkv, wproj, bproj, bias, mask, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b)
    _check_all(x, args, s1, s2, window, heads)
    return _BlockTrain.apply(x.contiguous(), *args, s1, s2, window, heads, scale)
