"""The Earth-Specific block megakernel (port of
``pangu_tpu/ops/fused_block_attention.py::fused_earth_block``).

``fused_earth_block`` runs one whole inference block on the (possibly
rolled) window-padded grid ``x`` (B, Z, Hp, W, C):

    x1  = x + LN1(attn(x))                  attention with earth bias (+ shift mask)
    out = x1 + LN2(GELU(x1 @ W1 + b1) @ W2 + b2)

On a CUDA tensor it launches the hand-written sm_90a kernels of
``csrc/fused_earth_block.cu`` (built with nvcc at first use) or raises; on a
CPU tensor it runs :func:`fused_earth_block_reference`, the same function in
plain PyTorch with the Pallas body's rounding points. There is no fallback
from the kernel to the plain version.

Weights use nn.Linear's (out, in) layout, as the block's modules hold them:
wqkv (3C, C), wproj (C, C), w1 (4C, C), w2 (C, 4C); bias (nT, heads, T, T)
and mask (nT, T, T) f32; LayerNorm scale/bias f32. Pad rows of the output
hold values the caller discards (the next block re-zeroes them, the layer
crops them).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pangu_tpu_torch.ops.windows import window_partition, window_reverse

_LN_EPS = 1e-5
_SOURCE = "fused_earth_block.cu"

#: kernel launches by :func:`fused_earth_block` in this process
LAUNCHES = 0


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 products and sums (the f32 accumulation of a bf16
    tensor-core MMA; full f32 for f32 operands when TF32 is off)."""
    return torch.matmul(a.float(), b.float())


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A Dense layer in x's dtype with a torch-layout (out, in) weight: the
    weight rounded to x's dtype, products summed in f32, an f32 bias added,
    one rounding at the end (flax ``nn.Dense(dtype=compute_dtype)``)."""
    y = dot_f32(x, weight.to(x.dtype).t())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def layer_norm_f32(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm of f32 ``y`` over the last axis, variance as E[y^2] - mu^2,
    eps 1e-5 (pangu_tpu/model/blocks.py:58-65)."""
    mu = y.mean(-1, keepdim=True)
    var = (y * y).mean(-1, keepdim=True) - mu * mu
    return (y - mu) * torch.rsqrt(var + _LN_EPS) * scale + bias


def fused_earth_block_reference(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b,
                                window: Tuple[int, int, int], heads: int,
                                scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, dtype-generic: bf16 in rounds
    where the Pallas body rounds (qkv, probabilities, attention output, MLP
    input, GELU hidden; x1 and the final add stay f32); f32 in is a true-f32
    computation."""
    dt = x.dtype
    b, z, hp, w, c = x.shape
    d = c // heads
    xw = window_partition(x, window)  # (B, nW, nT, T, C)
    n_w, n_t, t = xw.shape[1:4]
    qkv = (dot_f32(xw, wqkv.t()) + bqkv.float()).to(dt)
    q, k, v = qkv.reshape(b, n_w, n_t, t, 3, heads, d).permute(4, 0, 1, 2, 5, 3, 6)
    s = dot_f32(q, k.transpose(-1, -2)) * scale  # (B, nW, nT, heads, T, T)
    s = s + bias.float()
    if mask is not None:
        s = s + mask.float()[:, None]
    p = torch.softmax(s, dim=-1).to(dt)
    del s
    a = dot_f32(p, v).to(dt)  # (B, nW, nT, heads, T, d)
    a = window_reverse(a.permute(0, 1, 2, 4, 3, 5).reshape(b, n_w, n_t, t, c),
                       window, z, hp, w)
    x1 = layer_norm_f32(dot_f32(a, wproj.t()) + bproj.float(),
                        ln1_s.float(), ln1_b.float()) + x.float()
    h = F.gelu(dot_f32(x1.to(dt), w1.t()) + b1.float()).to(dt)
    y = layer_norm_f32(dot_f32(h, w2.t()) + b2.float(), ln2_s.float(), ln2_b.float())
    return (x1 + y).to(dt)


def _check(x, wqkv, bqkv, wproj, bproj, bias, mask, ln1_s, ln1_b,
           w1, b1, w2, b2, ln2_s, ln2_b, window, heads) -> None:
    """Raise ValueError on any argument the block function does not take."""
    if x.dim() != 5:
        raise ValueError(f"x must be (B, Z, Hp, W, C), got shape {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    _, z, hp, w, c = x.shape
    wz, wh, ww = window
    if z % wz or hp % wh or w % ww:
        raise ValueError(f"grid {(z, hp, w)} is not a multiple of window {window}")
    if c % heads:
        raise ValueError(f"C={c} is not a multiple of heads={heads}")
    n_t, t = (z // wz) * (hp // wh), wz * wh * ww
    hidden = w1.shape[0] if w1.dim() == 2 else -1
    want = {
        "wqkv": (wqkv, (3 * c, c), x.dtype), "bqkv": (bqkv, (3 * c,), x.dtype),
        "wproj": (wproj, (c, c), x.dtype), "bproj": (bproj, (c,), x.dtype),
        "bias": (bias, (n_t, heads, t, t), torch.float32),
        "ln1_s": (ln1_s, (c,), torch.float32), "ln1_b": (ln1_b, (c,), torch.float32),
        "w1": (w1, (hidden, c), x.dtype), "b1": (b1, (hidden,), x.dtype),
        "w2": (w2, (c, hidden), x.dtype), "b2": (b2, (c,), x.dtype),
        "ln2_s": (ln2_s, (c,), torch.float32), "ln2_b": (ln2_b, (c,), torch.float32),
    }
    if mask is not None:
        want["mask"] = (mask, (n_t, t, t), torch.float32)
    for name, (arr, shape, dtype) in want.items():
        if tuple(arr.shape) != shape or arr.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, "
                             f"got {tuple(arr.shape)} {arr.dtype}")
        if arr.device != x.device:
            raise ValueError(f"{name} is on {arr.device}, x on {x.device}")


def _library() -> ctypes.CDLL:
    from pangu_tpu_torch.ops._build import load_library

    lib = load_library(_SOURCE)
    fn = lib.pangu_fused_earth_block
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _launch(x, wqkv, bqkv, wproj, bproj, bias, mask, ln1_s, ln1_b,
            w1, b1, w2, b2, ln2_s, ln2_b, window, heads, scale) -> torch.Tensor:
    global LAUNCHES
    b, z, hp, w, c = x.shape
    tensors = (x, wqkv, bqkv, wproj, bproj, bias, mask, ln1_s, ln1_b,
               w1, b1, w2, b2, ln2_s, ln2_b)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bfloat16 activations, got {x.dtype}")
    if window[0] * window[1] * window[2] != 144 or c // heads != 32 or c not in (192, 384):
        raise ValueError(f"the CUDA kernel takes 144-token windows, head dim 32 and "
                         f"C in (192, 384); got window {window}, C={c}, heads={heads}")
    if w1.shape[0] != 4 * c:
        raise ValueError(f"the CUDA kernel takes an MLP hidden of 4C, got {w1.shape[0]}")
    for i, t in enumerate(tensors):
        # wmma fragments and 16-byte vector loads need 32-byte aligned bases
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 32):
            raise ValueError(f"argument {i} of fused_earth_block is not contiguous "
                             f"and 32-byte aligned")
    lib = _library()
    attn = torch.empty_like(x)
    out = torch.empty_like(x)
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pangu_fused_earth_block(
            *ptrs, attn.data_ptr(), out.data_ptr(),
            b, z, hp, w, c, heads, *window, ctypes.c_float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"fused_earth_block CUDA launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return out


def fused_earth_block(x, wqkv, bqkv, wproj, bproj, bias, mask: Optional[torch.Tensor],
                      ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b,
                      window: Tuple[int, int, int], heads: int,
                      scale: float) -> torch.Tensor:
    """One Earth-Specific block, fused (inference only). See the module
    docstring for the layouts; raises ValueError on any argument the kernel
    does not take."""
    args = (x, wqkv, bqkv, wproj, bproj, bias, mask, ln1_s, ln1_b,
            w1, b1, w2, b2, ln2_s, ln2_b)
    _check(*args, window, heads)
    if x.device.type == "cpu":
        return fused_earth_block_reference(*args, window, heads, scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_earth_block runs on CUDA or CPU tensors, got {x.device}")
    return _launch(*args, window, heads, scale)
