"""FuXi's scaled cosine window attention (Swin V2): everything a
``SwinV2Block`` does between its qkv and output projections.

``cosine_window_attention(qkv, scale, bias, order, inverse, labels)`` takes
the block's qkv (B, H, W, 3C) in token order and returns o (B, H, W, C) in
token order. Per window of T places, place i holding token ``order[w T +
i]``, and per head:

    q, k  = temp q / max(|q|, 1e-12), k / max(|k|, 1e-12)   f32 norms, rounded once
    o     = softmax(q k^T + bias[head] + mask) v              f32 scores and softmax

with ``scale`` (2, heads, 1) f32 holding each head's temperature beside k's
1, ``bias`` (1, heads, T, T) and, on a shifted block, the mask -100 between
two places whose region ``labels`` (one int8 a place, in the order's places)
differ, else ``labels`` None. ``inverse`` is the order's inverse (int64),
which the plain version gathers the output back with.

On a CUDA tensor the wrapper launches the hand-written sm_90a kernel of
``csrc/cosine_window_attention.cu`` (built with nvcc at first use; bf16, head
dim 32, T <= 96, or it raises before any launch); on a CPU tensor it runs
:func:`cosine_window_attention_reference`, the chain of PyTorch calls the
block ran before the kernel (SDPA on the gathered windows). There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

_SOURCE = "cosine_window_attention.cu"
#: Swin V2's shift mask value
MASKED = -100.0
#: the attention bias's rows are laid out with a stride of a whole number of
#: these elements, as the memory-efficient attention kernel reads them
_BIAS_ALIGN = 16
#: the kernel's widths: head dim, most places a window
HEAD_DIM, MAX_TOKENS = 32, 96

#: kernel launches by :func:`cosine_window_attention` in this process
LAUNCHES = 0


def _shifted_bias(bias: torch.Tensor, mask: torch.Tensor, batch: int) -> torch.Tensor:
    """(batch * nW, heads, T, T): the block's bias plus the shift mask, its
    rows laid out at an aligned stride (so the attention kernel reads it in
    place)."""
    nw, _, t, _ = mask.shape
    stride = -(-t // _BIAS_ALIGN) * _BIAS_ALIGN
    out = bias.new_empty((batch, nw, bias.shape[1], t, stride))[..., :t]
    torch.add(bias[None].expand(batch, -1, -1, -1, -1), mask[None], out=out)
    return out.flatten(0, 1)


def cosine_(qkv: torch.Tensor, scale: torch.Tensor) -> None:
    """q and k of ``qkv`` (B, N, 3, heads, d) in place: ``temp * q / |q|``
    and ``k / |k|`` (``F.normalize``'s eps), ``scale`` (2, heads, 1) holding
    (temp, 1); the norms and the products in f32, rounded once."""
    qk = qkv[:, :, :2]
    norms = torch.linalg.vector_norm(qk, dim=-1, keepdim=True, dtype=torch.float32)
    qk.mul_(scale / norms.clamp_min(1e-12))


def label_mask(labels: torch.Tensor, tokens: int, dtype: torch.dtype) -> torch.Tensor:
    """(nW, 1, T, T) in ``dtype``: -100 between two places of a window whose
    region labels differ, 0 within one."""
    lab = labels.view(-1, tokens)
    return torch.where(lab[:, :, None] != lab[:, None, :], MASKED, 0.0)[:, None].to(dtype)


def cosine_window_attention_reference(qkv: torch.Tensor, scale: torch.Tensor,
                                      bias: torch.Tensor, order: torch.Tensor,
                                      inverse: torch.Tensor,
                                      labels: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain version: q and k normalized in place in ``qkv`` (which the
    block drops after), the windows gathered, bias + mask as one table,
    ``scaled_dot_product_attention`` and the gather back, in qkv's dtype."""
    b, h, w, c3 = qkv.shape
    heads, tokens = scale.shape[1], bias.shape[-1]
    c, n = c3 // 3, h * w
    cosine_(qkv.view(b, n, 3, heads, c // heads), scale)
    win = qkv.view(b, n, c3).index_select(1, order)
    q, k, v = win.view(-1, tokens, 3, heads, c // heads).permute(2, 0, 3, 1, 4).unbind(0)
    if labels is not None:
        bias = _shifted_bias(bias, label_mask(labels, tokens, bias.dtype), b)
    # softmax(q k^T + bias) v of every window and head: the scale is in q
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0)
    o = o.transpose(1, 2).reshape(b, n, c)
    return o.index_select(1, inverse).view(b, h, w, c)


def _check_kernel_args(qkv, scale, bias, order, labels) -> None:
    """Raise ValueError on what the kernel does not take: bf16 qkv (B, H, W,
    3C) with C = heads x 32, scale (2, heads, 1) f32, bias (1, heads, T, T)
    bf16 with T <= 96 dividing H W, order (H W,) int32, labels (H W,) int8
    or None; every tensor contiguous on qkv's device, qkv 16-byte aligned."""
    if qkv.dim() != 4 or qkv.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bf16 qkv (B, H, W, 3C), got "
                         f"{tuple(qkv.shape)} {qkv.dtype}")
    b, h, w, c3 = qkv.shape
    heads = scale.shape[1] if scale.dim() == 3 else -1
    tokens = bias.shape[-1]
    if c3 != 3 * HEAD_DIM * heads:
        raise ValueError(f"the kernel takes heads of {HEAD_DIM}: qkv's {c3} columns are not "
                         f"3 x {HEAD_DIM} x {heads} heads")
    if not 1 <= tokens <= MAX_TOKENS or (h * w) % tokens:
        raise ValueError(f"the kernel takes windows of at most {MAX_TOKENS} places tiling the "
                         f"{h}x{w} grid, got {tokens}")
    want = {"scale": (scale, (2, heads, 1), torch.float32),
            "bias": (bias, (1, heads, tokens, tokens), torch.bfloat16),
            "order": (order, (h * w,), torch.int32)}
    if labels is not None:
        want["labels"] = (labels, (h * w,), torch.int8)
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    for name, t in (("qkv", qkv), *((n, t) for n, (t, _, _) in want.items())):
        if not t.is_contiguous() or t.device != qkv.device:
            raise ValueError(f"{name} must be contiguous on {qkv.device}")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")


def _library() -> ctypes.CDLL:
    from pangu_tpu_torch.ops._build import load_library

    lib = load_library(_SOURCE)
    fn = lib.fuxi_cosine_window_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(qkv, scale, bias, order, labels) -> torch.Tensor:
    global LAUNCHES
    _check_kernel_args(qkv, scale, bias, order, labels)
    b, h, w, c3 = qkv.shape
    lib = _library()
    out = qkv.new_empty((b, h, w, c3 // 3))
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.fuxi_cosine_window_attention(
            qkv.data_ptr(), scale.data_ptr(), bias.data_ptr(), order.data_ptr(),
            None if labels is None else labels.data_ptr(), out.data_ptr(),
            b, h * w, c3 // 3, scale.shape[1], bias.shape[-1], stream)
    if rc != 0:
        raise RuntimeError(f"cosine_window_attention CUDA launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return out


def cosine_window_attention(qkv: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                            order: torch.Tensor, inverse: torch.Tensor,
                            labels: Optional[torch.Tensor]) -> torch.Tensor:
    """o (B, H, W, C) of the module docstring: the kernel on a CUDA tensor
    (raises ValueError on what it does not take), the plain version on a CPU
    tensor."""
    if qkv.device.type == "cuda":
        return _launch(qkv, scale, bias, order, labels)
    if qkv.device.type != "cpu":
        raise ValueError(f"cosine_window_attention runs on CUDA or CPU tensors, got {qkv.device}")
    return cosine_window_attention_reference(qkv, scale, bias, order, inverse, labels)
