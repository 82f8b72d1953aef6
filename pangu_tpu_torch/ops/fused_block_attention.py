"""The Earth-Specific block kernels (port of
``pangu_tpu/ops/fused_block_attention.py``).

``fused_earth_block`` (K1) runs one whole inference block on the
window-padded grid ``x`` (B, Z, Hp, W, C):

    x1  = x + LN1(attn(x))                  attention with earth bias (+ shift mask)
    out = x1 + LN2(GELU(x1 @ W1 + b1) @ W2 + b2)

Given the block's ``shift`` (sz, sh, sw) and its real lat rows ``h``, it
runs that block on ``x`` as it stands: the attention sees ``x`` with its
rows >= h zeroed and rolled by -shift, and the result comes back un-rolled,
the real rows the bits of re-zero, ``torch.roll``, the call without them and
the roll back. On the card the kernel folds both into the window gather
(``FOLDED_LAUNCHES``): no pass over the grid. On the CPU the operator runs
that route written out (:func:`fused_earth_block_folded_reference`).

``fused_block_attention`` (K2) is the attention sublayer alone for
training, ``y = attn(x) @ Wproj^T + bproj``, with a ``torch.autograd``
backward that is the flash backward K3 (scores recomputed per window, never
stored): dx, dWqkv, dbqkv, dWproj, dbproj and dbias. Given ``ln_scale`` and
``ln_bias`` it is the LN-epilogue mode ``y = x + LN1(attn(x) @ Wproj^T +
bproj)`` (the first kernel of the two-kernel inference block); its backward
has no kernel, as in the JAX package: the autograd of
:func:`attention_xla_reference`, the twin of the JAX ``_xla_reference``.

``dense`` is the model's Dense product, ``x W^T + b`` with f32 sums, the f32
bias and one rounding: on bf16 CUDA operands the operator
``pangu_tpu_torch::dense`` (the kernel of ``csrc/outer_dense.cu``, with an
autograd formula whose backward runs on the card too), on anything else the
plain formula ``dense_reference``.

On a CUDA tensor each launches the hand-written sm_90a kernels of
``csrc/fused_earth_block.cu`` or ``csrc/block_attention.cu`` (built with nvcc
at first use) or raises; on a CPU tensor it runs its plain PyTorch version
(``*_reference``) with the Pallas bodies' rounding points. There is no
fallback from a kernel to its plain version. K1 goes through the operator
``pangu_tpu_torch::fused_earth_block`` on both devices (CUDA: the kernel;
CPU: the plain version; a fake implementation for ``torch.export``), so an
exported forecast step calls it as the eager step does.

Weights use nn.Linear's (out, in) layout, as the block's modules hold them:
wqkv (3C, C), wproj (C, C), w1 (4C, C), w2 (C, 4C); bias (nT, heads, T, T)
and mask (nT, T, T) f32; LayerNorm scale/bias f32. Pad rows of the output
hold values the caller discards (the next block reads them as zeros, the
layer crops them).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from pangu_tpu_torch.ops.windows import window_partition, window_reverse

_LN_EPS = 1e-5
_SOURCE = "fused_earth_block.cu"
_TRAIN_SOURCE = "block_attention.cu"
_DENSE_SOURCE = "outer_dense.cu"

#: kernel launches by :func:`fused_earth_block` (K1) in this process
LAUNCHES = 0
#: those of them that folded a shift or pad rows into the window gather
FOLDED_LAUNCHES = 0
#: launches of the training attention forward (K2) and backward (K3)
ATTN_FWD_LAUNCHES = 0
ATTN_BWD_LAUNCHES = 0
#: launches of K2's LN-epilogue mode
ATTN_LN_LAUNCHES = 0
#: launches of the Dense product (:func:`dense` on the card) and of its backward
DENSE_LAUNCHES = 0
DENSE_BWD_LAUNCHES = 0


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 products and sums (the f32 accumulation of a bf16
    tensor-core MMA; full f32 for f32 operands when TF32 is off)."""
    return torch.matmul(a.float(), b.float())


def dense_reference(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A Dense layer in x's dtype with a torch-layout (out, in) weight: the
    weight rounded to x's dtype, products summed in f32, an f32 bias added,
    one rounding at the end (flax ``nn.Dense(dtype=compute_dtype)``). The
    plain formula of :func:`dense`."""
    y = dot_f32(x, weight.to(x.dtype).t())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`dense_reference`'s function. bf16 ``x`` on the card takes the
    operator ``pangu_tpu_torch::dense`` (``csrc/outer_dense.cu``: the same
    f32 sums of the exact bf16 products in another order, the f32 bias, one
    rounding; its backward on the same product); every other input, f32 or
    on the CPU, the plain formula."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        y = DENSE_OP(x.reshape(-1, x.shape[-1]), weight.to(x.dtype).contiguous(),
                     None if bias is None else bias.float())
        return y.view(*x.shape[:-1], y.shape[-1])
    return dense_reference(x, weight, bias)


def layer_norm_f32(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm of f32 ``y`` over the last axis, variance as E[y^2] - mu^2,
    eps 1e-5 (pangu_tpu/model/blocks.py:58-65)."""
    mu = y.mean(-1, keepdim=True)
    var = (y * y).mean(-1, keepdim=True) - mu * mu
    return (y - mu) * torch.rsqrt(var + _LN_EPS) * scale + bias


def window_attention_reference(x, wqkv, bqkv, bias, mask, window: Tuple[int, int, int],
                               heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale + bias (+ mask)) @ v per window and head, back
    on the grid (B, Z, Hp, W, C) in x's dtype: the attention output before
    the projection, rounded where the Pallas body rounds (qkv, the
    probabilities, the output)."""
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
    return window_reverse(a.permute(0, 1, 2, 4, 3, 5).reshape(b, n_w, n_t, t, c),
                          window, z, hp, w)


def fused_earth_block_reference(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b,
                                window: Tuple[int, int, int], heads: int,
                                scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, dtype-generic: bf16 in rounds
    where the Pallas body rounds (qkv, probabilities, attention output, MLP
    input, GELU hidden; x1 and the final add stay f32); f32 in is a true-f32
    computation."""
    dt = x.dtype
    a = window_attention_reference(x, wqkv, bqkv, bias, mask, window, heads, scale)
    x1 = layer_norm_f32(dot_f32(a, wproj.t()) + bproj.float(),
                        ln1_s.float(), ln1_b.float()) + x.float()
    h = F.gelu(dot_f32(x1.to(dt), w1.t()) + b1.float()).to(dt)
    y = layer_norm_f32(dot_f32(h, w2.t()) + b2.float(), ln2_s.float(), ln2_b.float())
    return (x1 + y).to(dt)


def fused_earth_block_folded_reference(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                       ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b,
                                       window: Tuple[int, int, int], heads: int, scale: float,
                                       shift: Sequence[int], h: int) -> torch.Tensor:
    """K1 with a shift and real rows, written out as the block's unfolded
    route: rows >= ``h`` re-zeroed, ``torch.roll`` by -``shift``,
    :func:`fused_earth_block_reference`, the roll back."""
    hp = x.shape[2]
    if h < hp:
        x = F.pad(x[:, :, :h], (0, 0, 0, 0, 0, hp - h))
    if any(shift):
        x = torch.roll(x, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
    out = fused_earth_block_reference(x, wqkv, bqkv, wproj, bproj, bias, mask, ln1_s, ln1_b,
                                      w1, b1, w2, b2, ln2_s, ln2_b, window, heads, scale)
    if any(shift):
        out = torch.roll(out, shifts=tuple(shift), dims=(1, 2, 3))
    return out


def fused_block_attention_reference(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                    window: Tuple[int, int, int], heads: int,
                                    scale: float, ln_scale=None, ln_bias=None) -> torch.Tensor:
    """Plain PyTorch version of K2, dtype-generic: the attention output
    projected, ``attn(x) @ Wproj^T + bproj``, rounded once at the end; with
    ``ln_scale``/``ln_bias`` the projection, ``x + LN(.)`` in f32, then the
    one rounding."""
    a = window_attention_reference(x, wqkv, bqkv, bias, mask, window, heads, scale)
    if ln_scale is None:
        return dense_reference(a, wproj, bproj)
    y = layer_norm_f32(dot_f32(a, wproj.t()) + bproj.float(), ln_scale.float(), ln_bias.float())
    return (x.float() + y).to(x.dtype)


def attention_xla_reference(x, wqkv, bqkv, wproj, bproj, bias, mask,
                            window: Tuple[int, int, int], heads: int, scale: float,
                            ln_scale=None, ln_bias=None) -> torch.Tensor:
    """The JAX package's ``_xla_reference`` of K2 (q scaled in x's dtype
    before the scores; qkv, the probabilities and the attention output
    rounded to x's dtype), differentiable by autograd: the backward of the
    LN-epilogue mode."""
    dt = x.dtype
    b, z, hp, w, c = x.shape
    d = c // heads
    xw = window_partition(x, window)
    n_w, n_t, t = xw.shape[1:4]
    qkv = (dot_f32(xw, wqkv.t()) + bqkv.float()).to(dt)
    q, k, v = qkv.reshape(b, n_w, n_t, t, 3, heads, d).permute(4, 0, 1, 2, 5, 3, 6)
    s = dot_f32(q * scale, k.transpose(-1, -2)) + bias.float()
    if mask is not None:
        s = s + mask.float()[:, None]
    p = torch.softmax(s, dim=-1).to(dt)
    a = dot_f32(p, v).to(dt).permute(0, 1, 2, 4, 3, 5).reshape(b, n_w, n_t, t, c)
    y = dot_f32(a, wproj.t()) + bproj.float()
    if ln_scale is not None:
        y = layer_norm_f32(y, ln_scale.float(), ln_bias.float()) + xw.float()
    return window_reverse(y.to(dt), window, z, hp, w)


def fused_block_attention_bwd_reference(x, wqkv, bqkv, wproj, bias, mask, g,
                                        window: Tuple[int, int, int], heads: int,
                                        scale: float, round_grads: bool = True,
                                        dx_addend: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K3: the flash backward of K2 written out with
    the Pallas body's rounding points (q|k|v, the probabilities, dO, dS and
    dq|dk|dv in x's dtype; p, dP and every sum f32), not autograd. ``g`` is
    dL/dy. Returns (dx, dwqkv, dbqkv, dwproj, dbproj, dbias): weight grads in
    nn.Linear's layout, rounded to their argument's dtype (dbproj to wproj's,
    as the Pallas wrapper does; f32 with ``round_grads`` False, as the
    attention-backward A/B variants return them), dbias f32 summed over batch
    and lon windows. ``dx_addend`` (x's shape, f32) is added to dqkv Wqkv
    before dx's one rounding, as the training-block backward K12 adds dx1."""
    dt = x.dtype
    b, z, hp, w, c = x.shape
    d = c // heads
    xw = window_partition(x, window)  # (B, nW, nT, T, C)
    gw = window_partition(g, window)
    n_w, n_t, t = xw.shape[1:4]

    def per_head(y):  # (..., T, C) -> (..., heads, T, d)
        return y.reshape(b, n_w, n_t, t, heads, d).transpose(3, 4)

    def per_token(y):  # (..., heads, T, d) -> (..., T, C)
        return y.transpose(3, 4).reshape(b, n_w, n_t, t, c)

    def rows(y):
        return y.reshape(-1, y.shape[-1])

    qkv = (dot_f32(xw, wqkv.t()) + bqkv.float()).to(dt)
    q, k, v = qkv.reshape(b, n_w, n_t, t, 3, heads, d).permute(4, 0, 1, 2, 5, 3, 6)
    s = dot_f32(q, k.transpose(-1, -2)) * scale + bias.float()
    if mask is not None:
        s = s + mask.float()[:, None]
    p = torch.softmax(s, dim=-1)  # f32
    del s
    pw = p.to(dt)
    do = per_head(dot_f32(gw, wproj)).to(dt)  # dO = g @ Wproj, rounded per head
    acc = per_token(dot_f32(pw, v)).to(dt)
    dp = dot_f32(do, v.transpose(-1, -2))
    dv = dot_f32(pw.transpose(-1, -2), do)
    del pw
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    del dp, p
    dbias = ds.sum(dim=(0, 1))
    dsw = ds.to(dt)
    del ds
    dq = dot_f32(dsw, k) * scale
    dk = dot_f32(dsw.transpose(-1, -2), q) * scale
    del dsw
    dqkv = torch.cat([per_token(dq), per_token(dk), per_token(dv)], dim=-1)  # f32
    dbqkv = dqkv.sum(dim=(0, 1, 2, 3))
    dqkv = dqkv.to(dt)
    dx = dot_f32(dqkv, wqkv)
    if dx_addend is not None:
        dx = dx + window_partition(dx_addend, window).float()
    dx = window_reverse(dx.to(dt), window, z, hp, w)
    dwqkv = dot_f32(rows(dqkv).t(), rows(xw))
    dwproj = dot_f32(rows(gw).t(), rows(acc))
    dbproj = rows(gw).float().sum(0)
    if not round_grads:
        return dx, dwqkv, dbqkv, dwproj, dbproj, dbias
    return (dx, dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype), dwproj.to(wproj.dtype),
            dbproj.to(wproj.dtype), dbias)


def _check_tensors(x, want) -> None:
    for name, (arr, shape, dtype) in want.items():
        if tuple(arr.shape) != shape or arr.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, "
                             f"got {tuple(arr.shape)} {arr.dtype}")
        if arr.device != x.device:
            raise ValueError(f"{name} is on {arr.device}, x on {x.device}")


def _check_attention(x, wqkv, bqkv, wproj, bproj, bias, mask, window, heads) -> None:
    """Raise ValueError on any attention argument the functions do not take
    (``bproj`` None: the backward, which does not read it)."""
    if x.dim() != 5:
        raise ValueError(f"x must be (B, Z, Hp, W, C), got shape {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the block kernels run on CUDA or CPU tensors, got {x.device}")
    _, z, hp, w, c = x.shape
    wz, wh, ww = window
    if z % wz or hp % wh or w % ww:
        raise ValueError(f"grid {(z, hp, w)} is not a multiple of window {window}")
    if c % heads:
        raise ValueError(f"C={c} is not a multiple of heads={heads}")
    n_t, t = (z // wz) * (hp // wh), wz * wh * ww
    want = {
        "wqkv": (wqkv, (3 * c, c), x.dtype), "bqkv": (bqkv, (3 * c,), x.dtype),
        "wproj": (wproj, (c, c), x.dtype), "bias": (bias, (n_t, heads, t, t), torch.float32),
    }
    if bproj is not None:
        want["bproj"] = (bproj, (c,), x.dtype)
    if mask is not None:
        want["mask"] = (mask, (n_t, t, t), torch.float32)
    _check_tensors(x, want)


def _check(x, wqkv, bqkv, wproj, bproj, bias, mask, ln1_s, ln1_b,
           w1, b1, w2, b2, ln2_s, ln2_b, window, heads) -> None:
    """Raise ValueError on any argument the block function does not take."""
    _check_attention(x, wqkv, bqkv, wproj, bproj, bias, mask, window, heads)
    c = x.shape[-1]
    hidden = w1.shape[0] if w1.dim() == 2 else -1
    _check_tensors(x, {
        "ln1_s": (ln1_s, (c,), torch.float32), "ln1_b": (ln1_b, (c,), torch.float32),
        "w1": (w1, (hidden, c), x.dtype), "b1": (b1, (hidden,), x.dtype),
        "w2": (w2, (c, hidden), x.dtype), "b2": (b2, (c,), x.dtype),
        "ln2_s": (ln2_s, (c,), torch.float32), "ln2_b": (ln2_b, (c,), torch.float32),
    })


def _check_kernel_args(name: str, tensors, x, window, heads) -> None:
    """Raise ValueError on what the CUDA kernels do not take: bf16 activations,
    144-token windows, head dim 32, C in (192, 384), and contiguous 32-byte
    aligned tensors (wmma fragments and 16-byte vector loads)."""
    c = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bfloat16 activations, got {x.dtype}")
    if window[0] * window[1] * window[2] != 144 or c // heads != 32 or c not in (192, 384):
        raise ValueError(f"the CUDA kernel takes 144-token windows, head dim 32 and "
                         f"C in (192, 384); got window {window}, C={c}, heads={heads}")
    for i, t in enumerate(tensors):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 32):
            raise ValueError(f"argument {i} of {name} is not contiguous and 32-byte aligned")
        if t is not None and t.device != x.device:
            raise ValueError(f"argument {i} of {name} is on {t.device}, x on {x.device}")


def _library() -> ctypes.CDLL:
    from pangu_tpu_torch.ops._build import load_library

    lib = load_library(_SOURCE)
    fn = lib.pangu_fused_earth_block
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 13
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _launch(x, wqkv, bqkv, wproj, bproj, bias, mask, ln1_s, ln1_b,
            w1, b1, w2, b2, ln2_s, ln2_b, window, heads, scale, shift, h) -> torch.Tensor:
    global LAUNCHES, FOLDED_LAUNCHES
    b, z, hp, w, c = x.shape
    tensors = (x, wqkv, bqkv, wproj, bproj, bias, mask, ln1_s, ln1_b,
               w1, b1, w2, b2, ln2_s, ln2_b)
    _check_kernel_args("fused_earth_block", tensors, x, window, heads)
    if w1.shape[0] != 4 * c:
        raise ValueError(f"the CUDA kernel takes an MLP hidden of 4C, got {w1.shape[0]}")
    lib = _library()
    attn = torch.empty_like(x)
    out = torch.empty_like(x)
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pangu_fused_earth_block(
            *ptrs, attn.data_ptr(), out.data_ptr(),
            b, z, hp, w, c, heads, *window, *shift, h,
            ctypes.c_float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"fused_earth_block CUDA launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    FOLDED_LAUNCHES += int(any(shift) or h < hp)
    return out


#: K1 as one operator of the port's namespace, so that ``torch.export`` traces
#: the block as a single call (through the fake implementation) and the exported
#: program runs the same kernel as the eager model: the CUDA implementation is the
#: hand-written kernel (``_launch``, where the pointer, alignment and device checks run),
#: the CPU implementation its plain version (the unfolded route written out).
#: ``shift`` (0, 0, 0) and ``h`` Hp are a call without a fold.
_LIB = torch.library.Library("pangu_tpu_torch", "DEF")
_LIB.define(
    "fused_earth_block(Tensor x, Tensor wqkv, Tensor bqkv, Tensor wproj, Tensor bproj, "
    "Tensor bias, Tensor? mask, Tensor ln1_s, Tensor ln1_b, Tensor w1, Tensor b1, "
    "Tensor w2, Tensor b2, Tensor ln2_s, Tensor ln2_b, int[] window, int heads, "
    "float scale, int[] shift, int h) -> Tensor")
_LIB.impl("fused_earth_block", _launch, "CUDA")
_LIB.impl("fused_earth_block", fused_earth_block_folded_reference, "CPU")


@torch.library.register_fake("pangu_tpu_torch::fused_earth_block")
def _fused_earth_block_fake(x, *args) -> torch.Tensor:
    return torch.empty_like(x)


#: the operator (``torch.ops.pangu_tpu_torch.fused_earth_block.default``)
FUSED_EARTH_BLOCK_OP = torch.ops.pangu_tpu_torch.fused_earth_block.default


def fused_earth_block(x, wqkv, bqkv, wproj, bproj, bias, mask: Optional[torch.Tensor],
                      ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b,
                      window: Tuple[int, int, int], heads: int, scale: float,
                      shift: Sequence[int] = (0, 0, 0), h: Optional[int] = None) -> torch.Tensor:
    """One Earth-Specific block, fused (inference only): one call of the
    operator ``pangu_tpu_torch::fused_earth_block`` on every device. With
    ``shift`` (each in [0, its window dim)) and ``h`` (real lat rows; left
    out: all Hp) the block runs on ``x`` as it stands, see the module
    docstring, which also gives the layouts; raises ValueError on any
    argument the kernel does not take."""
    args = (x, wqkv, bqkv, wproj, bproj, bias, mask, ln1_s, ln1_b,
            w1, b1, w2, b2, ln2_s, ln2_b)
    shift, h = [int(s) for s in shift], int(x.shape[2] if h is None else h)
    _check(*args, window, heads)
    if len(shift) != 3 or any(not 0 <= s < k for s, k in zip(shift, window)):
        raise ValueError(f"shift must be 3 ints, each in [0, its window dim {tuple(window)}), "
                         f"got {tuple(shift)}")
    if not 1 <= h <= x.shape[2]:
        raise ValueError(f"h must lie in [1, Hp={x.shape[2]}], got {h}")
    return FUSED_EARTH_BLOCK_OP(*args, list(window), heads, float(scale), shift, h)


# ---- the Dense product ---------------------------------------------------------


def _dense_library() -> ctypes.CDLL:
    from pangu_tpu_torch.ops._build import load_library

    lib = load_library(_DENSE_SOURCE)
    if lib.pangu_outer_dense.argtypes is None:
        lib.pangu_outer_dense.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.pangu_outer_dense.restype = ctypes.c_int
        lib.pangu_outer_dense_bwd_scratch.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                                      ctypes.c_int]
        lib.pangu_outer_dense_bwd_scratch.restype = ctypes.c_longlong
        lib.pangu_outer_dense_bwd.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 6
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.pangu_outer_dense_bwd.restype = ctypes.c_int
    return lib


def _check_dense_args(x, weight, bias) -> None:
    """Raise ValueError on what the Dense kernel does not take: a (rows, k)
    ``x`` with a contiguous inner dimension and a row stride that is a
    multiple of 8, a contiguous (n, k) weight of x's dtype, bf16, k and n
    multiples of 8, an (n,) f32 bias or none, 16-byte aligned CUDA tensors on
    x's device (the TMA maps and the paired loads and stores)."""
    if x.dim() != 2 or weight.dim() != 2 or weight.shape[1] != x.shape[1]:
        raise ValueError(f"the Dense kernel takes x (rows, k) and weight (n, k), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if x.dtype != torch.bfloat16 or weight.dtype != x.dtype:
        raise ValueError(f"the Dense kernel takes a bfloat16 x and weight, got {x.dtype} and "
                         f"{weight.dtype}")
    n, k = weight.shape
    if bias is not None and (tuple(bias.shape) != (n,) or bias.dtype != torch.float32):
        raise ValueError(f"bias must be ({n},) float32, got {tuple(bias.shape)} {bias.dtype}")
    if k % 8 or n % 8:
        raise ValueError(f"the Dense kernel takes k and n multiples of 8, got k={k}, n={n}")
    if x.stride(1) != 1 or not weight.is_contiguous():
        raise ValueError("the Dense kernel takes x with a contiguous inner dimension and a "
                         "contiguous weight")
    if x.stride(0) % 8 or x.stride(0) < k:
        raise ValueError(f"the Dense kernel takes a row stride of x that is a multiple of 8 "
                         f"and at least k={k}, got {x.stride(0)}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
        if t is not None and (t.device.type != "cuda" or t.device != x.device):
            raise ValueError(f"the Dense kernel takes CUDA tensors on one device, got "
                             f"{name} on {t.device}")


def _dense_launch(x, weight, bias) -> torch.Tensor:
    global DENSE_LAUNCHES
    _check_dense_args(x, weight, bias)
    rows, (n, k) = x.shape[0], weight.shape
    out = torch.empty(rows, n, dtype=x.dtype, device=x.device)
    lib = _dense_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pangu_outer_dense(x.data_ptr(), x.stride(0), weight.data_ptr(),
                                   None if bias is None else bias.data_ptr(), out.data_ptr(),
                                   rows, n, k, stream)
    if rc != 0:
        raise RuntimeError(f"dense CUDA launch failed: cudaError_t {rc}")
    DENSE_LAUNCHES += 1
    return out


def _dense_bwd_launch(x, weight, dy, need_dx: bool, need_dw: bool, need_db: bool):
    """(dx, dW, db) of the Dense kernel from dy = dL/dy, each None where it
    is not needed."""
    global DENSE_BWD_LAUNCHES
    _check_dense_args(x, weight, None)
    rows, (n, k) = x.shape[0], weight.shape
    if (tuple(dy.shape) != (rows, n) or dy.dtype != x.dtype or not dy.is_contiguous()
            or dy.data_ptr() % 16 or dy.device != x.device):
        raise ValueError(f"dy must be a contiguous 16-byte aligned ({rows}, {n}) {x.dtype} "
                         f"tensor on {x.device}, got {tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if need_db and n > 2048:
        raise ValueError(f"the Dense kernel's bias gradient takes n <= 2048, got {n}")
    dx = torch.empty(rows, k, dtype=x.dtype, device=x.device) if need_dx else None
    dw = torch.empty_like(weight) if need_dw else None
    db = torch.empty(n, dtype=torch.float32, device=x.device) if need_db else None
    lib = _dense_library()
    scratch = torch.empty(lib.pangu_outer_dense_bwd_scratch(rows, n, k), dtype=torch.float32,
                          device=x.device)
    ptr = [None if t is None else t.data_ptr() for t in (dx, dw, db)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pangu_outer_dense_bwd(x.data_ptr(), x.stride(0), weight.data_ptr(),
                                       dy.data_ptr(), *ptr, scratch.data_ptr(), rows, n, k,
                                       stream)
    if rc != 0:
        raise RuntimeError(f"dense backward CUDA launch failed: cudaError_t {rc}")
    DENSE_BWD_LAUNCHES += 1
    return dx, dw, db


#: the Dense product as one operator of the port's namespace: ``torch.export``
#: traces it as one call (the fake implementation), the CUDA implementation is
#: the kernel (``_dense_launch``, where its checks run), the CPU implementation
#: the plain formula. x (rows, k) and weight (n, k) of one dtype, bias (n,) f32.
_LIB.define("dense(Tensor x, Tensor weight, Tensor? bias) -> Tensor")
_LIB.impl("dense", _dense_launch, "CUDA")
_LIB.impl("dense", dense_reference, "CPU")


@torch.library.register_fake("pangu_tpu_torch::dense")
def _dense_fake(x, weight, bias) -> torch.Tensor:
    return x.new_empty(x.shape[0], weight.shape[0])


def _dense_setup(ctx, inputs, output) -> None:
    x, weight, bias = inputs
    ctx.has_bias = bias is not None
    ctx.save_for_backward(x, weight, bias)


def _dense_backward(ctx, dy):
    """dx = dy W and dW = dy^T x rounded once to x's dtype, db the f32 sum of
    dy over the rows: on the card the kernel's backward (each only where its
    input needs it), on the CPU the autograd of the plain formula."""
    x, weight, bias = ctx.saved_tensors
    if dy.is_cuda:
        need_x, need_w, need_b = ctx.needs_input_grad
        return _dense_bwd_launch(x, weight, dy.contiguous(), need_x, need_w,
                                 need_b and ctx.has_bias)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, weight, bias) if t is not None]
        grads = list(torch.autograd.grad(dense_reference(*ins), ins, dy))
    return grads[0], grads[1], grads[2] if ctx.has_bias else None


torch.library.register_autograd("pangu_tpu_torch::dense", _dense_backward,
                                setup_context=_dense_setup)

#: the operator (``torch.ops.pangu_tpu_torch.dense.default``)
DENSE_OP = torch.ops.pangu_tpu_torch.dense.default


# ---- K2 / K3: the training attention and its flash backward --------------------


def _train_library() -> ctypes.CDLL:
    from pangu_tpu_torch.ops._build import load_library

    lib = load_library(_TRAIN_SOURCE)
    if lib.pangu_block_attention_fwd.argtypes is None:
        ints = [ctypes.c_int] * 9
        lib.pangu_block_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 9 + ints + [ctypes.c_float, ctypes.c_void_p])
        lib.pangu_block_attention_fwd.restype = ctypes.c_int
        lib.pangu_block_attention_bwd_scratch.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                                          ctypes.c_int]
        lib.pangu_block_attention_bwd_scratch.restype = ctypes.c_longlong
        lib.pangu_block_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 16 + ints + [ctypes.c_float, ctypes.c_void_p])
        lib.pangu_block_attention_bwd.restype = ctypes.c_int
        lib.pangu_block_attention_ln_fwd.argtypes = (
            [ctypes.c_void_p] * 11 + ints + [ctypes.c_float, ctypes.c_void_p])
        lib.pangu_block_attention_ln_fwd.restype = ctypes.c_int
    return lib


def _geometry(x, window, heads):
    b, z, hp, w, c = x.shape
    if (b * z * hp * w) % 64:
        raise ValueError(f"the CUDA kernels take a multiple of 64 token rows, got {b * z * hp * w}")
    return (b, z, hp, w, c, heads, *window)


def _attention_fwd_launch(x, wqkv, bqkv, wproj, bproj, bias, mask, window, heads, scale):
    global ATTN_FWD_LAUNCHES
    tensors = (x, wqkv, bqkv, wproj, bproj, bias, mask)
    _check_kernel_args("fused_block_attention", tensors, x, window, heads)
    geom = _geometry(x, window, heads)
    lib = _train_library()
    attn = torch.empty_like(x)
    out = torch.empty_like(x)
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pangu_block_attention_fwd(*ptrs, attn.data_ptr(), out.data_ptr(), *geom,
                                           ctypes.c_float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"fused_block_attention CUDA launch failed: cudaError_t {rc}")
    ATTN_FWD_LAUNCHES += 1
    return out


def _attention_ln_launch(x, wqkv, bqkv, wproj, bproj, bias, mask, ln_scale, ln_bias,
                         window, heads, scale):
    global ATTN_LN_LAUNCHES
    tensors = (x, wqkv, bqkv, wproj, bproj, bias, mask, ln_scale, ln_bias)
    _check_kernel_args("fused_block_attention (LN epilogue)", tensors, x, window, heads)
    geom = _geometry(x, window, heads)
    lib = _train_library()
    attn = torch.empty_like(x)
    out = torch.empty_like(x)
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pangu_block_attention_ln_fwd(*ptrs, attn.data_ptr(), out.data_ptr(), *geom,
                                              ctypes.c_float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"fused_block_attention (LN epilogue) CUDA launch failed: "
                           f"cudaError_t {rc}")
    ATTN_LN_LAUNCHES += 1
    return out


def _attention_bwd_launch(x, wqkv, bqkv, wproj, bias, mask, g, window, heads, scale):
    global ATTN_BWD_LAUNCHES
    tensors = (x, g, wqkv, bqkv, wproj, bias, mask)
    _check_kernel_args("fused_block_attention_bwd", tensors, x, window, heads)
    geom = _geometry(x, window, heads)
    lib = _train_library()
    c = x.shape[-1]
    rows = x.numel() // c
    n_types = bias.shape[0]
    dqkv = torch.empty(rows, 3 * c, dtype=x.dtype, device=x.device)
    acc = torch.empty(rows, c, dtype=x.dtype, device=x.device)
    scratch = torch.empty(lib.pangu_block_attention_bwd_scratch(rows, c, n_types),
                          dtype=torch.float32, device=x.device)
    grads = (torch.empty_like(x), torch.empty_like(wqkv), torch.empty_like(bqkv),
             torch.empty_like(wproj), torch.empty(c, dtype=wproj.dtype, device=x.device),
             torch.empty_like(bias))
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pangu_block_attention_bwd(*ptrs, dqkv.data_ptr(), acc.data_ptr(),
                                           scratch.data_ptr(), *[t.data_ptr() for t in grads],
                                           *geom, ctypes.c_float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"fused_block_attention_bwd CUDA launch failed: cudaError_t {rc}")
    ATTN_BWD_LAUNCHES += 1
    return grads


def fused_block_attention_bwd(x, wqkv, bqkv, wproj, bias, mask: Optional[torch.Tensor], g,
                              window: Tuple[int, int, int], heads: int, scale: float):
    """K3, the backward of :func:`fused_block_attention` from ``g`` = dL/dy:
    (dx, dwqkv, dbqkv, dwproj, dbproj, dbias), as
    :func:`fused_block_attention_bwd_reference` returns them."""
    _check_attention(x, wqkv, bqkv, wproj, None, bias, mask, window, heads)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must be {tuple(x.shape)} {x.dtype} on {x.device}, "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    if x.device.type == "cpu":
        return fused_block_attention_bwd_reference(x, wqkv, bqkv, wproj, bias, mask, g,
                                                   window, heads, scale)
    return _attention_bwd_launch(x, wqkv, bqkv, wproj, bias, mask, g, window, heads, scale)


class _BlockAttention(torch.autograd.Function):
    """K2 forward, K3 backward (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, bias, mask, window, heads, scale):
        ctx.statics = (window, heads, scale)
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bias, mask)
        if x.device.type == "cpu":
            return fused_block_attention_reference(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                                   window, heads, scale)
        return _attention_fwd_launch(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                     window, heads, scale)

    @staticmethod
    def backward(ctx, g):
        x, wqkv, bqkv, wproj, bias, mask = ctx.saved_tensors
        grads = fused_block_attention_bwd(x, wqkv, bqkv, wproj, bias, mask, g.contiguous(),
                                          *ctx.statics)
        return (*grads, None, None, None, None)


class _BlockAttentionLN(torch.autograd.Function):
    """K2's LN-epilogue mode forward (the plain version on CPU tensors); the
    backward is the autograd of :func:`attention_xla_reference`, as the JAX
    ``_bwd`` is its vjp."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, bias, mask, ln_scale, ln_bias, window, heads,
                scale):
        ctx.statics = (window, heads, scale)
        ctx.mask = mask
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bproj, bias, ln_scale, ln_bias)
        if x.device.type == "cpu":
            return fused_block_attention_reference(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                                   window, heads, scale, ln_scale, ln_bias)
        return _attention_ln_launch(x, wqkv, bqkv, wproj, bproj, bias, mask, ln_scale, ln_bias,
                                    window, heads, scale)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            x, wqkv, bqkv, wproj, bproj, bias, ln_scale, ln_bias = ins
            out = attention_xla_reference(x, wqkv, bqkv, wproj, bproj, bias, ctx.mask,
                                          *ctx.statics, ln_scale, ln_bias)
            grads = torch.autograd.grad(out, ins, g)
        return (*grads[:6], None, *grads[6:], None, None, None)


def fused_block_attention(x, wqkv, bqkv, wproj, bproj, bias, mask: Optional[torch.Tensor],
                          ln_scale, ln_bias, window: Tuple[int, int, int], heads: int,
                          scale: float) -> torch.Tensor:
    """The attention sublayer (K2), ``attn(x) @ Wproj^T + bproj`` on the
    grid, differentiable in x, the weights, the biases and the earth bias
    through the flash backward K3 (the mask is not differentiable). With
    ``ln_scale``/``ln_bias`` (C,) f32 the LN-epilogue mode ``x + LN(.)``,
    differentiable in the LayerNorm parameters too."""
    _check_attention(x, wqkv, bqkv, wproj, bproj, bias, mask, window, heads)
    if ln_scale is None and ln_bias is None:
        return _BlockAttention.apply(x, wqkv, bqkv, wproj, bproj, bias, mask, window, heads,
                                     scale)
    c = x.shape[-1]
    if ln_scale is None or ln_bias is None:
        raise ValueError("the LN epilogue needs both ln_scale and ln_bias")
    _check_tensors(x, {"ln_scale": (ln_scale, (c,), torch.float32),
                       "ln_bias": (ln_bias, (c,), torch.float32)})
    return _BlockAttentionLN.apply(x, wqkv, bqkv, wproj, bproj, bias, mask, ln_scale, ln_bias,
                                   window, heads, scale)
