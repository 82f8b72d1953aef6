"""The MLP of an Earth-Specific block (port of ``pangu_tpu/ops/fused_mlp.py``:
``fused_mlp_postnorm``, ``fused_mlp`` and ``fused_mlp_block``).

``fused_mlp_postnorm(x, w1, b1, w2, b2, ln_scale, ln_bias, branch_scale)``
computes, per token row,

    out = x + s * LayerNorm(GELU(x @ W1^T + b1) @ W2^T + b2)

with ``s`` the per-row stochastic-depth branch scale (mask/keep, ones when
inactive): the hidden rounded to x's dtype after an f32 GELU, the MLP output,
LayerNorm (variance as E[y^2] - mu^2) and residual in f32, one rounding at
the end (K6). Its ``torch.autograd`` backward is K7: the hidden and the MLP
output recomputed, then dx, dW1, db1, dW2, db2, dgamma, dbeta and ds, with
the weight and bias grads rounded to their argument's dtype and ds summed
back to the branch scale's shape.

``fused_mlp(x, w1, b1, w2, b2)`` is the raw MLP, ``GELU(x @ W1^T + b1) @
W2^T + b2`` in x's dtype, the hidden rounded after an f32 GELU and the output
once from f32 (K8). Its backward is K9, the Pallas body's formula: the hidden
h recomputed in f32, ``db2 = sum g``, ``dW2 = g^T a`` with a = GELU(h) in
x's dtype, ``dh = (g W2) GELU'(h)`` with h unrounded, dh rounded for ``dW1 =
dh^T x`` and ``dx = dh W1`` (no residual); the weight and bias grads in
their argument's dtype. It serves the ``_POSTNORM_FUSION = False`` route of
the training block (``model/blocks.py``), which composes K8 with the plain
post-norm residual.

``fused_mlp_block(x, w1, b1, w2, b2, ln_scale, ln_bias)`` is the inference
MLP tail ``x + LN(GELU(x @ W1^T + b1) @ W2^T + b2)``, K6 without the branch
scale (K10). Its backward has no kernel, as in the JAX package: it is the
autograd of :func:`mlp_block_xla`, the twin of the JAX ``_xla_reference``
(which rounds the hidden to x's dtype before the GELU, unlike the kernel).

Weights use nn.Linear's (out, in) layout: w1 (4C, C), w2 (C, 4C).

On a CUDA tensor each direction launches the hand-written sm_90a kernels of
``csrc/fused_mlp.cu`` (built with nvcc at first use) or raises; on a CPU
tensor it runs its plain PyTorch version. There is no fallback from a kernel
to its plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from pangu_tpu_torch.ops.fused_block_attention import dot_f32, layer_norm_f32
from pangu_tpu_torch.ops.fused_epilogue import per_row_scale, scale_grad

_SOURCE = "fused_mlp.cu"
_LN_EPS = 1e-5

#: kernel launches of the forward (K6) and the backward (K7) in this process
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
#: kernel launches of the raw MLP forward (K8) and backward (K9) in this process
RAW_FWD_LAUNCHES = 0
RAW_BWD_LAUNCHES = 0
#: kernel launches of the inference MLP tail (K10) in this process
BLOCK_LAUNCHES = 0

#: A/B switch (the JAX package's name and default): False routes the training
#: block's MLP tail through the raw MLP (K8/K9) and the plain post-norm
#: residual instead of K6/K7 (model/blocks.py)
_POSTNORM_FUSION = True


def gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """d/dh of the exact-erf GELU: Phi(h) + h * phi(h)."""
    return 0.5 * (1.0 + torch.erf(h * math.sqrt(0.5))) + h * torch.exp(-0.5 * h * h) * (
        1.0 / math.sqrt(2.0 * math.pi))


def fused_mlp_postnorm_reference(x, w1, b1, w2, b2, ln_scale, ln_bias, s) -> torch.Tensor:
    """Plain PyTorch version of K6 on rows: x (R, C); s (R,) f32."""
    a = F.gelu(dot_f32(x, w1.t()) + b1.float()).to(x.dtype)
    y = layer_norm_f32(dot_f32(a, w2.t()) + b2.float(), ln_scale.float(), ln_bias.float())
    return (x.float() + s[:, None] * y).to(x.dtype)


def fused_mlp_postnorm_bwd_reference(x, g, w1, b1, w2, b2, ln_scale, ln_bias, s,
                                     dx_dtype=None):
    """Plain PyTorch version of K7 on rows, the Pallas body's formula (not
    autograd): from g = dL/dout (R, C), returns dx (x's dtype, or
    ``dx_dtype``: f32 for the training-block backward K12's unrounded dx1),
    dw1, db1, dw2, db2 (their argument's dtype), dgamma, dbeta (f32, (C,)) and
    ds (f32, (R,)). dy and dh are rounded to x's dtype where they feed a
    product."""
    dt = x.dtype
    gf, gamma = g.float(), ln_scale.float()
    h = dot_f32(x, w1.t()) + b1.float()
    a = F.gelu(h).to(dt)
    y = dot_f32(a, w2.t()) + b2.float()
    mu = y.mean(-1, keepdim=True)
    var = (y * y).mean(-1, keepdim=True) - mu * mu
    r = torch.rsqrt(var + _LN_EPS)
    yhat = (y - mu) * r
    del y
    ds = (gf * (yhat * gamma + ln_bias.float())).sum(-1)
    gb = gf * s[:, None]
    dyhat = gb * gamma
    dy = r * (dyhat - dyhat.mean(-1, keepdim=True)
              - yhat * (dyhat * yhat).mean(-1, keepdim=True))
    dgamma, dbeta = (gb * yhat).sum(0), gb.sum(0)
    del gb, dyhat, yhat
    dyw = dy.to(dt)
    dw2 = dot_f32(dyw.t(), a)
    del a
    dh = dot_f32(dyw, w2) * gelu_grad(h)
    del h
    dhw = dh.to(dt)
    dx = (dot_f32(dhw, w1) + gf).to(dx_dtype or dt)
    dw1 = dot_f32(dhw.t(), x)
    return (dx, dw1.to(w1.dtype), dh.sum(0).to(b1.dtype), dw2.to(w2.dtype),
            dy.sum(0).to(b2.dtype), dgamma, dbeta, ds)


def fused_mlp_reference(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version of K8 on rows: x (R, C)."""
    a = F.gelu(dot_f32(x, w1.t()) + b1.float()).to(x.dtype)
    return (dot_f32(a, w2.t()) + b2.float()).to(x.dtype)


def fused_mlp_bwd_reference(x, g, w1, b1, w2, b2):
    """Plain PyTorch version of K9 on rows, the Pallas body's formula (not
    autograd): from g = dL/dout (R, C), returns dx (x's dtype), dw1, db1, dw2
    and db2 (their argument's dtype). dh is rounded to x's dtype where it
    feeds a product; db1 sums the unrounded dh."""
    dt = x.dtype
    h = dot_f32(x, w1.t()) + b1.float()
    a = F.gelu(h).to(dt)
    dw2 = dot_f32(g.t(), a)
    del a
    dh = dot_f32(g, w2) * gelu_grad(h)
    del h
    dhw = dh.to(dt)
    return (dot_f32(dhw, w1).to(dt), dot_f32(dhw.t(), x).to(w1.dtype), dh.sum(0).to(b1.dtype),
            dw2.to(w2.dtype), g.float().sum(0).to(b2.dtype))


def _library() -> ctypes.CDLL:
    from pangu_tpu_torch.ops._build import load_library

    lib = load_library(_SOURCE)
    if lib.pangu_mlp_postnorm_fwd.argtypes is None:
        tail = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.pangu_mlp_postnorm_fwd.argtypes = [ctypes.c_void_p] * 9 + tail
        lib.pangu_mlp_postnorm_fwd.restype = ctypes.c_int
        lib.pangu_mlp_postnorm_bwd_scratch.argtypes = [ctypes.c_longlong, ctypes.c_int]
        lib.pangu_mlp_postnorm_bwd_scratch.restype = ctypes.c_longlong
        lib.pangu_mlp_postnorm_bwd.argtypes = [ctypes.c_void_p] * 21 + tail
        lib.pangu_mlp_postnorm_bwd.restype = ctypes.c_int
        lib.pangu_mlp_fwd.argtypes = [ctypes.c_void_p] * 6 + tail
        lib.pangu_mlp_fwd.restype = ctypes.c_int
        lib.pangu_mlp_bwd_scratch.argtypes = [ctypes.c_longlong, ctypes.c_int]
        lib.pangu_mlp_bwd_scratch.restype = ctypes.c_longlong
        lib.pangu_mlp_bwd.argtypes = [ctypes.c_void_p] * 13 + tail
        lib.pangu_mlp_bwd.restype = ctypes.c_int
        lib.pangu_mlp_block_fwd.argtypes = [ctypes.c_void_p] * 8 + tail
        lib.pangu_mlp_block_fwd.restype = ctypes.c_int
    return lib


def _check_kernel_args(name: str, x, w1, bf16s, f32s) -> None:
    """Raise ValueError on what the CUDA kernels do not take: bf16 rows and
    weights with C in (192, 384), hidden 4C and a multiple of 48 rows (the
    wgmma kernels mask their last 64-row tile); f32 LayerNorm parameters and
    scales; all contiguous and 16-byte aligned."""
    rows, c = x.shape
    if any(t.dtype != torch.bfloat16 for t in bf16s):
        raise ValueError(f"the CUDA kernel takes bfloat16 rows and weights, got {x.dtype}")
    if c not in (192, 384) or w1.shape[0] != 4 * c or rows % 48:
        raise ValueError(f"the CUDA kernel takes C in (192, 384), hidden 4C and a multiple "
                         f"of 48 rows; got C={c}, hidden {w1.shape[0]}, {rows} rows")
    if any(t.dtype != torch.float32 for t in f32s):
        raise ValueError("the CUDA kernel takes f32 LayerNorm parameters and branch scales")
    for i, t in enumerate(bf16s + f32s):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"argument {i} of {name} is not contiguous and 16-byte aligned")


def _fwd_launch(x, w1, b1, w2, b2, ln_scale, ln_bias, s) -> torch.Tensor:
    global FWD_LAUNCHES
    tensors = (x, w1, b1, w2, b2, ln_scale, ln_bias, s)
    _check_kernel_args("fused_mlp_postnorm", x, w1, tensors[:5], tensors[5:])
    lib = _library()
    rows, c = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pangu_mlp_postnorm_fwd(*[t.data_ptr() for t in tensors], out.data_ptr(),
                                        rows, c, stream)
    if rc != 0:
        raise RuntimeError(f"fused_mlp_postnorm CUDA launch failed: cudaError_t {rc}")
    FWD_LAUNCHES += 1
    return out


def _bwd_launch(x, g, w1, b1, w2, b2, ln_scale, ln_bias, s):
    global BWD_LAUNCHES
    tensors = (x, g, w1, b1, w2, b2, ln_scale, ln_bias, s)
    _check_kernel_args("fused_mlp_postnorm_bwd", x, w1, tensors[:6], tensors[6:])
    lib = _library()
    rows, c = x.shape
    dev = x.device
    with torch.cuda.device(dev):
        n_scratch = lib.pangu_mlp_postnorm_bwd_scratch(rows, c)
        if n_scratch <= 0:
            raise RuntimeError("fused_mlp_postnorm_bwd: no scratch size for this shape")
        bufs = (torch.empty_like(x), torch.empty(rows, 4 * c, dtype=x.dtype, device=dev),
                torch.empty(rows, 4 * c, dtype=x.dtype, device=dev),
                torch.empty(n_scratch, dtype=torch.float32, device=dev))
        grads = (torch.empty_like(x), torch.empty_like(w1), torch.empty_like(b1),
                 torch.empty_like(w2), torch.empty_like(b2),
                 torch.empty(c, dtype=torch.float32, device=dev),
                 torch.empty(c, dtype=torch.float32, device=dev),
                 torch.empty(rows, dtype=torch.float32, device=dev))
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pangu_mlp_postnorm_bwd(*[t.data_ptr() for t in tensors + bufs + grads],
                                        rows, c, stream)
    if rc != 0:
        raise RuntimeError(f"fused_mlp_postnorm_bwd CUDA launch failed: cudaError_t {rc}")
    BWD_LAUNCHES += 1
    return grads


def _check(x, w1, b1, w2, b2, ln_scale, ln_bias) -> None:
    """Raise ValueError on any argument the functions do not take (x rows)."""
    _check_raw(x, w1, b1, w2, b2)
    c = x.shape[-1]
    for name, t in (("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be ({c},), got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def fused_mlp_postnorm_bwd(x, g, w1, b1, w2, b2, ln_scale, ln_bias, s):
    """K7 on rows, from ``g`` = dL/dout (R, C): (dx, dw1, db1, dw2, db2,
    dgamma, dbeta, ds), as :func:`fused_mlp_postnorm_bwd_reference` returns
    them."""
    _check(x, w1, b1, w2, b2, ln_scale, ln_bias)
    if g.shape != x.shape or g.dtype != x.dtype or tuple(s.shape) != (x.shape[0],):
        raise ValueError(f"g must be {tuple(x.shape)} {x.dtype} and s ({x.shape[0]},); got "
                         f"{tuple(g.shape)} {g.dtype}, {tuple(s.shape)}")
    if x.device.type == "cpu":
        return fused_mlp_postnorm_bwd_reference(x, g, w1, b1, w2, b2, ln_scale, ln_bias, s)
    return _bwd_launch(x, g, w1, b1, w2, b2, ln_scale, ln_bias, s)


class _MlpPostnorm(torch.autograd.Function):
    """K6 forward, K7 backward (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ln_scale, ln_bias, branch_scale):
        shape = x.shape
        s = per_row_scale(shape, branch_scale)
        x2 = x.reshape(s.shape[0], shape[-1])
        ctx.save_for_backward(x2, w1, b1, w2, b2, ln_scale, ln_bias, s, branch_scale)
        ctx.shape = shape
        if x.device.type == "cpu":
            out = fused_mlp_postnorm_reference(x2, w1, b1, w2, b2, ln_scale, ln_bias, s)
        else:
            out = _fwd_launch(x2, w1, b1, w2, b2, ln_scale, ln_bias, s)
        return out.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        x2, w1, b1, w2, b2, ln_scale, ln_bias, s, branch_scale = ctx.saved_tensors
        dx, dw1, db1, dw2, db2, dgamma, dbeta, ds = fused_mlp_postnorm_bwd(
            x2, g.reshape(x2.shape).contiguous(), w1, b1, w2, b2, ln_scale, ln_bias, s)
        return (dx.reshape(ctx.shape), dw1, db1, dw2, db2, dgamma.to(ln_scale.dtype),
                dbeta.to(ln_bias.dtype), scale_grad(ds, ctx.shape, branch_scale))


def fused_mlp_postnorm(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                       b2: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                       branch_scale: torch.Tensor) -> torch.Tensor:
    """(..., C) -> x + branch_scale * LN(GELU(x @ w1^T + b1) @ w2^T + b2), in
    x's dtype, differentiable in x, the weights, the biases, the LayerNorm
    parameters and the branch scale.

    ``branch_scale`` broadcasts to x.shape[:-1] + (1,), f32 (the per-sample
    stochastic-depth factor as (B, 1, ..., 1)). Raises ValueError on
    arguments the function does not take."""
    c = x.shape[-1]
    _check(x.reshape(-1, c), w1, b1, w2, b2, ln_scale, ln_bias)
    if branch_scale.device != x.device:
        raise ValueError(f"branch_scale is on {branch_scale.device}, x on {x.device}")
    try:
        torch.broadcast_shapes(branch_scale.shape, x.shape[:-1] + (1,))
    except RuntimeError as e:
        raise ValueError(f"branch_scale {tuple(branch_scale.shape)} does not broadcast "
                         f"to {tuple(x.shape[:-1]) + (1,)}") from e
    return _MlpPostnorm.apply(x.contiguous(), w1, b1, w2, b2, ln_scale, ln_bias, branch_scale)


# ---- K8 / K9: the raw MLP ----------------------------------------------------------


def _raw_fwd_launch(x, w1, b1, w2, b2) -> torch.Tensor:
    global RAW_FWD_LAUNCHES
    tensors = (x, w1, b1, w2, b2)
    _check_kernel_args("fused_mlp", x, w1, tensors, ())
    lib = _library()
    rows, c = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pangu_mlp_fwd(*[t.data_ptr() for t in tensors], out.data_ptr(), rows, c, stream)
    if rc != 0:
        raise RuntimeError(f"fused_mlp CUDA launch failed: cudaError_t {rc}")
    RAW_FWD_LAUNCHES += 1
    return out


def _raw_bwd_launch(x, g, w1, b1, w2, b2):
    global RAW_BWD_LAUNCHES
    tensors = (x, g, w1, b1, w2)
    _check_kernel_args("fused_mlp_bwd", x, w1, tensors + (b2,), ())
    lib = _library()
    rows, c = x.shape
    dev = x.device
    with torch.cuda.device(dev):
        n_scratch = lib.pangu_mlp_bwd_scratch(rows, c)
        if n_scratch <= 0:
            raise RuntimeError("fused_mlp_bwd: no scratch size for this shape")
        bufs = (torch.empty(rows, 4 * c, dtype=x.dtype, device=dev),
                torch.empty(rows, 4 * c, dtype=x.dtype, device=dev),
                torch.empty(n_scratch, dtype=torch.float32, device=dev))
        grads = (torch.empty_like(x), torch.empty_like(w1), torch.empty_like(b1),
                 torch.empty_like(w2), torch.empty_like(b2))
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pangu_mlp_bwd(*[t.data_ptr() for t in tensors + bufs + grads], rows, c, stream)
    if rc != 0:
        raise RuntimeError(f"fused_mlp_bwd CUDA launch failed: cudaError_t {rc}")
    RAW_BWD_LAUNCHES += 1
    return grads


def _check_raw(x, w1, b1, w2, b2) -> None:
    """Raise ValueError on any MLP argument the functions do not take (x
    rows; the weights in x's dtype)."""
    if x.dim() != 2:
        raise ValueError(f"x must be (R, C), got {tuple(x.shape)}")
    c, hidden = x.shape[-1], w1.shape[0]
    want = {"w1": (w1, (hidden, c)), "b1": (b1, (hidden,)), "w2": (w2, (c, hidden)),
            "b2": (b2, (c,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, x {x.dtype} on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the MLP kernels run on CUDA or CPU tensors, got {x.device}")


def fused_mlp_bwd(x, g, w1, b1, w2, b2):
    """K9 on rows, from ``g`` = dL/dout (R, C): (dx, dw1, db1, dw2, db2), as
    :func:`fused_mlp_bwd_reference` returns them."""
    _check_raw(x, w1, b1, w2, b2)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must be {tuple(x.shape)} {x.dtype} on {x.device}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    if x.device.type == "cpu":
        return fused_mlp_bwd_reference(x, g, w1, b1, w2, b2)
    return _raw_bwd_launch(x, g, w1, b1, w2, b2)


class _Mlp(torch.autograd.Function):
    """K8 forward, K9 backward (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        ctx.save_for_backward(x2, w1, b1, w2, b2)
        ctx.shape = shape
        if x.device.type == "cpu":
            out = fused_mlp_reference(x2, w1, b1, w2, b2)
        else:
            out = _raw_fwd_launch(x2, w1, b1, w2, b2)
        return out.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        x2, w1, b1, w2, b2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = fused_mlp_bwd(x2, g.reshape(x2.shape).contiguous(),
                                               w1, b1, w2, b2)
        return dx.reshape(ctx.shape), dw1, db1, dw2, db2


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """(..., C) -> GELU(x @ w1^T + b1) @ w2^T + b2 in x's dtype, differentiable
    in x, the weights and the biases. Raises ValueError on arguments the
    function does not take."""
    _check_raw(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2)
    return _Mlp.apply(x.contiguous(), w1, b1, w2, b2)


# ---- K10: the inference MLP tail -----------------------------------------------------


def fused_mlp_block_reference(x, w1, b1, w2, b2, ln_scale, ln_bias) -> torch.Tensor:
    """Plain PyTorch version of K10 on rows (the Pallas body's rounding
    points: the hidden rounded to x's dtype after an f32 GELU; the MLP output,
    LayerNorm and residual in f32, one rounding at the end)."""
    a = F.gelu(dot_f32(x, w1.t()) + b1.float()).to(x.dtype)
    y = layer_norm_f32(dot_f32(a, w2.t()) + b2.float(), ln_scale.float(), ln_bias.float())
    return (x.float() + y).to(x.dtype)


def mlp_block_xla(x, w1, b1, w2, b2, ln_scale, ln_bias) -> torch.Tensor:
    """The JAX package's ``_xla_reference`` of K10 on rows, whose autograd is
    K10's backward: the pre-activation rounded to x's dtype, then the GELU."""
    h = F.gelu((dot_f32(x, w1.t()) + b1.float()).to(x.dtype))
    y = layer_norm_f32(dot_f32(h, w2.t()) + b2.float(), ln_scale.float(), ln_bias.float())
    return (y + x.float()).to(x.dtype)


def _block_launch(x, w1, b1, w2, b2, ln_scale, ln_bias) -> torch.Tensor:
    global BLOCK_LAUNCHES
    tensors = (x, w1, b1, w2, b2, ln_scale, ln_bias)
    _check_kernel_args("fused_mlp_block", x, w1, tensors[:5], tensors[5:])
    lib = _library()
    rows, c = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pangu_mlp_block_fwd(*[t.data_ptr() for t in tensors], out.data_ptr(),
                                     rows, c, stream)
    if rc != 0:
        raise RuntimeError(f"fused_mlp_block CUDA launch failed: cudaError_t {rc}")
    BLOCK_LAUNCHES += 1
    return out


class _MlpBlock(torch.autograd.Function):
    """K10 forward (the plain version on CPU tensors); the backward is the
    autograd of :func:`mlp_block_xla`, as the JAX ``_bwd`` is its vjp."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ln_scale, ln_bias):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        ctx.save_for_backward(x2, w1, b1, w2, b2, ln_scale, ln_bias)
        ctx.shape = shape
        if x.device.type == "cpu":
            out = fused_mlp_block_reference(x2, w1, b1, w2, b2, ln_scale, ln_bias)
        else:
            out = _block_launch(x2, w1, b1, w2, b2, ln_scale, ln_bias)
        return out.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = mlp_block_xla(*ins)
            grads = torch.autograd.grad(out, ins, g.reshape(out.shape))
        return (grads[0].reshape(ctx.shape), *grads[1:])


def fused_mlp_block(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, ln_scale: torch.Tensor,
                    ln_bias: torch.Tensor) -> torch.Tensor:
    """(..., C) -> x + LN(GELU(x @ w1^T + b1) @ w2^T + b2) in x's dtype (K10),
    differentiable in x, the weights, the biases and the LayerNorm
    parameters. Raises ValueError on arguments the function does not take."""
    _check(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2, ln_scale, ln_bias)
    return _MlpBlock.apply(x.contiguous(), w1, b1, w2, b2, ln_scale, ln_bias)
