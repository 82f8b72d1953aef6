"""The post-norm residual of the attention sublayer in training (port of
``pangu_tpu/ops/fused_epilogue.py``).

``fused_residual_postnorm(shortcut, a, ln_scale, ln_bias, branch_scale)``
computes, per token row,

    out = shortcut + s * LayerNorm(a)

with ``s`` the per-row stochastic-depth branch scale (mask/keep, ones when
inactive), f32 inside and rounded once to shortcut's dtype (K4). Its
``torch.autograd`` backward is K5: da, dgamma, dbeta and ds with the
LayerNorm statistics recomputed from ``a`` (variance as E[a^2] - mu^2);
dshortcut is the incoming gradient itself, and ds is summed back to the
branch scale's shape.

On a CUDA tensor each direction launches the hand-written sm_90a kernel of
``csrc/fused_epilogue.cu`` (built with nvcc at first use) or raises; on a
CPU tensor it runs its plain PyTorch version. There is no fallback from a
kernel to its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from pangu_tpu_torch.ops.fused_block_attention import layer_norm_f32

_SOURCE = "fused_epilogue.cu"
_LN_EPS = 1e-5

#: kernel launches of the forward (K4) and the backward (K5) in this process
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


def fused_residual_postnorm_reference(shortcut, a, ln_scale, ln_bias, s) -> torch.Tensor:
    """Plain PyTorch version of K4 on rows: shortcut, a (R, C); s (R,) f32."""
    y = layer_norm_f32(a.float(), ln_scale.float(), ln_bias.float())
    return (shortcut.float() + s[:, None] * y).to(shortcut.dtype)


def fused_residual_postnorm_bwd_reference(a, g, ln_scale, ln_bias, s):
    """Plain PyTorch version of K5 on rows, the Pallas body's formula: from
    g = dL/dout (R, C), returns da (a's dtype), dgamma and dbeta (f32, (C,))
    and ds (f32, (R,))."""
    af, gf = a.float(), g.float()
    gamma = ln_scale.float()
    mu = af.mean(-1, keepdim=True)
    var = (af * af).mean(-1, keepdim=True) - mu * mu
    r = torch.rsqrt(var + _LN_EPS)
    yhat = (af - mu) * r
    ds = (gf * (yhat * gamma + ln_bias.float())).sum(-1)
    gb = gf * s[:, None]
    dyhat = gb * gamma
    da = r * (dyhat - dyhat.mean(-1, keepdim=True)
              - yhat * (dyhat * yhat).mean(-1, keepdim=True))
    return da.to(a.dtype), (gb * yhat).sum(0), gb.sum(0), ds


def _library() -> ctypes.CDLL:
    from pangu_tpu_torch.ops._build import load_library

    lib = load_library(_SOURCE)
    if lib.pangu_residual_postnorm_fwd.argtypes is None:
        lib.pangu_residual_postnorm_fwd.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        lib.pangu_residual_postnorm_fwd.restype = ctypes.c_int
        lib.pangu_residual_postnorm_bwd_scratch.argtypes = [ctypes.c_int]
        lib.pangu_residual_postnorm_bwd_scratch.restype = ctypes.c_longlong
        lib.pangu_residual_postnorm_bwd.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        lib.pangu_residual_postnorm_bwd.restype = ctypes.c_int
    return lib


def _check_kernel_args(name: str, tensors, c: int) -> None:
    """Raise ValueError on what the CUDA kernels do not take: bf16 rows with C
    in (192, 384), f32 LayerNorm parameters and scales, all contiguous with
    4-byte aligned bf16 pairs."""
    if tensors[0].dtype != torch.bfloat16 or tensors[1].dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bfloat16 rows, got {tensors[0].dtype}")
    if c not in (192, 384):
        raise ValueError(f"the CUDA kernel takes C in (192, 384), got {c}")
    if any(t.dtype != torch.float32 for t in tensors[2:]):
        raise ValueError("the CUDA kernel takes f32 LayerNorm parameters and branch scales")
    for i, t in enumerate(tensors):
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"argument {i} of {name} is not contiguous and 4-byte aligned")


def _fwd_launch(shortcut, a, ln_scale, ln_bias, s) -> torch.Tensor:
    global FWD_LAUNCHES
    rows, c = a.shape
    tensors = (shortcut, a, ln_scale, ln_bias, s)
    _check_kernel_args("fused_residual_postnorm", tensors, c)
    lib = _library()
    out = torch.empty_like(shortcut)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.pangu_residual_postnorm_fwd(*[t.data_ptr() for t in tensors], out.data_ptr(),
                                             rows, c, stream)
    if rc != 0:
        raise RuntimeError(f"fused_residual_postnorm CUDA launch failed: cudaError_t {rc}")
    FWD_LAUNCHES += 1
    return out


def _bwd_launch(a, g, ln_scale, ln_bias, s):
    global BWD_LAUNCHES
    rows, c = a.shape
    tensors = (a, g, ln_scale, ln_bias, s)
    _check_kernel_args("fused_residual_postnorm_bwd", tensors, c)
    lib = _library()
    da = torch.empty_like(a)
    ds = torch.empty(rows, dtype=torch.float32, device=a.device)
    scratch = torch.empty(lib.pangu_residual_postnorm_bwd_scratch(c), dtype=torch.float32,
                          device=a.device)
    dgamma = torch.empty(c, dtype=torch.float32, device=a.device)
    dbeta = torch.empty_like(dgamma)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.pangu_residual_postnorm_bwd(
            *[t.data_ptr() for t in tensors], da.data_ptr(), ds.data_ptr(), scratch.data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr(), rows, c, stream)
    if rc != 0:
        raise RuntimeError(f"fused_residual_postnorm_bwd CUDA launch failed: cudaError_t {rc}")
    BWD_LAUNCHES += 1
    return da, dgamma, dbeta, ds


def fused_residual_postnorm_bwd(a, g, ln_scale, ln_bias, s):
    """K5 on rows, from ``g`` = dL/dout (R, C): (da, dgamma, dbeta, ds), as
    :func:`fused_residual_postnorm_bwd_reference` returns them."""
    rows, c = a.shape
    if g.shape != a.shape or tuple(s.shape) != (rows,) or tuple(ln_scale.shape) != (c,) \
            or tuple(ln_bias.shape) != (c,):
        raise ValueError(f"a, g (R, C), s (R,), ln_scale, ln_bias (C,): got {tuple(a.shape)}, "
                         f"{tuple(g.shape)}, {tuple(s.shape)}, {tuple(ln_scale.shape)}, "
                         f"{tuple(ln_bias.shape)}")
    if a.device.type == "cpu":
        return fused_residual_postnorm_bwd_reference(a, g, ln_scale, ln_bias, s)
    return _bwd_launch(a, g, ln_scale, ln_bias, s)


def per_row_scale(shape, branch_scale) -> torch.Tensor:
    """The branch scale as one contiguous f32 per row of a (..., C) tensor."""
    rows = 1
    for n in shape[:-1]:
        rows *= n
    return branch_scale.float().expand(*shape[:-1], 1).reshape(rows).contiguous()


def scale_grad(ds: torch.Tensor, shape, branch_scale: torch.Tensor) -> torch.Tensor:
    """The per-row grad ``ds`` of :func:`per_row_scale` summed back to the
    branch scale's shape and dtype."""
    bshape = tuple(shape[:-1]) + (1,)
    ds = ds.reshape(bshape)
    lead = len(bshape) - branch_scale.dim()
    axes = tuple(range(lead)) + tuple(
        i for i in range(lead, len(bshape))
        if branch_scale.shape[i - lead] == 1 and bshape[i] != 1)
    if axes:
        ds = ds.sum(dim=axes, keepdim=True)
    return ds.reshape(branch_scale.shape).to(branch_scale.dtype)


class _ResidualPostnorm(torch.autograd.Function):
    """K4 forward, K5 backward (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, shortcut, a, ln_scale, ln_bias, branch_scale):
        shape = a.shape
        s = per_row_scale(shape, branch_scale)
        a2, sh2 = a.reshape(s.shape[0], shape[-1]), shortcut.reshape(s.shape[0], shape[-1])
        ctx.save_for_backward(a2, ln_scale, ln_bias, s, branch_scale)
        ctx.shape = shape
        if a.device.type == "cpu":
            out = fused_residual_postnorm_reference(sh2, a2, ln_scale, ln_bias, s)
        else:
            out = _fwd_launch(sh2, a2, ln_scale, ln_bias, s)
        return out.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        a2, ln_scale, ln_bias, s, branch_scale = ctx.saved_tensors
        da, dgamma, dbeta, ds = fused_residual_postnorm_bwd(
            a2, g.reshape(a2.shape).contiguous(), ln_scale, ln_bias, s)
        return (g, da.reshape(ctx.shape), dgamma.to(ln_scale.dtype), dbeta.to(ln_bias.dtype),
                scale_grad(ds, ctx.shape, branch_scale))


def fused_residual_postnorm(shortcut: torch.Tensor, a: torch.Tensor, ln_scale: torch.Tensor,
                            ln_bias: torch.Tensor, branch_scale: torch.Tensor) -> torch.Tensor:
    """(..., C) -> shortcut + branch_scale * LN(a), in shortcut's dtype.

    ``branch_scale`` broadcasts to a.shape[:-1] + (1,), f32 (the per-sample
    stochastic-depth factor as (B, 1, ..., 1)). Raises ValueError on
    arguments the function does not take."""
    if shortcut.shape != a.shape or shortcut.dtype != a.dtype:
        raise ValueError(f"shortcut {tuple(shortcut.shape)} {shortcut.dtype} and "
                         f"a {tuple(a.shape)} {a.dtype} must match")
    c = a.shape[-1]
    for name, t in (("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be ({c},), got {tuple(t.shape)}")
    for t in (shortcut, ln_scale, ln_bias, branch_scale):
        if t.device != a.device:
            raise ValueError(f"argument on {t.device}, a on {a.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_residual_postnorm runs on CUDA or CPU tensors, got {a.device}")
    try:
        torch.broadcast_shapes(branch_scale.shape, a.shape[:-1] + (1,))
    except RuntimeError as e:
        raise ValueError(f"branch_scale {tuple(branch_scale.shape)} does not broadcast "
                         f"to {tuple(a.shape[:-1]) + (1,)}") from e
    return _ResidualPostnorm.apply(shortcut.contiguous(), a.contiguous(), ln_scale, ln_bias,
                                   branch_scale)
