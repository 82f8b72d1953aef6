"""Tensor-core micro-benchmark of head-dim-32 score products on one CUDA card
(port of ``scripts/bench_mxu_micro.py``, whose subject is the TPU's matrix
unit; here it is the H100's tensor cores).

    python -m pangu_tpu_torch.scripts.bench_mxu_micro [variant ...]

The attention scores contract over head dim 32. Per window (T = 144 tokens,
6 heads, C = 192) each variant sums score products q k^T of its heads into one
(144, 144) f32 tile, over the ``REPS`` windows of a seeded qkv (REPS, T, 3C):

* ``loop``: per head, 32-deep (the shipped kernels' schedule);
* ``blockdiag``: two 4-head packs, heads 0-3 and 2-5 (the Pallas body reuses
  heads 2-5), the packed q lanes (T, 128) against a block-diagonal K' (128,
  4T), the four blocks summed;
* ``qblockdiag``: the same packs with a block-diagonal Q' (4T, 128) against
  the packed k lanes;
* ``loop_int8``: ``loop`` on int8 q, k, each window-head product exact in
  int32, converted to f32 and summed.

A call of :func:`mxu_micro` repeats the sweep over the windows ``sweeps``
times on the card (the CUDA kernel of ``csrc/bench_mxu_micro.cu``; its plain
PyTorch version on a CPU tensor) and returns the sum. Reported per sweep: the
kernel's ms (a call of ``SWEEPS`` sweeps over their count), microseconds per
window, TFLOP/s (TOP/s for int8) of the issued products (the packed variants
issue their zero blocks: 5.33x ``loop``), the plain version's ms at one
sweep, the call's bound over its sweeps (from the products the result needs:
one 32-deep product per summed head, 6 for ``loop``, 8 for the packs), and
``library_ms``, the time of the one PyTorch call that computes one sweep's sum
(:func:`library_call`: ``torch.einsum`` over the variant's heads, or
``torch._int_mm`` for ``loop_int8``; a yardstick, never the path). The timed
call itself (its split and repeat) is held against ``sweeps`` x the plain
version too.
One JSON line per variant, then ``{"mxu_micro": {...}, "device_kind": ...}``.
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import Dict, Sequence

import numpy as np
import torch

from pangu_tpu_torch.ops.fused_block_attention import dot_f32
from pangu_tpu_torch.scripts.ab_common import (PEAK_BF16, PEAK_INT8, bound, cuda_device,
                                               cuda_times_ms, emit, max_rel)

T, D, H = 144, 32, 6
C = H * D
REPS = 64  # windows of the input
SWEEPS = 256  # sweeps of a timed call
SPLIT = 4  # CTAs per window when sweeps allow
VARIANTS = ("loop", "blockdiag", "qblockdiag", "loop_int8")
#: the heads each variant sums, in order (the packs reuse heads 2-5)
HEADS = {"loop": tuple(range(H)), "blockdiag": (0, 1, 2, 3, 2, 3, 4, 5),
         "qblockdiag": (0, 1, 2, 3, 2, 3, 4, 5), "loop_int8": tuple(range(H))}
#: kernel launches per variant in this process
LAUNCHES: Dict[str, int] = dict.fromkeys(VARIANTS, 0)
#: max|d| / max|ref| against the plain version: bf16 sums differ only in order;
#: int8 products are exact and, at one sweep, every f32 partial sum is an
#: integer below 2^24, so the sums are exact too
TOL = {"loop": 1e-4, "blockdiag": 1e-4, "qblockdiag": 1e-4, "loop_int8": 1e-6}
#: the same at ``SWEEPS`` sweeps: there the f32 sums of every variant pass 2^24
#: and round, so all four are held to the bf16 bound
SWEEPS_TOL = 1e-4


def check_variant(name: str) -> None:
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; choose from {VARIANTS}")


def make_inputs(device, seed: int = 0):
    """The JAX script's draws: qkv (REPS, T, 3C) standard normal in bf16, then
    int8 in [-127, 127), from one ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((REPS, T, 3 * C)).astype(np.float32)
    qkv8 = rng.integers(-127, 127, (REPS, T, 3 * C)).astype(np.int8)
    return (torch.from_numpy(qkv).to(device=device, dtype=torch.bfloat16),
            torch.from_numpy(qkv8).to(device))


def issued_ops(variant: str, windows: int, sweeps: int = 1) -> int:
    """Operations of the products the variant issues (2 per multiply-add),
    the packs' zero blocks included."""
    if variant in ("blockdiag", "qblockdiag"):
        return windows * sweeps * 2 * 2 * T * (4 * T) * (4 * D)
    return windows * sweeps * H * 2 * T * T * D


def needed_ops(variant: str, windows: int, sweeps: int = 1) -> int:
    """Operations of the products the result needs: one (T, 32) x (32, T)
    product per summed head (2 per multiply-add)."""
    return windows * sweeps * len(HEADS[variant]) * 2 * T * T * D


def mxu_bound(variant: str, windows: int, sweeps: int = 1) -> dict:
    """Bound of one call of ``sweeps`` sweeps: the needed products at the
    bf16 or int8 peak, or one read of the window data and the f32 tile
    written."""
    esize = 1 if variant == "loop_int8" else 2
    return bound(needed_ops(variant, windows, sweeps), windows * T * 3 * C * esize + T * T * 4,
                 PEAK_INT8 if variant == "loop_int8" else PEAK_BF16)


def _check(variant: str, qkv: torch.Tensor, sweeps: int) -> None:
    check_variant(variant)
    want = torch.int8 if variant == "loop_int8" else torch.bfloat16
    if qkv.dim() != 3 or tuple(qkv.shape[1:]) != (T, 3 * C) or qkv.dtype != want:
        raise ValueError(f"{variant} takes qkv (windows, {T}, {3 * C}) {want}, got "
                         f"{tuple(qkv.shape)} {qkv.dtype}")
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")


def mxu_micro_reference(variant: str, qkv: torch.Tensor, sweeps: int = 1) -> torch.Tensor:
    """Plain PyTorch version: sweeps x (sum over the windows and the
    variant's heads of q k^T), (T, T) f32. int8: each window-head product in
    f64 (exact), then f32, then the sum."""
    _check(variant, qkv, sweeps)
    n = qkv.shape[0]
    heads = list(HEADS[variant])
    q = qkv[..., :C].reshape(n, T, H, D)[:, :, heads].transpose(1, 2)
    k = qkv[..., C:2 * C].reshape(n, T, H, D)[:, :, heads].transpose(1, 2)
    if variant == "loop_int8":
        s = torch.matmul(q.double(), k.double().transpose(-1, -2)).float()
    else:
        s = dot_f32(q, k.transpose(-1, -2))
    return s.sum(dim=(0, 1)) * sweeps


def library_call(variant: str, qkv: torch.Tensor) -> functools.partial:
    """The one PyTorch call that computes one sweep of ``variant`` on qkv, with
    its operands gathered here, outside the call that is timed (a yardstick;
    the port never calls it on a path). bf16 variants: ``torch.einsum`` over
    the variant's heads (the packs: 0, 1, 2, 3, 2, 3, 4, 5), (T, T) bf16.
    ``loop_int8``: ``torch._int_mm`` of the q lanes (T, windows x C), row-major,
    against the k lanes (windows x C, T), column-major (the transpose of a
    contiguous (T, windows x C)): both with the contraction contiguous, the
    layout cuBLAS's int8 product takes. (T, T) int32, exact: 127^2 x 32 x 6 x
    64 windows < 2^31."""
    _check(variant, qkv, 1)
    n = qkv.shape[0]
    q = qkv[..., :C].reshape(n, T, H, D)
    k = qkv[..., C:2 * C].reshape(n, T, H, D)
    if variant == "loop_int8":
        lanes = [x.permute(1, 0, 2, 3).reshape(T, n * C).contiguous() for x in (q, k)]
        return functools.partial(torch._int_mm, lanes[0], lanes[1].t())
    if variant != "loop":
        heads = list(HEADS[variant])
        q, k = q[:, :, heads].contiguous(), k[:, :, heads].contiguous()
    return functools.partial(torch.einsum, "rthd,rshd->ts", q, k)


def _library() -> ctypes.CDLL:
    from pangu_tpu_torch.ops._build import load_library

    lib = load_library("bench_mxu_micro.cu")
    if lib.pangu_mxu_micro.argtypes is None:
        lib.pangu_mxu_micro.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3)
        lib.pangu_mxu_micro.restype = ctypes.c_int
    return lib


def mxu_micro(variant: str, qkv: torch.Tensor, sweeps: int = 1) -> torch.Tensor:
    """Variant ``variant`` on qkv, ``sweeps`` sweeps: (T, T) f32. On a CUDA
    tensor the kernel (or an error); on a CPU tensor the plain version."""
    _check(variant, qkv, sweeps)
    if qkv.device.type == "cpu":
        return mxu_micro_reference(variant, qkv, sweeps)
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("the CUDA kernel takes contiguous 16-byte aligned qkv")
    split = SPLIT if sweeps % SPLIT == 0 else 1
    n = qkv.shape[0]
    part = torch.empty(n * split, T, T, dtype=torch.float32, device=qkv.device)
    out = torch.empty(T, T, dtype=torch.float32, device=qkv.device)
    lib = _library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.pangu_mxu_micro(qkv.data_ptr(), VARIANTS.index(variant), n, split,
                                 sweeps // split, part.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"bench_mxu_micro {variant} CUDA launch failed: cudaError_t {rc}")
    LAUNCHES[variant] += 1
    return out


def check(variant: str, qkv: torch.Tensor, sweeps: int = SWEEPS) -> dict:
    """The kernel against its plain version at one sweep (``TOL``), and the
    call that is timed, ``sweeps`` sweeps with its split and repeat, against
    ``sweeps`` x the plain version (``SWEEPS_TOL``)."""
    got = mxu_micro(variant, qkv)
    timed = mxu_micro(variant, qkv, sweeps)
    torch.cuda.synchronize()
    ref = mxu_micro_reference(variant, qkv)
    err = max_rel(got, ref)
    timed_err = max_rel(timed, ref * sweeps)
    return dict(max_abs_err=(got - ref).abs().max().item(), rel_err=err,
                timed_rel_err=timed_err, ok=err < TOL[variant] and timed_err < SWEEPS_TOL)


def run(variants: Sequence[str] = VARIANTS, sweeps: int = SWEEPS, checked: bool = True,
        device=None) -> Dict[str, dict]:
    """Each variant on the card: (checked) against its plain version, then
    timed at ``sweeps`` sweeps per call. Times are per sweep."""
    for v in variants:
        check_variant(v)
    dev = device or cuda_device()
    qkv, qkv8 = make_inputs(dev)
    out = {}
    for v in variants:
        x = qkv8 if v == "loop_int8" else qkv
        res = check(v, x, sweeps) if checked else {}
        call_ms = cuda_times_ms(lambda: mxu_micro(v, x, sweeps), n=10)
        ms = call_ms / sweeps
        call_bound = mxu_bound(v, REPS, sweeps)
        res.update(ms=ms, sweeps=sweeps, us_per_window=ms * 1e3 / REPS,
                   tflops=issued_ops(v, REPS, sweeps) / (call_ms * 1e-3) / 1e12,
                   plain_ms=cuda_times_ms(lambda: mxu_micro_reference(v, x), n=6),
                   library_ms=cuda_times_ms(library_call(v, x), n=10),
                   bound_ms=call_bound["bound_ms"] / sweeps, bound_by=call_bound["bound_by"])
        out[v] = res
    return out


def main(argv: Sequence[str]) -> int:
    variants = list(argv) or list(VARIANTS)
    for v in variants:  # refuse before any device minute is spent
        check_variant(v)
    res = run(variants)
    for v, r in res.items():
        emit({v: r})
    failed = [v for v, r in res.items() if not r["ok"]]
    emit({"mxu_micro": {v: round(r["us_per_window"], 4) for v, r in res.items()},
          "unit": "us per window", "device_kind": torch.cuda.get_device_name(0)})
    if failed:
        raise AssertionError(f"{failed} disagree with their plain versions")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
