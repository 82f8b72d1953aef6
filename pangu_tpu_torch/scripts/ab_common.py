"""Shared machinery of the port's kernel A/B and micro-bench scripts
(``bench_attn_fwd_ab``, ``bench_attn_bwd_ab``, ``bench_mxu_micro``; port of
``scripts/ab_common.py``).

Timing is CUDA events around each call: the median of ``n`` calls after
``warmup`` untimed ones. The JAX harness chains calls in a ``lax.scan`` with
the input perturbed by the previous output so that XLA cannot fold repeated
pure calls into one; PyTorch runs eagerly and common-subexpression
elimination never happens, so every call here runs as launched. The bound of a
call is the larger of its operations over the card's peak for their type and
its compulsory bytes over the memory rate (NVIDIA H100 SXM data sheet, dense:
989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s).
"""

from __future__ import annotations

import json
import statistics
from typing import Callable

import torch

PEAK_BF16, PEAK_INT8, PEAK_BYTES = 989e12, 1979e12, 3.35e12
#: a kernel against its plain version (bf16 operands, f32 sums in another
#: order): max|d| / max(1, max|ref|) and RMS(d) / RMS(ref)
KERNEL_TOL, KERNEL_RMS_TOL = 0.04, 0.01


def cuda_times_ms(fn: Callable[[], object], n: int = 12, warmup: int = 2) -> float:
    """Median per-call time of ``fn()`` in ms from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(ops: float, nbytes: float, peak: float = PEAK_BF16) -> dict:
    """The least time the card could take: ``bound_ms`` and ``bound_by``."""
    ops_ms, bytes_ms = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def compare(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """max|d|, RMS(d), max|ref|, RMS(ref) and whether the two kernel bounds
    hold, for one output."""
    d = got.float() - ref.float()
    ref = ref.float()
    out = dict(max_abs=d.abs().max().item(), rms=d.pow(2).mean().sqrt().item(),
               ref_max=ref.abs().max().item(), ref_rms=ref.pow(2).mean().sqrt().item())
    out["ok"] = (out["max_abs"] / max(1.0, out["ref_max"]) < KERNEL_TOL
                 and out["rms"] / max(out["ref_rms"], 1e-30) < KERNEL_RMS_TOL)
    return out


def max_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max|got - ref| / max|ref|, in f32."""
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def cuda_device() -> torch.device:
    """The current CUDA device; raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("the A/B scripts need a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)
