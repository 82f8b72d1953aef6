"""Smoke run of the PyTorch port on one CUDA card: build, kernel check, and
the 24 h forecast step at full geometry.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. the card's name and power limit (nvidia-smi); a CUDA card is required;
2. build the CUDA sources of pangu_tpu_torch/csrc/ with nvcc (build/kernels/);
3. the block kernel against its plain PyTorch version, bf16, at both
   flagship stage shapes, unshifted and shifted (with the real shift mask);
   max|d| / max(1, max|ref|) < 0.04 and RMS(d) / RMS(ref) < 0.01; per-call
   times from CUDA events (median of 12);
4. the slice: flagship ``pangu_pretrain(24)`` in bf16 with seeded synthetic
   weights and aux constants, 3 autoregressive forecast steps through
   ``make_forecast_step`` (exactly 16 kernel launches per step), output
   shapes and finiteness, one step against the plain bf16 composition and
   the f32 step on the same weights and inputs (max|d| < 0.1, RMS(d) < 0.01
   in normalized units), median step times and peak memory.

A ``detail:`` line holds the per-shape kernel results and the slice's
numbers as JSON. The second-to-last line is a JSON object with one entry per
kernel (``launches`` counted over the forecast steps only; ``ms`` and
``plain_ms`` the mean per launch over one step's mix of 2 + 2 outer and
6 + 6 inner blocks); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

from pangu_tpu_torch import pangu_pretrain
from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.interop.from_jax import init_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.model.attention import shift_attention_mask
from pangu_tpu_torch.ops import _build
from pangu_tpu_torch.ops import fused_block_attention as fba
from pangu_tpu_torch.rollout import make_forecast_step

STEPS = 3
KERNEL_TOL = 0.04  # max|d| / max(1, max|ref|), tests/test_kernel_interpret.py
KERNEL_RMS_TOL = 0.01  # RMS(d) / RMS(ref)
STEP_MAX_TOL, STEP_RMS_TOL = 0.1, 0.01  # normalized units, kernel vs plain and f32 steps


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> None:
    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs the card")


def cuda_times_ms(fn, n: int = 12, warmup: int = 2) -> float:
    """Median per-call time of ``fn()`` from CUDA events."""
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


def block_inputs(stage, c: int, heads: int, shifted: bool, dev, seed: int):
    """Seeded bf16 block inputs at one stage's full shape: unit-scale x,
    fan-in-scaled (out, in) weights, unit earth bias (softmax far from
    uniform)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16

    def rn(*shape, std=1.0, mean=0.0, dtype=bf):
        return (mean + std * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    f32 = torch.float32
    mask = torch.from_numpy(shift_attention_mask(stage)).to(dev) if shifted else None
    args = (rn(1, stage.z, stage.h_pad, stage.w, c),
            rn(3 * c, c, std=c ** -0.5), rn(3 * c, std=0.02),
            rn(c, c, std=c ** -0.5), rn(c, std=0.02),
            rn(stage.n_type_windows, heads, 144, 144, dtype=f32), mask,
            rn(c, mean=1.0, std=0.1, dtype=f32), rn(c, std=0.1, dtype=f32),
            rn(4 * c, c, std=c ** -0.5), rn(4 * c, std=0.02),
            rn(c, 4 * c, std=(4 * c) ** -0.5), rn(c, std=0.02),
            rn(c, mean=1.0, std=0.1, dtype=f32), rn(c, std=0.1, dtype=f32))
    return args, (stage.window, heads, (c // heads) ** -0.5)


def check_kernel(g, dev) -> dict:
    """Phase 3: the kernel against its plain version at the main path's
    shapes (``g``, the flagship model's geometry); returns per-shape times."""
    shapes = []
    for name, stage, c, heads, per_step in (("outer", g.outer, 192, 6, 2),
                                            ("inner", g.inner, 384, 12, 6)):
        for shifted in (False, True):
            args, statics = block_inputs(stage, c, heads, shifted, dev, seed=len(shapes))
            got = fba.fused_earth_block(*args, *statics)
            torch.cuda.synchronize()
            ref = fba.fused_earth_block_reference(*args, *statics)
            d = (got.float() - ref.float())
            max_abs = d.abs().max().item()
            rms = d.pow(2).mean().sqrt().item()
            ref_max = ref.float().abs().max().item()
            ref_rms = ref.float().pow(2).mean().sqrt().item()
            del got, ref, d
            ms = cuda_times_ms(lambda: fba.fused_earth_block(*args, *statics))
            plain_ms = cuda_times_ms(lambda: fba.fused_earth_block_reference(*args, *statics))
            log(f"kernel {name} {'shifted' if shifted else 'unshifted'} x={tuple(args[0].shape)} "
                f"heads={heads}: max|d|={max_abs:.6g} rms(d)={rms:.6g} max|ref|={ref_max:.6g} "
                f"rms(ref)={ref_rms:.6g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if not max_abs / max(1.0, ref_max) < KERNEL_TOL or not rms / ref_rms < KERNEL_RMS_TOL:
                raise AssertionError(f"kernel disagrees with its plain version at {name}")
            shapes.append(dict(stage=name, shifted=shifted, shape=list(args[0].shape),
                               heads=heads, launches_per_step=per_step, max_abs_err=max_abs,
                               rms_err=rms, ms=ms, plain_ms=plain_ms))
            del args
            torch.cuda.empty_cache()
    return dict(shapes=shapes, max_abs_err=max(s["max_abs_err"] for s in shapes),
                ms=sum(s["ms"] * s["launches_per_step"] for s in shapes) / 16,
                plain_ms=sum(s["plain_ms"] * s["launches_per_step"] for s in shapes) / 16)


def run_steps(step, upper, surface, n: int):
    """n autoregressive steps; returns the first step's output, the last
    state and the per-step host times (each ends in a synchronize)."""
    times, first = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        upper, surface = step(upper, surface)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        first = first or (upper, surface)
    return first, (upper, surface), times


def deviation(a, b, aux) -> tuple:
    """max|d| and RMS(d) over both outputs, in normalized units."""
    du = (a[0] - b[0]) / aux.upper_std
    ds = (a[1] - b[1]) / aux.surface_std
    max_abs = max(du.abs().max().item(), ds.abs().max().item())
    rms = ((du.pow(2).sum() + ds.pow(2).sum()) / (du.numel() + ds.numel())).sqrt().item()
    return max_abs, rms


def build_model(dev):
    """The flagship 24 h model in bf16 with seeded parameters, and seeded
    synthetic aux constants."""
    cfg = pangu_pretrain(24, compute_dtype="bfloat16", matmul_precision="default",
                         use_pallas_attention=True)
    t0 = time.perf_counter()
    model = PanguModel(cfg.model).to(dev).eval()
    init_params(model, seed=0)
    aux = synthetic_aux_constants(cfg.model, cfg.train, seed=0, device=dev)
    log(f"model: {sum(p.numel() for p in model.parameters())} parameters, "
        f"set up in {time.perf_counter() - t0:.2f} s")
    return model, aux


def check_slice(model, aux, dev) -> dict:
    """Phase 4: the flagship forecast step on the kernel path."""
    m = model.cfg
    gen = torch.Generator(device=dev).manual_seed(1)
    upper = aux.upper_mean + aux.upper_std * torch.randn(
        (1, m.upper_vars, m.levels, m.lat, m.lon), generator=gen, device=dev)
    surface = aux.surface_mean + aux.surface_std * torch.randn(
        (1, m.surface_vars, m.lat, m.lon), generator=gen, device=dev)

    torch.cuda.reset_peak_memory_stats(dev)
    fba.LAUNCHES = 0
    first, last, times = run_steps(make_forecast_step(model, aux), upper, surface, STEPS)
    launches = fba.LAUNCHES
    peak = torch.cuda.max_memory_allocated(dev)
    depth = sum(m.depths)
    log(f"forecast steps: {STEPS}, kernel launches {launches} (want {depth * STEPS}), "
        f"step times s {[round(t, 6) for t in times]}, peak memory {peak / 2**30:.3f} GiB")
    if launches != depth * STEPS:
        raise AssertionError(f"{launches} kernel launches in {STEPS} steps, want {depth * STEPS}")
    for out, shape in ((last[0], (1, 5, 13, 721, 1440)), (last[1], (1, 4, 721, 1440))):
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"output {tuple(out.shape)} (want {shape}) is not finite")

    results = dict(launches=launches, step_s=statistics.median(times), peak_bytes=peak)
    for label, kw in (("plain", dict(use_pallas_attention=False)),
                      ("f32", dict(compute_dtype="float32", use_pallas_attention=False))):
        other = PanguModel(dataclasses.replace(m, **kw)).to(dev).eval()
        other.load_state_dict(model.state_dict())
        torch.cuda.reset_peak_memory_stats(dev)
        fba.LAUNCHES = 0
        ref, _, ref_times = run_steps(make_forecast_step(other, aux), upper, surface,
                                      STEPS if label == "plain" else 1)
        if fba.LAUNCHES:
            raise AssertionError(f"the {label} path launched the kernel")
        max_abs, rms = deviation(first, ref, aux)
        log(f"kernel step vs {label} step: max|d|={max_abs:.6g} rms(d)={rms:.6g} (normalized); "
            f"{label} step times s {[round(t, 6) for t in ref_times]}, peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
        if not (max_abs < STEP_MAX_TOL and rms < STEP_RMS_TOL):
            raise AssertionError(f"kernel step disagrees with the {label} step")
        results[label] = dict(max_abs=max_abs, rms=rms, step_s=statistics.median(ref_times),
                              peak_bytes=torch.cuda.max_memory_allocated(dev))
        del other, ref
        torch.cuda.empty_cache()
    return results


def main() -> int:
    card()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.load_library("fused_earth_block.cu")
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc {_build.BUILD_SECONDS})")

    model, aux = build_model(dev)
    kern = check_kernel(model.geom, dev)
    sl = check_slice(model, aux, dev)
    log(f"slice: kernel step {sl['step_s']:.6f} s, plain step {sl['plain']['step_s']:.6f} s, "
        f"f32 step {sl['f32']['step_s']:.6f} s")

    log("detail: " + json.dumps({"fused_earth_block": kern["shapes"], "slice": sl}))
    print(json.dumps({"kernels": [{
        "name": "fused_earth_block", "route": "cuda",
        "source": "pangu_tpu_torch/csrc/fused_earth_block.cu",
        "replaces": "pangu_tpu/ops/fused_block_attention.py:555",
        "launches": sl["launches"], "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
