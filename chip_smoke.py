"""Smoke run of the PyTorch port on one CUDA card: build, kernel checks, the
24 h forecast step, the train step and its two A/B routes at full geometry.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. the card's name and power limit (nvidia-smi); a CUDA card is required;
2. build the CUDA sources of pangu_tpu_torch/csrc/ with nvcc (build/kernels/),
   one nvcc per source, all at once;
3. the block kernel K1 against its plain PyTorch version, bf16, at both
   flagship stage shapes, unshifted and shifted (with the real shift mask);
   max|d| / max(1, max|ref|) < 0.04 and RMS(d) / RMS(ref) < 0.01; per-call
   times from CUDA events (median of 12);
4. the forecast slice: flagship ``pangu_pretrain(24)`` in bf16 with seeded
   synthetic weights and aux constants, 3 autoregressive forecast steps
   through ``make_forecast_step`` (exactly 16 kernel launches per step),
   output shapes and finiteness, one step against the plain bf16
   composition and the f32 step on the same weights and inputs (max|d| <
   0.1, RMS(d) < 0.01 in normalized units), median step times and peak
   memory;
5. the training attention K2 and its flash backward K3 against their plain
   versions at both stage shapes, unshifted and shifted: the forward output
   and all six gradients under the bounds of phase 3; per-call times;
6. the post-norm residual K4 and its backward K5 against their plain
   versions at both stage row counts with a branch scale, same bounds;
7. the MLP tail K6 and its backward K7 against their plain versions at both
   stage row counts with a branch scale: the output and all eight gradients,
   same bounds;
8. the train slice: 1 warm-up and 3 timed flagship train steps through
   ``make_train_step`` (bf16, remat, drop path 0.2 from a seeded generator,
   Adam): exactly 32 / 16 launches of each forward / backward kernel (K2 /
   K3, K4 / K5, K6 / K7) per step, finite loss and gradients, changed
   parameters, median step time, peak memory and train TFLOP/s; then one
   step each of the plain bf16 composition and the f32 model from the same
   weights, batch and drop-path draws as the warm-up step: against the plain
   bf16 step the loss within 1%, the gradient's global relative L2 < 1%,
   each earth-specific bias's relative L2 < 10% and every other parameter's
   < 2% (the f32 figures are reported only);
9. the raw MLP K8 and its backward K9 against their plain versions at both
   stage row counts: the output and all five gradients, the bounds of phase 3;
10. the training block K11 and its backward K12 against their plain versions
   at both stage shapes, unshifted and shifted, with per-sample scales s1 !=
   s2: the output and all sixteen gradients, the bounds of phase 3; and K11 at
   unit scales against K1, the same bounds (they differ only in rounding a
   and x1 to bf16);
11. the A/B routes of ``pangu_tpu_torch.scripts.bench_train_ab``:
   ``fused_block`` (K11/K12, exactly 16 launches of each per step) and
   ``unfused_tail`` (K2 32 / K3 16, K4 32 / K5 16, K8 32 / K9 16): one step
   from phase 8's weights, batch and drop-path draws, finite loss and
   gradients and the bounds of phase 8 against the plain bf16 step; then 3
   timed steps through the script's helper, step time and peak memory.

A ``detail:`` line holds the per-shape kernel results and the slices'
numbers as JSON. The second-to-last line is a JSON object with one entry per
kernel: ``launches`` counted over the run of the kernel's path (the 3
forecast steps for K1, the 3 timed steps of the default train step for
K2-K7, of ``unfused_tail`` for K8/K9 and of ``fused_block`` for K11/K12);
``ms``, ``plain_ms`` and ``bound_ms`` the mean per launch over one step's
mix of 2 + 2 outer and 6 + 6 inner blocks. ``bound_ms`` is the larger of
the bytes the function must move over 3.35 TB/s and its operations over the
card's peak for their type (989 TFLOP/s for the bf16 products; 67 TFLOP/s
for the f32 elementwise work of K4/K5), computed from the shapes;
``library_ms`` is null: no single PyTorch call computes any of these
functions. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
from pangu_tpu_torch.ops import fused_block_train as fbt
from pangu_tpu_torch.ops import fused_epilogue as fep
from pangu_tpu_torch.ops import fused_mlp as fmlp
from pangu_tpu_torch.rollout import make_forecast_step
from pangu_tpu_torch.scripts import bench_train_ab
from pangu_tpu_torch.train import Batch, make_optimizer, make_train_step
from pangu_tpu_torch.utils.flops import train_matmul_flops

STEPS = 3
KERNEL_TOL = 0.04  # max|d| / max(1, max|ref|), tests/test_kernel_interpret.py
KERNEL_RMS_TOL = 0.01  # RMS(d) / RMS(ref)
STEP_MAX_TOL, STEP_RMS_TOL = 0.1, 0.01  # normalized units, kernel vs plain and f32 steps
#: kernel vs plain bf16 train step: loss, the gradient's global relative L2, and the
#: worst relative L2 of one earth-specific bias and of one other parameter (PERF.md
#: section 6 has the readings they were set from)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 0.01, 0.01
TRAIN_BIAS_LEAF_TOL, TRAIN_LEAF_TOL = 0.1, 0.02
#: per flagship train step with remat: the checkpoint recompute runs the forwards again
TRAIN_LAUNCHES = {"fused_block_attention": 32, "fused_block_attention_bwd": 16,
                  "fused_residual_postnorm": 32, "fused_residual_postnorm_bwd": 16,
                  "fused_mlp_postnorm": 32, "fused_mlp_postnorm_bwd": 16}
#: per flagship train step on the A/B routes (the K11 route is not checkpointed)
AB_LAUNCHES = {
    "fused_block": {"fused_earth_block_train": 16, "fused_earth_block_train_bwd": 16},
    "unfused_tail": {"fused_block_attention": 32, "fused_block_attention_bwd": 16,
                     "fused_residual_postnorm": 32, "fused_residual_postnorm_bwd": 16,
                     "fused_mlp": 32, "fused_mlp_bwd": 16},
}
#: launches of each block shape per step: (stage, shifted) -> blocks
PER_STEP = {("outer", False): 2, ("outer", True): 2, ("inner", False): 6, ("inner", True): 6}
#: H100 SXM peaks (NVIDIA's data sheet, dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
#: (replaced TPU kernel, CUDA source) of every kernel, in table order
KERNELS = {
    "fused_earth_block": ("pangu_tpu/ops/fused_block_attention.py:555", "fused_earth_block.cu"),
    "fused_block_attention": ("pangu_tpu/ops/fused_block_attention.py:188",
                              "block_attention.cu"),
    "fused_block_attention_bwd": ("pangu_tpu/ops/fused_block_attention.py:410",
                                  "block_attention.cu"),
    "fused_residual_postnorm": ("pangu_tpu/ops/fused_epilogue.py:87", "fused_epilogue.cu"),
    "fused_residual_postnorm_bwd": ("pangu_tpu/ops/fused_epilogue.py:138", "fused_epilogue.cu"),
    "fused_mlp_postnorm": ("pangu_tpu/ops/fused_mlp.py:470", "fused_mlp.cu"),
    "fused_mlp_postnorm_bwd": ("pangu_tpu/ops/fused_mlp.py:526", "fused_mlp.cu"),
    "fused_mlp": ("pangu_tpu/ops/fused_mlp.py:253", "fused_mlp.cu"),
    "fused_mlp_bwd": ("pangu_tpu/ops/fused_mlp.py:300", "fused_mlp.cu"),
    "fused_earth_block_train": ("pangu_tpu/ops/fused_block_train.py:341",
                                "fused_block_train.cu"),
    "fused_earth_block_train_bwd": ("pangu_tpu/ops/fused_block_train.py:432",
                                    "fused_block_train.cu"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> None:
    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs the card")


def bound(name: str, rows: int, c: int, heads: int = 0, n_types: int = 0,
          shifted: bool = False) -> dict:
    """The least time the card could take for one call of kernel ``name`` at
    this shape: the larger of its compulsory bytes (each input read once,
    each output written once) over the memory rate and its operations over
    the peak rate of their type. Products count 2 FLOP per multiply-add at
    the bf16 peak (a backward counts the forward it recomputes from its
    inputs); the f32 elementwise work counts only where no product bounds
    it (K4/K5)."""
    t, r = 144, rows
    rc2, rtc = r * c * c, r * t * c
    act = 2 * r * c  # one bf16 (rows, C) tensor
    tables = n_types * heads * t * t * 4 + (n_types * t * t * 4 if shifted else 0)
    w_attn, w_mlp, ln = (4 * c * c + 4 * c) * 2, (8 * c * c + 5 * c) * 2, 2 * c * 4
    work = {  # name: (bf16 product FLOP, f32 elementwise FLOP, bytes)
        "fused_earth_block": (24 * rc2 + 4 * rtc, 0, 2 * act + tables + w_attn + w_mlp + 2 * ln),
        "fused_block_attention": (8 * rc2 + 4 * rtc, 0, 2 * act + tables + w_attn),
        "fused_block_attention_bwd": (22 * rc2 + 12 * rtc, 0,
                                      3 * act + 2 * tables + 2 * w_attn),
        "fused_residual_postnorm": (0, 10 * r * c, 3 * act + 4 * r + ln),
        "fused_residual_postnorm_bwd": (0, 16 * r * c, 3 * act + 8 * r + 2 * ln),
        "fused_mlp_postnorm": (16 * rc2, 0, 2 * act + 4 * r + w_mlp + ln),
        "fused_mlp_postnorm_bwd": (48 * rc2, 0, 3 * act + 8 * r + 2 * w_mlp + 2 * ln),
        "fused_mlp": (16 * rc2, 0, 2 * act + w_mlp),
        "fused_mlp_bwd": (40 * rc2, 0, 3 * act + 2 * w_mlp),
        "fused_earth_block_train": (24 * rc2 + 4 * rtc, 0,
                                    2 * act + tables + w_attn + w_mlp + 2 * ln),
        "fused_earth_block_train_bwd": (72 * rc2 + 12 * rtc, 0,
                                        3 * act + 2 * tables + 2 * (w_attn + w_mlp) + 4 * ln),
    }
    mm, ew, nbytes = work[name]
    ops_ms = (mm / PEAK_BF16 + ew / PEAK_F32) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


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
                               rms_err=rms, ms=ms, plain_ms=plain_ms,
                               **bound("fused_earth_block", args[0].numel() // c, c, heads,
                                       stage.n_type_windows, shifted)))
            del args
            torch.cuda.empty_cache()
    return {"fused_earth_block": shapes}


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
    return cfg, model, aux


def check_slice(model, aux, dev) -> dict:
    """Phase 4: the flagship forecast step on the kernel path."""
    m = model.cfg
    gen = torch.Generator(device=dev).manual_seed(1)
    upper = aux.upper_mean + aux.upper_std * torch.randn(
        (1, m.upper_vars, m.levels, m.lat, m.lon), generator=gen, device=dev)
    surface = aux.surface_mean + aux.surface_std * torch.randn(
        (1, m.surface_vars, m.lat, m.lon), generator=gen, device=dev)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
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


def launch_counts() -> dict:
    """Every kernel's launch count (K1 and the training kernels)."""
    return {"fused_earth_block": fba.LAUNCHES, **bench_train_ab.launch_counts()}


def reset_counts() -> None:
    fba.LAUNCHES = fba.ATTN_FWD_LAUNCHES = fba.ATTN_BWD_LAUNCHES = 0
    fep.FWD_LAUNCHES = fep.BWD_LAUNCHES = 0
    fmlp.FWD_LAUNCHES = fmlp.BWD_LAUNCHES = fmlp.RAW_FWD_LAUNCHES = fmlp.RAW_BWD_LAUNCHES = 0
    fbt.FWD_LAUNCHES = fbt.BWD_LAUNCHES = 0


def compare(got, ref) -> dict:
    """max|d|, RMS(d) and the bounds of phase 3 for one output."""
    d = got.float() - ref.float()
    ref = ref.float()
    out = dict(max_abs=d.abs().max().item(), rms=d.pow(2).mean().sqrt().item(),
               ref_max=ref.abs().max().item(), ref_rms=ref.pow(2).mean().sqrt().item())
    out["ok"] = (out["max_abs"] / max(1.0, out["ref_max"]) < KERNEL_TOL
                 and out["rms"] / max(out["ref_rms"], 1e-30) < KERNEL_RMS_TOL)
    return out


def check_outputs(label: str, outputs: dict) -> float:
    """Log each output's comparison; raise if one is out of bounds; return the
    largest max|d|."""
    for name, c in outputs.items():
        log(f"  {label} {name}: max|d|={c['max_abs']:.6g} rms(d)={c['rms']:.6g} "
            f"max|ref|={c['ref_max']:.6g} rms(ref)={c['ref_rms']:.6g}")
    bad = [name for name, c in outputs.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"{label}: {bad} disagree with the plain version")
    return max(c["max_abs"] for c in outputs.values())


def mix(shapes: list, key: str) -> float:
    """Mean per launch over one step's mix of block shapes; a shape without
    "shifted" stands for both (the row kernels do not see the shift)."""
    return sum(sh[key] * n for sh in shapes for (stage, shifted), n in PER_STEP.items()
               if stage == sh["stage"] and sh.get("shifted", shifted) == shifted) / 16


def check_attention(g, dev) -> dict:
    """Phase 5: K2 and K3 against their plain versions at the train path's
    shapes, all six gradients."""
    fwd, bwd = [], []
    names = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
    for name, stage, c, heads in (("outer", g.outer, 192, 6), ("inner", g.inner, 384, 12)):
        for shifted in (False, True):
            args, (window, heads, scale) = block_inputs(stage, c, heads, shifted, dev,
                                                        seed=10 + len(fwd))
            x, wqkv, bqkv, wproj, bproj, bias, mask = args[:7]
            del args
            gen = torch.Generator(device=dev).manual_seed(20 + len(fwd))
            gy = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)
            fargs = (x, wqkv, bqkv, wproj, bproj, bias, mask, None, None, window, heads, scale)
            bargs = (x, wqkv, bqkv, wproj, bias, mask, gy, window, heads, scale)
            label = f"{name} {'shifted' if shifted else 'unshifted'}"
            with torch.no_grad():
                got = fba.fused_block_attention(*fargs)
                torch.cuda.synchronize()
                err = check_outputs(f"K2 {label}", {"y": compare(
                    got, fba.fused_block_attention_reference(*fargs[:7], *fargs[9:]))})
                del got
                geo = (x.numel() // c, c, heads, stage.n_type_windows, shifted)
                fwd.append(dict(stage=name, shifted=shifted, max_abs_err=err,
                                **bound("fused_block_attention", *geo),
                                ms=cuda_times_ms(lambda: fba.fused_block_attention(*fargs)),
                                plain_ms=cuda_times_ms(lambda: fba.fused_block_attention_reference(
                                    *fargs[:7], *fargs[9:]), n=6)))
                grads = fba.fused_block_attention_bwd(*bargs)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                ref = fba.fused_block_attention_bwd_reference(*bargs)
                plain_peak = torch.cuda.max_memory_allocated(dev)
                err = check_outputs(f"K3 {label}", {n: compare(a, b)
                                                    for n, a, b in zip(names, grads, ref)})
                del grads, ref
                torch.cuda.empty_cache()
                bwd.append(dict(stage=name, shifted=shifted, max_abs_err=err,
                                plain_peak_bytes=plain_peak,
                                **bound("fused_block_attention_bwd", *geo),
                                ms=cuda_times_ms(lambda: fba.fused_block_attention_bwd(*bargs)),
                                plain_ms=cuda_times_ms(
                                    lambda: fba.fused_block_attention_bwd_reference(*bargs), n=6)))
            log(f"K2 {label}: kernel {fwd[-1]['ms']:.4f} ms, plain {fwd[-1]['plain_ms']:.4f} ms; "
                f"K3 kernel {bwd[-1]['ms']:.4f} ms, plain {bwd[-1]['plain_ms']:.4f} ms (plain "
                f"peak memory {bwd[-1]['plain_peak_bytes'] / 2**30:.3f} GiB)")
            del fargs, bargs, x, gy
            torch.cuda.empty_cache()
    return {"fused_block_attention": fwd, "fused_block_attention_bwd": bwd}


def check_residual(g, dev) -> dict:
    """Phase 6: K4 and K5 against their plain versions at both stage row
    counts, with a branch scale."""
    fwd, bwd = [], []
    for name, stage, c in (("outer", g.outer, 192), ("inner", g.inner, 384)):
        gen = torch.Generator(device=dev).manual_seed(30 + len(fwd))
        rows = stage.z * stage.h_pad * stage.w

        def rn(*shape, dtype=torch.bfloat16, mean=0.0, std=1.0):
            return (mean + std * torch.randn(shape, generator=gen, device=dev)).to(dtype)

        shortcut, a, gy = rn(rows, c), rn(rows, c), rn(rows, c)
        gamma, beta = rn(c, dtype=torch.float32, mean=1.0, std=0.1), rn(c, dtype=torch.float32,
                                                                         std=0.1)
        s = torch.full((rows,), 1.25, device=dev)  # one sample's drop-path keep scale
        fargs, bargs = (shortcut, a, gamma, beta, s), (a, gy, gamma, beta, s)
        with torch.no_grad():
            got = fep.fused_residual_postnorm(shortcut, a, gamma, beta, s[:, None])
            torch.cuda.synchronize()
            err = check_outputs(f"K4 {name}", {"out": compare(
                got, fep.fused_residual_postnorm_reference(*fargs))})
            fwd.append(dict(stage=name, rows=rows, c=c, max_abs_err=err,
                            **bound("fused_residual_postnorm", rows, c),
                            ms=cuda_times_ms(lambda: fep.fused_residual_postnorm(
                                shortcut, a, gamma, beta, s[:, None])),
                            plain_ms=cuda_times_ms(
                                lambda: fep.fused_residual_postnorm_reference(*fargs))))
            outs = fep.fused_residual_postnorm_bwd(*bargs)
            torch.cuda.synchronize()
            ref = fep.fused_residual_postnorm_bwd_reference(*bargs)
            err = check_outputs(f"K5 {name}", {n: compare(x, y) for n, x, y in zip(
                ("da", "dgamma", "dbeta", "ds"), outs, ref)})
            bwd.append(dict(stage=name, rows=rows, c=c, max_abs_err=err,
                            **bound("fused_residual_postnorm_bwd", rows, c),
                            ms=cuda_times_ms(lambda: fep.fused_residual_postnorm_bwd(*bargs)),
                            plain_ms=cuda_times_ms(
                                lambda: fep.fused_residual_postnorm_bwd_reference(*bargs))))
        log(f"K4 {name} rows={rows} C={c}: kernel {fwd[-1]['ms']:.4f} ms, plain "
            f"{fwd[-1]['plain_ms']:.4f} ms; K5 kernel {bwd[-1]['ms']:.4f} ms, plain "
            f"{bwd[-1]['plain_ms']:.4f} ms")
        del fargs, bargs, shortcut, a, gy, outs, ref
        torch.cuda.empty_cache()
    return {"fused_residual_postnorm": fwd, "fused_residual_postnorm_bwd": bwd}


def check_mlp(g, dev) -> dict:
    """Phase 7: K6 and K7 against their plain versions at both stage row
    counts, with a branch scale; all eight gradients."""
    fwd, bwd = [], []
    names = ("dx", "dw1", "db1", "dw2", "db2", "dgamma", "dbeta", "ds")
    for name, stage, c in (("outer", g.outer, 192), ("inner", g.inner, 384)):
        gen = torch.Generator(device=dev).manual_seed(40 + len(fwd))
        rows = stage.z * stage.h_pad * stage.w

        def rn(*shape, dtype=torch.bfloat16, mean=0.0, std=1.0):
            return (mean + std * torch.randn(shape, generator=gen, device=dev)).to(dtype)

        f32 = torch.float32
        x, gy = rn(rows, c), rn(rows, c)
        weights = (rn(4 * c, c, std=c ** -0.5), rn(4 * c, std=0.02),
                   rn(c, 4 * c, std=(4 * c) ** -0.5), rn(c, std=0.02),
                   rn(c, dtype=f32, mean=1.0, std=0.1), rn(c, dtype=f32, std=0.1))
        s = torch.full((rows,), 1.25, device=dev)  # one sample's drop-path keep scale
        fargs, bargs = (x, *weights, s), (x, gy, *weights, s)
        with torch.no_grad():
            got = fmlp.fused_mlp_postnorm(x, *weights, s[:, None])
            torch.cuda.synchronize()
            err = check_outputs(f"K6 {name}", {"out": compare(
                got, fmlp.fused_mlp_postnorm_reference(*fargs))})
            del got
            fwd.append(dict(stage=name, rows=rows, c=c, max_abs_err=err,
                            **bound("fused_mlp_postnorm", rows, c),
                            ms=cuda_times_ms(lambda: fmlp.fused_mlp_postnorm(
                                x, *weights, s[:, None])),
                            plain_ms=cuda_times_ms(
                                lambda: fmlp.fused_mlp_postnorm_reference(*fargs), n=6)))
            outs = fmlp.fused_mlp_postnorm_bwd(*bargs)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            ref = fmlp.fused_mlp_postnorm_bwd_reference(*bargs)
            plain_peak = torch.cuda.max_memory_allocated(dev)
            err = check_outputs(f"K7 {name}", {n: compare(a, b)
                                               for n, a, b in zip(names, outs, ref)})
            del outs, ref
            torch.cuda.empty_cache()
            bwd.append(dict(stage=name, rows=rows, c=c, max_abs_err=err,
                            plain_peak_bytes=plain_peak,
                            **bound("fused_mlp_postnorm_bwd", rows, c),
                            ms=cuda_times_ms(lambda: fmlp.fused_mlp_postnorm_bwd(*bargs)),
                            plain_ms=cuda_times_ms(
                                lambda: fmlp.fused_mlp_postnorm_bwd_reference(*bargs), n=6)))
        log(f"K6 {name} rows={rows} C={c}: kernel {fwd[-1]['ms']:.4f} ms, plain "
            f"{fwd[-1]['plain_ms']:.4f} ms; K7 kernel {bwd[-1]['ms']:.4f} ms, plain "
            f"{bwd[-1]['plain_ms']:.4f} ms (plain peak memory "
            f"{bwd[-1]['plain_peak_bytes'] / 2**30:.3f} GiB)")
        del fargs, bargs, x, gy, weights
        torch.cuda.empty_cache()
    return {"fused_mlp_postnorm": fwd, "fused_mlp_postnorm_bwd": bwd}


def check_raw_mlp(g, dev) -> dict:
    """Phase 9: K8 and K9 against their plain versions at both stage row
    counts; all five gradients."""
    fwd, bwd = [], []
    names = ("dx", "dw1", "db1", "dw2", "db2")
    for name, stage, c in (("outer", g.outer, 192), ("inner", g.inner, 384)):
        gen = torch.Generator(device=dev).manual_seed(50 + len(fwd))
        rows = stage.z * stage.h_pad * stage.w

        def rn(*shape, std=1.0):
            return (std * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)

        x, gy = rn(rows, c), rn(rows, c)
        weights = (rn(4 * c, c, std=c ** -0.5), rn(4 * c, std=0.02),
                   rn(c, 4 * c, std=(4 * c) ** -0.5), rn(c, std=0.02))
        with torch.no_grad():
            got = fmlp.fused_mlp(x, *weights)
            torch.cuda.synchronize()
            err = check_outputs(f"K8 {name}", {"out": compare(
                got, fmlp.fused_mlp_reference(x, *weights))})
            del got
            fwd.append(dict(stage=name, rows=rows, c=c, max_abs_err=err,
                            **bound("fused_mlp", rows, c),
                            ms=cuda_times_ms(lambda: fmlp.fused_mlp(x, *weights)),
                            plain_ms=cuda_times_ms(lambda: fmlp.fused_mlp_reference(x, *weights),
                                                   n=6)))
            outs = fmlp.fused_mlp_bwd(x, gy, *weights)
            torch.cuda.synchronize()
            ref = fmlp.fused_mlp_bwd_reference(x, gy, *weights)
            err = check_outputs(f"K9 {name}", {n: compare(a, b)
                                               for n, a, b in zip(names, outs, ref)})
            del outs, ref
            torch.cuda.empty_cache()
            bwd.append(dict(stage=name, rows=rows, c=c, max_abs_err=err,
                            **bound("fused_mlp_bwd", rows, c),
                            ms=cuda_times_ms(lambda: fmlp.fused_mlp_bwd(x, gy, *weights)),
                            plain_ms=cuda_times_ms(
                                lambda: fmlp.fused_mlp_bwd_reference(x, gy, *weights), n=6)))
        log(f"K8 {name} rows={rows} C={c}: kernel {fwd[-1]['ms']:.4f} ms, plain "
            f"{fwd[-1]['plain_ms']:.4f} ms, bound {fwd[-1]['bound_ms']:.4f} ms; K9 kernel "
            f"{bwd[-1]['ms']:.4f} ms, plain {bwd[-1]['plain_ms']:.4f} ms, bound "
            f"{bwd[-1]['bound_ms']:.4f} ms")
        del x, gy, weights
        torch.cuda.empty_cache()
    return {"fused_mlp": fwd, "fused_mlp_bwd": bwd}


def check_block_train(g, dev) -> dict:
    """Phase 10: K11 and K12 against their plain versions at both stage
    shapes, unshifted and shifted, with per-sample scales s1 != s2 (all
    sixteen gradients); K11 at unit scales against K1."""
    fwd, bwd = [], []
    s1, s2 = torch.full((1,), 1.25, device=dev), torch.full((1,), 0.8, device=dev)
    for name, stage, c, heads in (("outer", g.outer, 192, 6), ("inner", g.inner, 384, 12)):
        for shifted in (False, True):
            args, statics = block_inputs(stage, c, heads, shifted, dev, seed=60 + len(fwd))
            gen = torch.Generator(device=dev).manual_seed(70 + len(fwd))
            gy = torch.randn(args[0].shape, generator=gen, device=dev).to(torch.bfloat16)
            label = f"{name} {'shifted' if shifted else 'unshifted'}"
            geo = (args[0].numel() // c, c, heads, stage.n_type_windows, shifted)
            with torch.no_grad():
                got = fbt.fused_earth_block_train(*args, s1, s2, *statics)
                torch.cuda.synchronize()
                ref = fbt.fused_earth_block_train_reference(*args, s1, s2, *statics)
                err = check_outputs(f"K11 {label}", {"out": compare(got, ref)})
                del got, ref
                one = torch.ones(1, device=dev)
                check_outputs(f"K11 at unit scales vs K1 {label}", {"out": compare(
                    fbt.fused_earth_block_train(*args, one, one, *statics),
                    fba.fused_earth_block(*args, *statics))})
                fwd.append(dict(stage=name, shifted=shifted, max_abs_err=err,
                                **bound("fused_earth_block_train", *geo),
                                ms=cuda_times_ms(
                                    lambda: fbt.fused_earth_block_train(*args, s1, s2, *statics)),
                                plain_ms=cuda_times_ms(
                                    lambda: fbt.fused_earth_block_train_reference(
                                        *args, s1, s2, *statics), n=6)))
                bargs = (*args, s1, s2, gy, *statics)
                grads = fbt.fused_earth_block_train_bwd(*bargs)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                ref = fbt.fused_earth_block_train_bwd_reference(*bargs)
                plain_peak = torch.cuda.max_memory_allocated(dev)
                err = check_outputs(f"K12 {label}", {n: compare(a, b) for n, a, b in zip(
                    fbt.GRAD_NAMES, grads, ref)})
                del grads, ref
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                fbt.fused_earth_block_train_bwd(*bargs)
                peak = torch.cuda.max_memory_allocated(dev)
                bwd.append(dict(stage=name, shifted=shifted, max_abs_err=err,
                                peak_bytes=peak, plain_peak_bytes=plain_peak,
                                **bound("fused_earth_block_train_bwd", *geo),
                                ms=cuda_times_ms(lambda: fbt.fused_earth_block_train_bwd(*bargs)),
                                plain_ms=cuda_times_ms(
                                    lambda: fbt.fused_earth_block_train_bwd_reference(*bargs),
                                    n=4, warmup=1)))
            log(f"K11 {label}: kernel {fwd[-1]['ms']:.4f} ms, plain {fwd[-1]['plain_ms']:.4f} "
                f"ms, bound {fwd[-1]['bound_ms']:.4f} ms; K12 kernel {bwd[-1]['ms']:.4f} ms, "
                f"plain {bwd[-1]['plain_ms']:.4f} ms, bound {bwd[-1]['bound_ms']:.4f} ms (peak "
                f"memory kernel {peak / 2**30:.3f} GiB, plain {plain_peak / 2**30:.3f} GiB)")
            del args, bargs, gy
            torch.cuda.empty_cache()
    return {"fused_earth_block_train": fwd, "fused_earth_block_train_bwd": bwd}


def train_batch(aux, m, dev) -> Batch:
    """Seeded physical-unit inputs and targets (targets: inputs plus noise)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    inputs = [aux.upper_mean + aux.upper_std * torch.randn(
        (1, m.upper_vars, m.levels, m.lat, m.lon), generator=gen, device=dev),
        aux.surface_mean + aux.surface_std * torch.randn(
        (1, m.surface_vars, m.lat, m.lon), generator=gen, device=dev)]
    targets = [x + 0.5 * std * torch.randn(x.shape, generator=gen, device=dev)
               for x, std in zip(inputs, (aux.upper_std, aux.surface_std))]
    return Batch(*inputs, *targets)


def timed_train_step(step, batch, aux, gen) -> tuple:
    """One train step: (loss, host seconds ended by a synchronize, launches)."""
    reset_counts()
    t0 = time.perf_counter()
    loss = step(batch, aux, gen)
    torch.cuda.synchronize()
    return loss.item(), time.perf_counter() - t0, launch_counts()


def check_train(cfg, model, aux, dev) -> dict:
    """Phase 8: the flagship train step on the kernel path, then the plain
    bf16 and f32 steps from the same weights, batch and drop-path draws."""
    m = cfg.model
    batch = train_batch(aux, m, dev)
    w0 = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, cfg, make_optimizer(model, cfg))

    def seeded():
        return torch.Generator(device=dev).manual_seed(3)

    torch.cuda.reset_peak_memory_stats(dev)
    loss0, t_warm, counts = timed_train_step(step, batch, aux, seeded())
    grads0 = {k: p.grad.clone() for k, p in model.named_parameters()}
    runs = [counts]
    gen, losses, times = torch.Generator(device=dev).manual_seed(4), [], []
    total = dict.fromkeys(TRAIN_LAUNCHES, 0)
    for _ in range(STEPS):
        loss, t, counts = timed_train_step(step, batch, aux, gen)
        losses.append(loss)
        times.append(t)
        runs.append(counts)
        for k in total:
            total[k] += counts[k]
    peak = torch.cuda.max_memory_allocated(dev)
    want = {k: TRAIN_LAUNCHES.get(k, 0) for k in counts}
    for counts in runs:
        if counts != want:
            raise AssertionError(f"train step launches {counts}, want {want}")
    check_finite([loss0] + losses, model)
    unchanged = [k for k, p in model.named_parameters() if torch.equal(p.detach(), w0[k])]
    if unchanged:
        raise AssertionError(f"train steps left parameters unchanged: {unchanged[:5]}")
    step_s = statistics.median(times)
    tflops = train_matmul_flops(m) / step_s / 1e12
    log(f"train steps: warm-up {t_warm:.6f} s, timed {[round(t, 6) for t in times]} s, "
        f"losses {[loss0] + losses}, launches per step {runs[-1]}, peak memory "
        f"{peak / 2**30:.3f} GiB, {tflops:.3f} TFLOP/s (train_matmul_flops / median step)")
    results = dict(launches=total, step_s=step_s, warmup_s=t_warm, losses=[loss0] + losses,
                   peak_bytes=peak, train_tflops=tflops, warmup_launches=runs[0])
    del step
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    ref = dict(w0=w0, batch=batch)
    for label, kw in (("plain", dict(use_pallas_attention=False)),
                      ("f32", dict(compute_dtype="float32", use_pallas_attention=False))):
        other = PanguModel(dataclasses.replace(m, **kw)).to(dev)
        other.load_state_dict(w0)
        torch.cuda.reset_peak_memory_stats(dev)
        loss, t, counts = timed_train_step(
            make_train_step(other, cfg, make_optimizer(other, cfg)), batch, aux, seeded())
        if any(counts.values()):
            raise AssertionError(f"the {label} train step launched kernels: {counts}")
        named = dict(other.named_parameters())
        g_ref = {k: named[k].grad.float() for k in grads0}
        dev_ = grad_deviation(f"kernel train step vs {label} step", loss0, grads0, loss, g_ref)
        log(f"  {label} step {t:.6f} s, peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
        results[label] = dict(**dev_, loss=loss, step_s=t,
                              peak_bytes=torch.cuda.max_memory_allocated(dev))
        if label == "plain":
            check_train_bounds("the kernel train step", dev_)
            ref.update(plain_loss=loss, plain_grads=g_ref)
        del other, named
        torch.cuda.empty_cache()
    return results, ref


def check_finite(losses, model) -> None:
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"train losses not finite: {losses}")
    if not all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()):
        raise AssertionError("a gradient of the last train step is not finite")


def grad_deviation(label: str, loss0: float, grads0: dict, loss: float, g_ref: dict) -> dict:
    """Loss deviation, the gradient's global relative L2 and the worst
    per-parameter relative L2 (earth-specific biases apart) of one step's
    gradients ``grads0`` against a reference step's ``g_ref``."""
    d2 = {k: (grads0[k].float() - g_ref[k]).pow(2).sum().item() for k in grads0}
    n2 = {k: g.pow(2).sum().item() for k, g in g_ref.items()}
    rel_l2 = math.sqrt(sum(d2.values()) / sum(n2.values()))
    leaf = sorted(((math.sqrt(d2[k] / max(n2[k], 1e-30)), k) for k in grads0), reverse=True)
    worst_bias = [(k, v) for v, k in leaf if k.endswith("earth_specific_bias")][:3]
    worst = [(k, v) for v, k in leaf if not k.endswith("earth_specific_bias")][:3]
    loss_dev = abs(loss0 - loss) / abs(loss)
    norm = math.sqrt(sum(g.float().pow(2).sum().item() for g in grads0.values()))
    log(f"{label}: loss {loss0:.6g} vs {loss:.6g} (rel {loss_dev:.6g}), gradient rel L2 "
        f"{rel_l2:.6g} (|g| {norm:.6g}), worst per-parameter rel L2: earth biases "
        f"{worst_bias}, others {worst}")
    return dict(loss_rel_dev=loss_dev, grad_rel_l2=rel_l2, worst_bias_rel_l2=worst_bias,
                worst_other_rel_l2=worst)


def check_train_bounds(label: str, d: dict) -> None:
    """The bounds of phase 8 against the plain bf16 step."""
    if not (d["loss_rel_dev"] < TRAIN_LOSS_TOL and d["grad_rel_l2"] < TRAIN_GRAD_TOL
            and d["worst_bias_rel_l2"][0][1] < TRAIN_BIAS_LEAF_TOL
            and d["worst_other_rel_l2"][0][1] < TRAIN_LEAF_TOL):
        raise AssertionError(f"{label} disagrees with the plain bf16 step")


def check_ab(cfg, aux, ref, dev) -> dict:
    """Phase 11: the A/B routes through the A/B script's helpers, each from
    phase 8's weights, batch and drop-path draws against the plain bf16 step,
    then timed."""
    results = {}
    for name, per_step in AB_LAUNCHES.items():
        want = {k: per_step.get(k, 0) for k in launch_counts()}
        with bench_train_ab.variant_flags(name):
            model = PanguModel(cfg.model).to(dev)
            model.load_state_dict(ref["w0"])
            step = make_train_step(model, cfg, make_optimizer(model, cfg))
            torch.cuda.reset_peak_memory_stats(dev)
            loss0, t_first, counts = timed_train_step(
                step, ref["batch"], aux, torch.Generator(device=dev).manual_seed(3))
            if counts != want:
                raise AssertionError(f"{name} step launches {counts}, want {want}")
            check_finite([loss0], model)
            grads0 = {k: p.grad.clone() for k, p in model.named_parameters()}
            d = grad_deviation(f"{name} train step vs plain step", loss0, grads0,
                               ref["plain_loss"], ref["plain_grads"])
            check_train_bounds(f"the {name} train step", d)
            del grads0
            gen, losses = torch.Generator(device=dev).manual_seed(4), []
            reset_counts()
            times = bench_train_ab.timed_steps(
                lambda: losses.append(step(ref["batch"], aux, gen).item()), 0, STEPS, dev)
            launches = launch_counts()
            if launches != {k: v * STEPS for k, v in want.items()}:
                raise AssertionError(f"{name}: {launches} launches in {STEPS} steps")
            check_finite(losses, model)
            peak = torch.cuda.max_memory_allocated(dev)
        results[name] = dict(**d, loss=loss0, first_step_s=t_first, times_s=times,
                             step_s=statistics.median(times), peak_bytes=peak,
                             launches={k: v for k, v in launches.items() if v})
        log(f"A/B {name}: first step {t_first:.6f} s, timed {[round(t, 6) for t in times]} s, "
            f"launches per step {per_step}, peak memory {peak / 2**30:.3f} GiB")
        del model, step
        torch.cuda.empty_cache()
    return results


def main() -> int:
    card()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc {_build.BUILD_SECONDS})")

    cfg, model, aux = build_model(dev)
    kern = check_kernel(model.geom, dev)
    sl = check_slice(model, aux, dev)
    log(f"slice: kernel step {sl['step_s']:.6f} s, plain step {sl['plain']['step_s']:.6f} s, "
        f"f32 step {sl['f32']['step_s']:.6f} s")
    shapes = {**kern, **check_attention(model.geom, dev), **check_residual(model.geom, dev),
              **check_mlp(model.geom, dev), **check_raw_mlp(model.geom, dev),
              **check_block_train(model.geom, dev)}
    tr, ref = check_train(cfg, model, aux, dev)
    log(f"train slice: kernel step {tr['step_s']:.6f} s, plain bf16 step "
        f"{tr['plain']['step_s']:.6f} s, f32 step {tr['f32']['step_s']:.6f} s")
    del model
    torch.cuda.empty_cache()
    ab = check_ab(cfg, aux, ref, dev)
    log(f"A/B: default route {tr['step_s']:.6f} s, fused_block "
        f"{ab['fused_block']['step_s']:.6f} s, unfused_tail {ab['unfused_tail']['step_s']:.6f} s")

    log("detail: " + json.dumps({"slice": sl, **shapes, "train": tr, "ab": ab}))
    # launches over the run of each kernel's path
    launches = {"fused_earth_block": sl["launches"], **tr["launches"],
                **{k: ab["unfused_tail"]["launches"][k] for k in ("fused_mlp", "fused_mlp_bwd")},
                **{k: ab["fused_block"]["launches"][k]
                   for k in ("fused_earth_block_train", "fused_earth_block_train_bwd")}}
    kernels = []
    for name, (replaces, source) in KERNELS.items():
        sh = shapes[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "pangu_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(x["max_abs_err"] for x in sh),
            "ms": mix(sh, "ms"), "plain_ms": mix(sh, "plain_ms"),
            "bound_ms": mix(sh, "bound_ms"), "bound_by": sh[0]["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
