"""Smoke run of the PyTorch port on one CUDA card: build, kernel checks, the
24 h forecast step, the train step and its two A/B routes at full geometry,
the two-kernel inference block, and the three kernel A/B scripts.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. the card's name and power limit (nvidia-smi); a CUDA card is required;
2. build the CUDA sources of pangu_tpu_torch/csrc/ with nvcc (build/kernels/),
   one nvcc per source, all at once;
3. the block kernel K1 against its plain PyTorch version, bf16, at both
   flagship stage shapes, unshifted and shifted (with the real shift mask);
   max|d| / max(1, max|ref|) < 0.04 and RMS(d) / RMS(ref) < 0.01, and the
   same bits on two runs; per-call times from CUDA events (median of 12);
4. the forecast slice: flagship ``pangu_pretrain(24)`` in bf16 with seeded
   synthetic weights and aux constants, 3 autoregressive forecast steps
   through ``make_forecast_step`` (exactly 16 kernel launches per step),
   output shapes and finiteness, one step against the plain bf16
   composition and the f32 step on the same weights and inputs (max|d| <
   0.1, RMS(d) < 0.01 in normalized units), median step times and peak
   memory; then, on a line of its own, one forecast step under
   torch.profiler (``profile_train_step.profile_forecast``): device busy
   time, idle share, time by kernel and K1 split into its two kernels, the
   window attention ``window_attention_kernel`` (mma.sync, scores and
   probabilities in registers) and the token tail ``mlp_tail_kernel``
   (wgmma/TMA);
5. the training attention K2 (the same window-attention kernel, then its
   out-projection on the wgmma product ``wg_gemm_kernel``) and its flash
   backward K3 against their plain versions at both stage shapes, unshifted
   and shifted: the forward output and all six gradients under the bounds of
   phase 3, K2 and K3 the same bits on two runs; per-call times;
6. the post-norm residual K4 and its backward K5 against their plain
   versions at both stage row counts with a branch scale, same bounds;
7. the MLP tail K6 and its backward K7 against their plain versions at both
   stage row counts with a branch scale: the output and all eight gradients,
   same bounds, K6 and K7 the same bits on two runs; then the split of K7 and K3
   into their kernels at both stages (torch.profiler) and, on a line of its
   own, the wgmma products beside one ``torch.mm`` of each (a yardstick);
8. the train slice: 1 warm-up and 3 timed flagship train steps through
   ``make_train_step`` (bf16, remat keeping the attention and MLP outputs,
   drop path 0.2 from a seeded generator, Adam): exactly 16 launches of K2,
   K3, K5, K6 and K7 and 32 of K4 (the recompute runs it again) per step,
   finite loss and gradients, changed
   parameters, median step time, peak memory and train TFLOP/s; then one
   step each of the plain bf16 composition and the f32 model from the same
   weights, batch and drop-path draws as the warm-up step: against the plain
   bf16 step the loss within 1%, the gradient's global relative L2 < 1%,
   each earth-specific bias's relative L2 < 10% and every other parameter's
   < 2% (the f32 figures are reported only);
9. the raw MLP K8 (the wgmma row kernel's raw mode) and its backward K9
   against their plain versions at both stage row counts: the output and all
   five gradients, the bounds of phase 3, K8 the same bits on two runs;
10. the training block K11 and its backward K12 (the chain of the window
   attention, the row kernel's backward mode, K7's hidden pass, K5's kernel,
   K3's attention kernel and the wgmma products) against their plain versions
   at both stage shapes, unshifted and shifted, with per-sample scales s1 !=
   s2: the output and all sixteen gradients, the bounds of phase 3, K12 the
   same bits on two runs and its peak memory; and K11 at unit scales against
   K1, the same bounds (they differ only in rounding a and x1 to bf16);
11. the A/B routes of ``pangu_tpu_torch.scripts.bench_train_ab``:
   ``fused_block`` (K11/K12, exactly 16 launches of each per step) and
   ``unfused_tail`` (K2 16 / K3 16, K4 32 / K5 16, K8 16 / K9 16): one step
   from phase 8's weights, batch and drop-path draws, finite loss and
   gradients and the bounds of phase 8 against the plain bf16 step; then 3
   timed steps through the script's helper, step time and peak memory, on one
   line beside the default route's;
12. the inference MLP tail K10 (``fused_mlp_block``) at both stage row counts
   and K2's LN-epilogue mode at both stages, unshifted and shifted, against
   their plain versions (the bounds of phase 3); K10 against K6 at s = 1
   (whether the bits are equal); the two-kernel inference block,
   ``EarthAttention3D(x, mask, epilogue=norm1)`` then ``Mlp(., ln=norm2,
   fused=True)``, against K1 on the same weights and input at both stages;
   then the path: the two-kernel block at one forecast step's mix of 2 + 2
   outer and 6 + 6 inner blocks, exactly one launch of each kernel per block;
13. the tensor-core micro-bench ``pangu_tpu_torch.scripts.bench_mxu_micro``:
   each variant at one sweep against its plain version (max|d| / max|ref| <
   1e-4 for bf16, where only the order of f32 sums differs; < 1e-6 for int8,
   whose sums are exact there), and the timed call (256 sweeps, its split and
   repeat) against 256 x the plain version (< 1e-4 for all four: there the f32
   sums pass 2^24), then the script's run: per sweep ms,
   microseconds per window, TFLOP/s (TOP/s) and ``library_ms`` of
   ``torch.einsum`` for ``loop``;
14. the attention-forward A/B ``bench_attn_fwd_ab``: ``shipped`` (K2),
   ``batched``, ``dbl`` at W = 360 and ``quad`` at W = 336 (and ``quad`` at
   360 raises) against their plain versions (phase 3's bounds) and against
   ``shipped`` with the JAX script's metric (max|d| <= 0.05); then the
   script's run, ms per call;
15. the attention-backward A/B ``bench_attn_bwd_ab``: ``shipped`` (K3) and
   ``local_accum``, all six outputs against their plain versions, the JAX
   metric against ``shipped`` (<= 0.05), ``local_accum``'s same bits on two
   runs, the refused variants raise; then the script's run, ms per call;
16. forecast and score: seeded flagship weights in bf16 written through
   ``interop.from_jax.save_params_npz``, then the ``test`` script's ``main``
   (evaluate) on that file over the synthetic store's 2024-01-01..05 at 24 h
   (3 samples) and the ``rollout`` script's ``--mode multi --lead-days 2``
   over the same range (3 inits of 2 steps), both on the kernel route
   (``--set model.compute_dtype=bfloat16 --set
   model.use_pallas_attention=true``): exactly 16 K1 launches per forecast
   step and no other kernel; all 8 ``rmse_*`` and 6 ``acc_*`` CSVs with one
   row per sample, the ERA5 level and surface-variable columns, finite
   values equal to the scores of the score step on the same weights and
   samples (float32 round trip); on the first sample the kernel route
   against the plain bf16 composition, per channel |RMSE_kernel -
   RMSE_plain| <= RMSE(pred_kernel, pred_plain) * (1 + 1e-4) (the weighted
   RMSE is a norm) and |dACC| <= 0.02; then, on a line of its own,
   evaluate's wall time per sample split into host load, H2D, forecast and
   scoring, the rollout's wall time per forecast step, peak memory, and the
   card's name and power limit.

A ``detail:`` line holds the per-shape kernel results and the slices'
numbers as JSON. The second-to-last line is a JSON object with one entry per
kernel: ``launches`` counted over the run of the kernel's path (the 3
forecast steps for K1, the 3 timed steps of the default train step for
K2-K7, of ``unfused_tail`` for K8/K9 and of ``fused_block`` for K11/K12,
phase 12's block mix for K10 and the LN mode, each script's timed run for
its variants); ``ms``, ``plain_ms`` and ``bound_ms`` the mean per launch over
one step's mix of 2 + 2 outer and 6 + 6 inner blocks (the scripts: per call
at their one shape; the micro-bench: per sweep). ``bound_ms`` is the larger
of the bytes the function must move over 3.35 TB/s and its operations over
the card's peak for their type (989 TFLOP/s for the bf16 products, 1,979
TOP/s for int8; 67 TFLOP/s for the f32 elementwise work of K4/K5), computed
from the shapes; ``library_ms`` is the time of ``torch.einsum`` for the
micro-bench's ``loop`` and null elsewhere: no single PyTorch call computes
the other functions. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import datetime, timedelta

import numpy as np
import torch

from pangu_tpu_torch import pangu_pretrain
from pangu_tpu_torch.aux import load_aux_constants, synthetic_aux_constants
from pangu_tpu_torch.cli import base_parser, build_config, load_model_and_params
from pangu_tpu_torch.config import ERA5_SURFACE_VARIABLES, ERA5_UPPER_LEVELS
from pangu_tpu_torch.data import make_loader
from pangu_tpu_torch.eval.csv_io import load_error_scores
from pangu_tpu_torch.eval.evaluate import (ACC_FAMILIES, RMSE_FAMILIES, make_field_scorer,
                                           make_score_step, to_device)
from pangu_tpu_torch.interop.from_jax import init_params, save_params_npz
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.model.attention import EarthAttention3D, shift_attention_mask
from pangu_tpu_torch.model.blocks import Mlp
from pangu_tpu_torch.ops import _build
from pangu_tpu_torch.ops import fused_block_attention as fba
from pangu_tpu_torch.ops import fused_block_train as fbt
from pangu_tpu_torch.ops import fused_epilogue as fep
from pangu_tpu_torch.ops import fused_mlp as fmlp
from pangu_tpu_torch.rollout import make_forecast_step
from pangu_tpu_torch.scripts import (bench_attn_bwd_ab, bench_attn_fwd_ab, bench_mxu_micro,
                                     bench_train_ab, profile_bwd_split, profile_train_step)
from pangu_tpu_torch.scripts import rollout as rollout_script
from pangu_tpu_torch.scripts import test as test_script
from pangu_tpu_torch.scripts.ab_common import (KERNEL_RMS_TOL, KERNEL_TOL, PEAK_BF16, PEAK_BYTES,
                                               compare, cuda_times_ms)
from pangu_tpu_torch.train import Batch, make_optimizer, make_train_step
from pangu_tpu_torch.utils.flops import train_matmul_flops

STEPS = 3
STEP_MAX_TOL, STEP_RMS_TOL = 0.1, 0.01  # normalized units, kernel vs plain and f32 steps
#: kernel vs plain bf16 train step: loss, the gradient's global relative L2, and the
#: worst relative L2 of one earth-specific bias and of one other parameter (PERF.md
#: section 6 has the readings they were set from)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 0.01, 0.01
TRAIN_BIAS_LEAF_TOL, TRAIN_LEAF_TOL = 0.1, 0.02
#: per flagship train step with remat and the config's flags, which keep the attention
#: and MLP outputs: the checkpoint recompute runs only the first residual (K4) again
TRAIN_LAUNCHES = {"fused_block_attention": 16, "fused_block_attention_bwd": 16,
                  "fused_residual_postnorm": 32, "fused_residual_postnorm_bwd": 16,
                  "fused_mlp_postnorm": 16, "fused_mlp_postnorm_bwd": 16}
#: per flagship train step on the A/B routes (the K11 route is not checkpointed)
AB_LAUNCHES = {
    "fused_block": {"fused_earth_block_train": 16, "fused_earth_block_train_bwd": 16},
    "unfused_tail": {"fused_block_attention": 16, "fused_block_attention_bwd": 16,
                     "fused_residual_postnorm": 32, "fused_residual_postnorm_bwd": 16,
                     "fused_mlp": 16, "fused_mlp_bwd": 16},
}
#: launches of each block shape per step: (stage, shifted) -> blocks
PER_STEP = {("outer", False): 2, ("outer", True): 2, ("inner", False): 6, ("inner", True): 6}
#: H100 SXM f32 CUDA-core peak (NVIDIA's data sheet; bf16, int8 and HBM3 in ab_common)
PEAK_F32 = 67e12
#: phase 16: the kernel route's overrides, the scored range of the synthetic store (3
#: samples at 24 h; the rollout: 3 inits of 2 steps) and the bounds against the plain route
KERNEL_ROUTE = ["--set", "model.compute_dtype=bfloat16", "--set", "model.use_pallas_attention=true"]
SCORE_RANGE = ["--set", "data.store=synthetic", "--set", "data.test_start=20240101",
               "--set", "data.test_end=20240105", "--set", "data.test_freq=24h"]
SCORE_TARGETS = ["2024010200", "2024010300", "2024010400"]
ROLLOUT_INITS, ROLLOUT_DAYS = ["2024010100", "2024010200", "2024010300"], 2
SCORE_RMSE_SLACK, SCORE_ACC_TOL = 1e-4, 0.02
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
    "fused_mlp_block": ("pangu_tpu/ops/fused_mlp.py:96", "fused_mlp.cu"),
    "fused_block_attention_ln": ("pangu_tpu/ops/fused_block_attention.py:188",
                                 "block_attention.cu"),
    **{f"bench_mxu_micro:{v}": ("scripts/bench_mxu_micro.py:112", "bench_mxu_micro.cu")
       for v in bench_mxu_micro.VARIANTS},
    **{f"bench_attn_fwd_ab:{v}": ("scripts/bench_attn_fwd_ab.py:165", "bench_attn_fwd_ab.cu")
       for v in ("batched", "dbl", "quad")},
    "bench_attn_bwd_ab:local_accum": ("scripts/bench_attn_bwd_ab.py:355", "bench_attn_bwd_ab.cu"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def card() -> None:
    log(card_line())
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
        "fused_mlp_block": (16 * rc2, 0, 2 * act + w_mlp + ln),
        "fused_block_attention_ln": (8 * rc2 + 4 * rtc, 0, 2 * act + tables + w_attn + ln),
    }
    mm, ew, nbytes = work[name]
    ops_ms = (mm / PEAK_BF16 + ew / PEAK_F32) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


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
            same = same_bits(f"K1 {name} {'shifted' if shifted else 'unshifted'}", (got,),
                             (fba.fused_earth_block(*args, *statics),))
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
                               rms_err=rms, same_bits=same, ms=ms, plain_ms=plain_ms,
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
    """Phase 4: the flagship forecast step on the kernel path; then its
    profile, on a line of its own."""
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
    results["profile"] = profile_train_step.profile_forecast(model, aux, upper, surface)
    log("forecast profile: " + json.dumps(results["profile"]))
    return results


def launch_counts() -> dict:
    """Every kernel's launch count."""
    return {"fused_earth_block": fba.LAUNCHES, **bench_train_ab.launch_counts(),
            "fused_mlp_block": fmlp.BLOCK_LAUNCHES,
            "fused_block_attention_ln": fba.ATTN_LN_LAUNCHES,
            **{f"bench_mxu_micro:{v}": n for v, n in bench_mxu_micro.LAUNCHES.items()},
            **{f"bench_attn_fwd_ab:{v}": n for v, n in bench_attn_fwd_ab.LAUNCHES.items()},
            "bench_attn_bwd_ab:local_accum": bench_attn_bwd_ab.LAUNCHES}


def reset_counts() -> None:
    fba.LAUNCHES = fba.ATTN_FWD_LAUNCHES = fba.ATTN_BWD_LAUNCHES = fba.ATTN_LN_LAUNCHES = 0
    fep.FWD_LAUNCHES = fep.BWD_LAUNCHES = 0
    fmlp.FWD_LAUNCHES = fmlp.BWD_LAUNCHES = fmlp.RAW_FWD_LAUNCHES = fmlp.RAW_BWD_LAUNCHES = 0
    fmlp.BLOCK_LAUNCHES = 0
    fbt.FWD_LAUNCHES = fbt.BWD_LAUNCHES = 0
    bench_mxu_micro.LAUNCHES.update(dict.fromkeys(bench_mxu_micro.LAUNCHES, 0))
    bench_attn_fwd_ab.LAUNCHES.update(dict.fromkeys(bench_attn_fwd_ab.LAUNCHES, 0))
    bench_attn_bwd_ab.LAUNCHES = 0


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


def same_bits(label: str, first, second) -> bool:
    """Raise unless two runs of a kernel gave the same bits in every output."""
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{label}: two runs on the same inputs differ")
    log(f"{label}: two runs give the same bits")
    return True


def check_products(g, dev) -> dict:
    """After phase 7: the split of K7 and K3 into their kernels at both stages
    (torch.profiler) and, beside the wgmma products, the time of one
    ``torch.mm`` of the same product, a yardstick the port never calls
    (``pangu_tpu_torch.scripts.profile_bwd_split``)."""
    res = {}
    for name, stage, c, heads in (("outer", g.outer, 192, 6), ("inner", g.inner, 384, 12)):
        r = res[name] = profile_bwd_split.backward_split(stage, c, heads, dev)
        products = [(n, round(t, 4)) for k in ("k7_kernels", "k3_kernels") for n, t in r[k]
                    if n.startswith("wg_gemm")]
        log(f"products {name}: wgmma {products}; torch.mm yardstick "
            f"{json.dumps({k: round(v, 4) for k, v in r['matmul_ms'].items()})}")
        for k in ("k7_kernels", "k3_kernels"):
            log(f"{k[:2].upper()} {name} kernels {[(n, round(t, 4)) for n, t in r[k]]}")
        torch.cuda.empty_cache()
    return res


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
                same2 = same_bits(f"K2 {label}", (got,), (fba.fused_block_attention(*fargs),))
                err = check_outputs(f"K2 {label}", {"y": compare(
                    got, fba.fused_block_attention_reference(*fargs[:7], *fargs[9:]))})
                del got
                geo = (x.numel() // c, c, heads, stage.n_type_windows, shifted)
                fwd.append(dict(stage=name, shifted=shifted, max_abs_err=err, same_bits=same2,
                                **bound("fused_block_attention", *geo),
                                ms=cuda_times_ms(lambda: fba.fused_block_attention(*fargs)),
                                plain_ms=cuda_times_ms(lambda: fba.fused_block_attention_reference(
                                    *fargs[:7], *fargs[9:]), n=6)))
                grads = fba.fused_block_attention_bwd(*bargs)
                torch.cuda.synchronize()
                same = same_bits(f"K3 {label}", grads, fba.fused_block_attention_bwd(*bargs))
                torch.cuda.reset_peak_memory_stats(dev)
                ref = fba.fused_block_attention_bwd_reference(*bargs)
                plain_peak = torch.cuda.max_memory_allocated(dev)
                err = check_outputs(f"K3 {label}", {n: compare(a, b)
                                                    for n, a, b in zip(names, grads, ref)})
                del grads, ref
                torch.cuda.empty_cache()
                bwd.append(dict(stage=name, shifted=shifted, max_abs_err=err,
                                plain_peak_bytes=plain_peak, same_bits=same,
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
            same6 = same_bits(f"K6 {name}", (got,), (fmlp.fused_mlp_postnorm(x, *weights,
                                                                              s[:, None]),))
            err = check_outputs(f"K6 {name}", {"out": compare(
                got, fmlp.fused_mlp_postnorm_reference(*fargs))})
            del got
            fwd.append(dict(stage=name, rows=rows, c=c, max_abs_err=err, same_bits=same6,
                            **bound("fused_mlp_postnorm", rows, c),
                            ms=cuda_times_ms(lambda: fmlp.fused_mlp_postnorm(
                                x, *weights, s[:, None])),
                            plain_ms=cuda_times_ms(
                                lambda: fmlp.fused_mlp_postnorm_reference(*fargs), n=6)))
            outs = fmlp.fused_mlp_postnorm_bwd(*bargs)
            torch.cuda.synchronize()
            same = same_bits(f"K7 {name}", outs, fmlp.fused_mlp_postnorm_bwd(*bargs))
            torch.cuda.reset_peak_memory_stats(dev)
            ref = fmlp.fused_mlp_postnorm_bwd_reference(*bargs)
            plain_peak = torch.cuda.max_memory_allocated(dev)
            err = check_outputs(f"K7 {name}", {n: compare(a, b)
                                               for n, a, b in zip(names, outs, ref)})
            del outs, ref
            torch.cuda.empty_cache()
            bwd.append(dict(stage=name, rows=rows, c=c, max_abs_err=err,
                            plain_peak_bytes=plain_peak, same_bits=same,
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
    counts; all five gradients; K8 the same bits on two runs."""
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
            same8 = same_bits(f"K8 {name}", (got,), (fmlp.fused_mlp(x, *weights),))
            err = check_outputs(f"K8 {name}", {"out": compare(
                got, fmlp.fused_mlp_reference(x, *weights))})
            del got
            fwd.append(dict(stage=name, rows=rows, c=c, max_abs_err=err, same_bits=same8,
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
    sixteen gradients; K12 the same bits on two runs); K11 at unit scales
    against K1."""
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
                same = same_bits(f"K12 {label}", grads, fbt.fused_earth_block_train_bwd(*bargs))
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
                bwd.append(dict(stage=name, shifted=shifted, max_abs_err=err, same_bits=same,
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


def two_kernel_modules(stage, args, c: int, heads: int, dev):
    """EarthAttention3D (kernel route) and Mlp holding one block's weights of
    ``block_inputs`` (bf16 values in f32 parameters, exactly representable),
    in eval mode."""
    attn = EarthAttention3D(c, heads, stage, use_kernel=True).to(dev).eval()
    mlp = Mlp(c).to(dev).eval()
    with torch.no_grad():
        for p, a in ((attn.linear1.weight, args[1]), (attn.linear1.bias, args[2]),
                     (attn.linear2.weight, args[3]), (attn.linear2.bias, args[4]),
                     (attn.earth_specific_bias, args[5][None]), (mlp.linear1.weight, args[9]),
                     (mlp.linear1.bias, args[10]), (mlp.linear2.weight, args[11]),
                     (mlp.linear2.bias, args[12])):
            p.copy_(a.float())
    return attn, mlp


def two_kernel_block(attn, mlp, x, mask, args):
    """The two-kernel inference block through the module entry points."""
    y = attn(x, mask, epilogue=(args[7], args[8]))
    return mlp(y, ln=(args[13], args[14]), fused=True)


def check_inference_tail(g, dev) -> dict:
    """Phase 12: K10 and K2's LN-epilogue mode against their plain versions,
    K10 against K6 at s = 1, the two-kernel block against K1; then the path,
    one forecast step's mix of blocks through the module entry points."""
    mlp_rows, ln_shapes, setups = [], [], {}
    for name, stage, c, heads in (("outer", g.outer, 192, 6), ("inner", g.inner, 384, 12)):
        for shifted in (False, True):
            args, statics = block_inputs(stage, c, heads, shifted, dev, seed=80 + len(ln_shapes))
            x, mask = args[0], args[6]
            label = f"{name} {'shifted' if shifted else 'unshifted'}"
            geo = (x.numel() // c, c, heads, stage.n_type_windows, shifted)
            fargs = (*args[:7], args[7], args[8], *statics)
            with torch.no_grad():
                got = fba.fused_block_attention(*fargs)
                torch.cuda.synchronize()
                err = check_outputs(f"K2 LN {label}", {"y": compare(
                    got, fba.fused_block_attention_reference(*args[:7], *statics, args[7],
                                                             args[8]))})
                ln_shapes.append(dict(stage=name, shifted=shifted, max_abs_err=err,
                                      **bound("fused_block_attention_ln", *geo),
                                      ms=cuda_times_ms(lambda: fba.fused_block_attention(*fargs)),
                                      plain_ms=cuda_times_ms(
                                          lambda: fba.fused_block_attention_reference(
                                              *args[:7], *statics, args[7], args[8]), n=6)))
                attn, mlp = two_kernel_modules(stage, args, c, heads, dev)
                two = two_kernel_block(attn, mlp, x, mask, args)
                check_outputs(f"two-kernel block vs K1 {label}", {"out": compare(
                    two, fba.fused_earth_block(*args, *statics))})
                del got, two
                if not shifted:  # K10 does not see the shift: one row shape per stage
                    rows2 = x.reshape(-1, c)
                    margs = (rows2, *args[9:13], args[13], args[14])
                    got = fmlp.fused_mlp_block(*margs)
                    torch.cuda.synchronize()
                    err = check_outputs(f"K10 {name}", {"out": compare(
                        got, fmlp.fused_mlp_block_reference(*margs))})
                    k6 = fmlp.fused_mlp_postnorm(*margs, torch.ones(rows2.shape[0], 1,
                                                                   device=dev))
                    same = torch.equal(got, k6)
                    d6 = (got.float() - k6.float()).abs().max().item()
                    log(f"K10 {name} against K6 at s = 1: same bits {same}, max|d| {d6:.6g}")
                    del got, k6
                    mlp_rows.append(dict(stage=name, rows=rows2.shape[0], c=c, max_abs_err=err,
                                         equals_k6=same, **bound("fused_mlp_block", *geo[:2]),
                                         ms=cuda_times_ms(lambda: fmlp.fused_mlp_block(*margs)),
                                         plain_ms=cuda_times_ms(
                                             lambda: fmlp.fused_mlp_block_reference(*margs), n=6)))
            setups[(name, shifted)] = (attn, mlp, x, mask, args)
            log(f"K2 LN {label}: kernel {ln_shapes[-1]['ms']:.4f} ms, plain "
                f"{ln_shapes[-1]['plain_ms']:.4f} ms, bound {ln_shapes[-1]['bound_ms']:.4f} ms")
    for sh in mlp_rows:
        log(f"K10 {sh['stage']} rows={sh['rows']}: kernel {sh['ms']:.4f} ms, plain "
            f"{sh['plain_ms']:.4f} ms, bound {sh['bound_ms']:.4f} ms")
    # the path: one forecast step's mix of blocks through the module entry points
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for key, n in PER_STEP.items():
            attn, mlp, x, mask, args = setups[key]
            for _ in range(n):
                out = two_kernel_block(attn, mlp, x, mask, args)
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"two-kernel block {key} is not finite")
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    counts = launch_counts()
    want = {k: (16 if k in ("fused_mlp_block", "fused_block_attention_ln") else 0) for k in counts}
    if counts != want:
        raise AssertionError(f"two-kernel block path launches {counts}, want {want}")
    log(f"two-kernel block path: 16 blocks (2 + 2 outer, 6 + 6 inner), 16 launches of K2 LN "
        f"and of K10, {path_s:.6f} s")
    del setups
    torch.cuda.empty_cache()
    return {"fused_mlp_block": mlp_rows, "fused_block_attention_ln": ln_shapes}, dict(
        path_s=path_s, launches={k: v for k, v in counts.items() if v})


def check_script(name: str, module, checks: dict, refused, dev) -> tuple:
    """Phases 13-15: a script's variants were checked (``checks``); each
    refused variant must raise ValueError; then the script's timed run, with
    the launch counts read around it."""
    bad = [v for v, c in checks.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"{name}: {bad} disagree with their plain versions")
    for v, call in refused:
        try:
            call(v)
        except ValueError as e:
            log(f"{name} {v} refused: {e}")
        else:
            raise AssertionError(f"{name}: {v} did not raise")
    reset_counts()
    res = module.run(checked=False, device=dev)
    prefix = module.__name__.rsplit(".", 1)[-1] + ":"  # the script's own kernels
    counts = {k: v for k, v in launch_counts().items() if v and k.startswith(prefix)}
    for v, r in res.items():
        r.update(checks.get(v, {}))
        log(f"{name} {v}: " + json.dumps({k: x for k, x in r.items() if k != "outputs"}))
    torch.cuda.empty_cache()
    return res, counts


def check_mxu_micro(dev) -> tuple:
    """Phase 13: each micro-bench variant against its plain version at one
    sweep and at the timed call's sweeps, then the script's run."""
    qkv, qkv8 = bench_mxu_micro.make_inputs(dev)
    checks = {v: bench_mxu_micro.check(v, qkv8 if v == "loop_int8" else qkv)
              for v in bench_mxu_micro.VARIANTS}
    del qkv, qkv8
    return check_script("mxu micro", bench_mxu_micro, checks, (), dev)


def check_attn_fwd_ab(dev) -> tuple:
    """Phase 14: each forward variant against its plain version and against
    shipped (the JAX metric); quad at W = 360 raises; then the script's run."""
    m = bench_attn_fwd_ab
    base, bias = m.make_args(dev)
    tables, ship_cache, checks = {}, {}, {}
    for v in m.VARIANTS:
        checks[v] = m.compare_variant(v, m.variant_args(v, base, bias, tables), bias, ship_cache)
        log(f"attn fwd A/B {v}: " + json.dumps(checks[v]))
    quad360 = (*base, bias)  # refused on the lon-window count before the table is read
    del tables, ship_cache
    res = check_script("attn fwd A/B", m, checks,
                       [("quad at W=360", lambda v: m.variant_call("quad", *quad360))], dev)
    del base, bias, quad360
    torch.cuda.empty_cache()
    return res


def check_attn_bwd_ab(dev) -> tuple:
    """Phase 15: both backward variants against their plain versions,
    local_accum against shipped and itself; the refused variants raise; then
    the script's run."""
    m = bench_attn_bwd_ab
    args = m.make_args(dev)
    ship_cache = {}
    checks = {v: m.compare_variant(v, args, ship_cache) for v in m.VARIANTS}
    for v, c in checks.items():
        check_outputs(f"attn bwd A/B {v}", c["outputs"])
    log(f"attn bwd A/B local_accum: vs shipped {checks['local_accum']['vs_shipped']:.6g}, the "
        f"same bits on two runs: {checks['local_accum']['same_bits']}")
    del args, ship_cache
    torch.cuda.empty_cache()
    return check_script("attn bwd A/B", m, checks,
                        [(v, m.check_variant) for v in m.REFUSED], dev)


def score_tables(csv_dir: str, rows: list) -> dict:
    """The 8 rmse_* and 6 acc_* tables under ``csv_dir``: each with the rows
    ``rows``, the ERA5 level or surface-variable columns and finite values."""
    tables = {}
    for error, families in (("rmse", RMSE_FAMILIES), ("acc", ACC_FAMILIES)):
        for f in families:
            index, columns, values = load_error_scores(csv_dir, error, f)
            want = (list(ERA5_SURFACE_VARIABLES) if f == "surface" else
                    ["wind_speed"] if f == "surface_wind_speed" else list(ERA5_UPPER_LEVELS))
            if index != rows or columns != want or not np.isfinite(values).all():
                raise AssertionError(f"{csv_dir} {error}_{f}: rows {index} (want {rows}), "
                                     f"columns {columns}, finite {np.isfinite(values).all()}")
            tables[f"{error}_{f}"] = values
    if sorted(os.listdir(csv_dir)) != sorted(f"{k}.csv" for k in tables):
        raise AssertionError(f"{csv_dir} holds {sorted(os.listdir(csv_dir))}")
    return tables


def only_k1(label: str, want: int) -> None:
    """Raise unless the run launched K1 ``want`` times and no other kernel."""
    counts = {k: v for k, v in launch_counts().items() if v}
    log(f"{label}: kernel launches {counts} (want fused_earth_block {want})")
    if counts != {"fused_earth_block": want}:
        raise AssertionError(f"{label}: launches {counts}, want fused_earth_block {want}")


def check_forecast_and_score(dev) -> dict:
    """Phase 16: the test and rollout scripts on the kernel route, their
    launches and score tables, the tables against the score step's scores,
    and the kernel route against the plain bf16 route on the first sample."""
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "weights.npz")
        argv = ["--weights", weights, "--out", tmp, *KERNEL_ROUTE, *SCORE_RANGE]
        cfg = build_config(base_parser("").parse_args(argv))
        depth = sum(cfg.model.depths)
        with dev:
            model = PanguModel(cfg.model)
        init_params(model, seed=0)
        t0 = time.perf_counter()
        save_params_npz(weights, model)
        res["save_weights_s"] = time.perf_counter() - t0
        del model
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        aux = load_aux_constants(cfg.model, cfg.train, None, cfg.horizon, device=dev)
        model = load_model_and_params(cfg, argparse.Namespace(weights=weights), aux, device=dev)
        torch.cuda.synchronize()
        res["model_setup_s"] = time.perf_counter() - t0

        spans = {}
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        res["test_loss"] = test_script.main(argv, device=dev, spans=spans)
        res["test_main_s"] = time.perf_counter() - t0
        only_k1("test script", depth * len(SCORE_TARGETS))
        tables = score_tables(os.path.join(tmp, "test", "24", "csv"), SCORE_TARGETS)
        n = len(SCORE_TARGETS)
        res["eval_per_sample_s"] = {k: v / n for k, v in spans.items()}
        res["eval_per_sample_s"]["total"] = sum(spans.values()) / n

        steps = len(ROLLOUT_INITS) * ROLLOUT_DAYS
        reset_counts()
        t0 = time.perf_counter()
        out = rollout_script.main([*argv, "--mode", "multi", "--lead-days", str(ROLLOUT_DAYS)],
                                  device=dev)
        res["rollout_main_s"] = time.perf_counter() - t0
        only_k1("rollout script", depth * steps)
        inits = sorted(d for d in os.listdir(out) if os.path.isdir(os.path.join(out, d)))
        if inits != ROLLOUT_INITS:
            raise AssertionError(f"rollout wrote the inits {inits}, want {ROLLOUT_INITS}")
        for init in ROLLOUT_INITS:
            t = datetime.strptime(init, "%Y%m%d%H")
            score_tables(os.path.join(out, init, "csv"),
                         [(t + timedelta(days=d + 1)).strftime("%Y%m%d%H")
                          for d in range(ROLLOUT_DAYS)])
        # the script's own set-up (aux and weights) timed above on the same files
        res["rollout_per_step_s"] = (res["rollout_main_s"] - res["model_setup_s"]) / steps
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)

        # the score step on the same weights and samples gives the tables' values
        step = make_score_step(model, cfg, return_fields=True)
        first = None
        for host, periods in make_loader(cfg.data, cfg.model, "test", cfg.horizon, 1):
            batch = Batch(*(to_device(x, dev) for x in host))
            scores = {k: v.cpu().numpy() for k, v in step(batch, aux).items()
                      if not k.startswith("output")}
            row = SCORE_TARGETS.index(periods[0][1])
            for k, table in tables.items():
                if not np.array_equal(table[row], scores[k][0].astype(np.float32)):
                    raise AssertionError(f"{k} at {periods[0][1]}: the CSV holds {table[row]}, "
                                         f"the score step gives {scores[k][0]}")
            if first is None:
                first = batch, scores
        log(f"score tables: {len(tables)} files x {len(SCORE_TARGETS)} rows equal the score "
            "step's scores")
        del step

        # the kernel route against the plain bf16 composition on the first sample
        batch, kernel_scores = first
        kout = make_score_step(model, cfg, return_fields=True)(batch, aux)
        plain = PanguModel(dataclasses.replace(cfg.model, use_pallas_attention=False)).to(dev)
        plain.load_state_dict(model.state_dict())
        pout = make_score_step(plain, cfg, return_fields=True)(batch, aux)
        between = make_field_scorer(cfg)(kout["output_upper"], kout["output_surface"],
                                         pout["output_upper"], pout["output_surface"], aux)
        worst_rmse, worst_acc = 0.0, 0.0
        for f in RMSE_FAMILIES:
            k = kernel_scores[f"rmse_{f}"][0].astype(np.float64)
            p = pout[f"rmse_{f}"][0].cpu().numpy().astype(np.float64)
            norm = between[f"rmse_{f}"][0].cpu().numpy().astype(np.float64)
            gap = np.abs(k - p)
            if not (gap <= norm * (1 + SCORE_RMSE_SLACK)).all():
                raise AssertionError(f"rmse_{f}: |kernel - plain| {gap} exceeds "
                                     f"RMSE(pred_kernel, pred_plain) {norm}")
            worst_rmse = max(worst_rmse, float((gap / np.maximum(norm, 1e-30)).max()))
        for f in ACC_FAMILIES:
            d = np.abs(kernel_scores[f"acc_{f}"][0] - pout[f"acc_{f}"][0].cpu().numpy())
            worst_acc = max(worst_acc, float(d.max()))
        res["kernel_vs_plain"] = dict(worst_rmse_gap_over_norm=worst_rmse, max_acc_diff=worst_acc)
        log(f"kernel route vs plain bf16 route, first sample: worst |dRMSE| / RMSE(kernel, plain) "
            f"{worst_rmse:.6g} (bound {1 + SCORE_RMSE_SLACK}), max |dACC| {worst_acc:.6g} "
            f"(bound {SCORE_ACC_TOL})")
        if worst_acc > SCORE_ACC_TOL:
            raise AssertionError(f"ACC of the kernel route is {worst_acc} from the plain route")
        del model, plain, kout, pout, between, first, batch
        torch.cuda.empty_cache()
    res["card"] = card_line()
    log("forecast and score: " + json.dumps(
        {k: res[k] for k in ("eval_per_sample_s", "rollout_per_step_s", "peak_bytes",
                             "model_setup_s", "test_main_s", "rollout_main_s",
                             "save_weights_s", "card")}))
    return res


def main() -> int:
    card()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc {_build.BUILD_SECONDS})")

    cfg, model, aux = build_model(dev)
    model_geom = model.geom
    kern = check_kernel(model.geom, dev)
    sl = check_slice(model, aux, dev)
    log(f"slice: kernel step {sl['step_s']:.6f} s, plain step {sl['plain']['step_s']:.6f} s, "
        f"f32 step {sl['f32']['step_s']:.6f} s")
    shapes = {**kern, **check_attention(model.geom, dev), **check_residual(model.geom, dev),
              **check_mlp(model.geom, dev)}
    products = check_products(model.geom, dev)
    shapes.update({**check_raw_mlp(model.geom, dev), **check_block_train(model.geom, dev)})
    tr, ref = check_train(cfg, model, aux, dev)
    log(f"train slice: kernel step {tr['step_s']:.6f} s, plain bf16 step "
        f"{tr['plain']['step_s']:.6f} s, f32 step {tr['f32']['step_s']:.6f} s")
    del model
    torch.cuda.empty_cache()
    ab = check_ab(cfg, aux, ref, dev)
    log("A/B: " + ", ".join(
        f"{name} {r['step_s']:.6f} s, peak memory {r['peak_bytes'] / 2**30:.3f} GiB"
        for name, r in (("default route", tr), *ab.items())))

    tail, tail_path = check_inference_tail(model_geom, dev)
    shapes.update(tail)
    micro, micro_counts = check_mxu_micro(dev)
    fwd_ab, fwd_counts = check_attn_fwd_ab(dev)
    bwd_ab, bwd_counts = check_attn_bwd_ab(dev)
    score = check_forecast_and_score(dev)

    log("detail: " + json.dumps({"slice": sl, **shapes, "products": products, "train": tr,
                                 "ab": ab, "two_kernel_path": tail_path, "mxu_micro": micro,
                                 "attn_fwd_ab": fwd_ab, "attn_bwd_ab": bwd_ab,
                                 "forecast_and_score": score}))
    # launches over the run of each kernel's path
    launches = {"fused_earth_block": sl["launches"], **tr["launches"],
                **{k: ab["unfused_tail"]["launches"][k] for k in ("fused_mlp", "fused_mlp_bwd")},
                **{k: ab["fused_block"]["launches"][k]
                   for k in ("fused_earth_block_train", "fused_earth_block_train_bwd")},
                **tail_path["launches"], **micro_counts, **fwd_counts, **bwd_counts}
    scripts = {**{f"bench_mxu_micro:{v}": r for v, r in micro.items()},
               **{f"bench_attn_fwd_ab:{v}": r for v, r in fwd_ab.items()},
               **{f"bench_attn_bwd_ab:{v}": r for v, r in bwd_ab.items()}}
    kernels = []
    for name, (replaces, source) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": "pangu_tpu_torch/csrc/" + source,
                 "replaces": replaces, "launches": launches.get(name, 0)}
        if name in scripts:
            r = scripts[name]
            entry.update(max_abs_err=r.get("max_abs_err", r.get("max_abs")), ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                         library_ms=r["library_ms"])
        else:
            sh = shapes[name]
            entry.update(max_abs_err=max(x["max_abs_err"] for x in sh), ms=mix(sh, "ms"),
                         plain_ms=mix(sh, "plain_ms"), bound_ms=mix(sh, "bound_ms"),
                         bound_by=sh[0]["bound_by"], library_ms=None)
        if not entry["launches"]:
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
