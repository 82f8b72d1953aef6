"""Smoke run of the PyTorch port on the CUDA cards of one host: build, kernel
checks, the 24 h forecast step, the train step and its three A/B routes at
full geometry, the two-kernel inference block, the three kernel A/B scripts,
forecast and score, finetuning (full and LoRA), serving an exported forecast
step, the data pipeline over an npy store, data-parallel finetuning with
one process per card, the kernels on spatial slabs of the token grid (and,
on a host with several cards, finetuning with the grid sharded over them),
and the GPipe pipeline's stages on one card (and, on a host with several
cards, the pipeline over them).

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. the card's name and power limit (nvidia-smi); a CUDA card is required;
2. build the CUDA sources of pangu_tpu_torch/csrc/ with nvcc (build/kernels/),
   one nvcc per source, all at once;
3. the block kernel K1 as the forecast step calls it (the block's shift and
   real lat rows folded into its window gather; junk and NaN in the pad
   rows) against its plain PyTorch version (re-zero, roll, block, roll
   back), bf16, at both flagship stage shapes, unshifted and shifted (with
   the real shift mask); on the real rows max|d| / max(1, max|ref|) < 0.04
   and RMS(d) / RMS(ref) < 0.01, and the same bits on two runs; per-call
   times from CUDA events (median of 12), also of the call without a fold
   on the re-zeroed, rolled input (the slab route's);
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
   ``fused_block`` (K11/K12, exactly 16 launches of each per step),
   ``unfused_tail`` (K2 16 / K3 16, K4 32 / K5 16, K8 16 / K9 16) and
   ``bf16_grads`` (phase 8's route and launches, the gradients taken with
   respect to a bf16 copy of the f32 parameters and cast up once): one step
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
   microseconds per window, TFLOP/s (TOP/s) and ``library_ms`` of each
   variant's one PyTorch call (``torch.einsum`` over its heads; ``torch._int_mm``
   for ``loop_int8``);
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
   card's name and power limit;
17. finetune: flagship bf16 on the kernel route with seeded weights, the
   synthetic store's 2024-01-01..04 as the train range (2 samples: 2 steps an
   epoch) and 2024-01-05..07 as the val range (1 sample). ``Trainer.fit`` for
   2 epochs (a train-state checkpoint each epoch, one validation pass at
   epoch 2, the best params read back): exactly 16 launches of K2, K3, K5,
   K6, K7 and 32 of K4 a step, 16 of K1 for the validation forward, no
   other kernel; then ``Trainer.resume`` from ``train_1`` and epoch 2 again:
   the same losses and the same parameter bits as the uninterrupted run.
   Merged LoRA (rank 16, alpha 16) from the initial weights through the
   same Trainer for 2 steps: the same launches a step, the base weights
   untouched, ``changed_param_report`` naming exactly the targets and the
   heads. One step's LoRA gradients: the merged kernel step against the
   plain bf16 step and the unmerged form (adapter dropout 0; only K4/K5 run,
   32 and 16) against the plain bf16 unmerged step, each under phase 8's
   bounds (loss within 1%, global relative L2 < 1%); the two forms against
   each other reported (in bf16 the merged weight rounds the small delta
   away, the unmerged tap keeps it in f32). Then, on a line of its own, the
   wall time a train step split into host load, H2D and the step, the
   train-state save time and size, peak memory, and the card;
18. serving: the flagship bf16 model (seeded weights and aux constants)
   exported through ``serving.export_forecast_step`` to a ``.pt2``: the
   graph holds exactly 16 calls of the K1 operator
   ``pangu_tpu_torch::fused_earth_block`` and no other op outside aten. A
   fresh process that imports ``pangu_tpu_torch.serving`` and no
   ``pangu_tpu_torch.model`` loads it (``load_forecast_step``) and runs 3
   autoregressive steps from seeded fields: exactly 16 K1 launches a step,
   the loaded graph's 16 calls, every tensor of the artifact on the card;
   then one step under ``utils.profiling.trace``. Its first step against the
   eager ``make_forecast_step`` on the same weights and input: the same bits
   (else the bounds of phase 4, reported). Then, on a line of its own, the
   export time, the artifact's bytes, the load time, the median step time,
   peak memory, the traced step's device busy time and idle share
   (``trace_device_busy_split``) and the card; and, on another, the bf16
   route's deviation from the f32 path at flagship geometry
   (``scripts.parity_bf16_bound.run``);
19. data: the native C++ batch reader (``data/native_loader.py``, g++ of
   ``csrc/fastloader.cpp`` into build/native/) must build. The synthetic
   store's 2024-01-01..07 at 24 h (7 flagship frames, ~2.0 GB; the free disk
   checked first with ``utils.profiling.system_snapshot``) written through
   ``data.convert.convert_range`` into an npy store in a temporary
   directory; ``load_batch`` there equal to the synthetic store's arrays bit
   for bit; the ``test`` script over it (phase 16's seeded weights, range,
   targets and kernel route): exactly 16 K1 launches a step and the score
   tables equal to phase 16's; one ``Trainer.fit`` epoch over its train
   range (phase 17's config, weights and data): phase 17's launches a step
   and phase 17's first-epoch losses, to the bit; the native reader, not
   the per-sample path, assembling every batch of all three
   (``data.dataset.BATCH_READS``); the ``stats`` script on the store
   (``--limit 2``); ``read_batch`` of the 7 upper frames from the page cache
   at 1 and 8 threads (median of 3). Then, on a line of its own, the write
   seconds and bytes, the read rates, evaluate's per-sample split and the
   finetune step's split over the npy store beside phases 16's and 17's
   over the synthetic store, the stats seconds, and the card;
20. multi-GPU finetune: one rank per card (``torch.cuda.device_count()``),
   each a fresh process (this one has CUDA up, so never a fork) joined over
   NCCL through a ``file://`` store in a temporary directory, on phase 17's
   config, seeded weights and store at batch 1 per rank: under a
   data-parallel mesh with ZeRO-2 (``pangu_tpu_torch.parallel``), 2 epochs
   of one step through ``Trainer.fit`` with a train-state save after each
   and a validation pass, then the resume from ``train_1``. Per rank and
   step phase 8's launches; the same loss and parameter bits on every rank;
   the resumed step the uninterrupted step's bits; in a world of one, the
   one-process step's bits (the reduce-scatter and all-gather are copies
   there and Adam is elementwise). A rank that fails or runs past the time
   limit fails the phase with its stderr, the other ranks killed. Then, on a
   line of its own, the world size, the NCCL version, a step split into
   forward+backward, reduce-scatter, update and all-gather (each ended by a
   synchronize; the mean of steps 2 and 3, the first step apart, and each
   step's), on the card one more step of every rank under torch.profiler
   (rank 0's busy time, idle share, NCCL kernels' time and launches, top
   kernels), each
   rank's peak memory, ``zero_bytes_per_device`` of the
   parameters sharded and replicated at this world, 4 and 8, the save and
   load times and the card;
21. spatial sharding (``pangu_tpu_torch.parallel.spatial``). 21a, on one
   card: K1, K2, K3, K11 and K12 on each slab of whole windows of the
   flagship lat=2 x lon=2 plane (outer 96 x 180 and 90 x 180, inner 48 x 96
   and 48 x 84 rows x columns), with the earth bias and shift mask cut to
   the slab's lat windows, at both stages, unshifted and shifted, against
   the same windows of the whole-grid launch: forward outputs and the dx of
   K3 and K12 the same bits (else the bounds of phase 3, reported), the
   weight, bias and earth-bias gradients summed over the four slabs within
   phase 3's bounds; then each slab shape's ms per launch beside the whole
   grid's. 21b, on a host with 2 or more cards: lat=2 on 2 cards and lat=2 x
   lon=2 on 4, one fresh process per card over NCCL, 3 flagship ZeRO-2 train
   steps (data 1) of phase 8's config, weights, batch and drop-path draws on
   the ranks' slabs, phase 8's launches per rank and step, the same loss and
   parameter bits on every rank, one validation pass (16 K1 launches a
   sample on every rank, the same value), step 1's loss and gradients within
   phase 8's bounds of the one-process step on card 0, and a profiled step;
   a ``spatial:`` line per world (step wall and split, busy, NCCL time and
   launches, each rank's peak memory beside the one-process step's). With
   one card, 21b prints that it did not run and why;
22. the GPipe pipeline (``pangu_tpu_torch.parallel.pipeline``), phase 8's
   config and weights with drop path 0, the 4-way split at the U-Net joints,
   2 microbatches of one sample. 22a, on card 0 in this process: the four
   stages' modules fed one another's outputs in the transport dtype by the
   pipeline's own ``stage_forward`` / ``stage_backward``, in GPipe order
   (every forward, then every backward); the eval forward (K1, 16 launches a
   sample over the stages' 2/6/6/2 blocks) against the one-process forecast
   step of each sample (the same bits, else phase 4's bounds, reported);
   the train step's loss and gradients against the one-process step with
   ``train.accumulation_steps`` = 2 under phase 8's bounds, and whether the
   loss, the gradients and the updated parameters keep its bits; each
   stage's launches (K2-K7 by its blocks x 2) and parameter + Adam bytes.
   22b, on a host with 2 or more cards, one fresh process per card over
   NCCL: pipe=2 (2 microbatches) on 2 cards, pipe=4 (4 microbatches) and
   data=2 x pipe=2 (2) on 4; 3 steps of the global batch (microbatches x
   data samples), each rank's launches its stage's, every rank the same
   loss, step 1's loss and gathered gradients within phase 8's bounds of
   the one-process accumulation step (1-sample microbatches) on card 0,
   bits reported; steps 2-3 timed unprofiled beside that step's steps 2-3
   in rank 0's process; one profiled step a rank (NCCL time and launches,
   idle share), peak memory and parameter + Adam bytes a rank, the bubble
   (S-1)/(M+S-1). With one card, 22b prints that it did not run and why.
   Then a ``pipeline:`` line with both;
23. FuXi's cosine window attention kernel (``ops/cosine_attention.py``) at
   FuXi-Short's shape (a 90x180 token grid of 9x9 windows, C 1536, 48 heads
   of 32, batch 1), unshifted and shifted (the region labels), against its
   plain version (the chain of PyTorch calls around SDPA) under phase 3's
   bounds, and the same bits on two runs; per call the card ms (CUDA
   events around one call), the device ms (CUDA events around 20 calls
   back to back, over 20: the card never waits for the host; torch.profiler
   this late in the process has recorded none of its launches), the bound
   by bytes,
   the plain version's ms and ``library_ms``, SDPA alone on the gathered,
   normalized windows with their bias; then one bf16 FuXi-Short step with
   seeded weights (exactly 48 launches, a finite state) and a ``fuxi
   attention:`` line.

A ``detail:`` line holds the per-shape kernel results and the slices'
numbers as JSON. The second-to-last line is a JSON object with one entry per
kernel: ``launches`` counted over the run of the kernel's path (the 3
forecast steps for K1, the 3 timed steps of the default train step for
K2-K7, of ``unfused_tail`` for K8/K9 and of ``fused_block`` for K11/K12,
phase 12's block mix for K10 and the LN mode, each script's timed run for
its variants; phase 21a's launches on slabs and phase 22's on stages are
reported apart, under ``detail.slabs.launches`` and ``detail.pipeline``);
``ms``, ``plain_ms`` and ``bound_ms`` the mean per launch over one step's
mix of 2 + 2 outer and 6 + 6 inner blocks (the scripts: per call at their
one shape; the micro-bench: per sweep; FuXi's attention: the mean of its
unshifted and shifted calls, a FuXi step's even mix, launches over one
FuXi-Short step). ``bound_ms`` is the larger
of the bytes the function must move over 3.35 TB/s and its operations over
the card's peak for their type (989 TFLOP/s for the bf16 products, 1,979
TOP/s for int8; 67 TFLOP/s for the f32 elementwise work of K4/K5), computed
from the shapes; ``library_ms`` is the time of the micro-bench variants'
one PyTorch call (``torch.einsum``, ``torch._int_mm``), for FuXi's attention
SDPA's call alone (a yardstick: it leaves out the norms and the gathers),
and null elsewhere: no single PyTorch call computes the other functions. The last line is ``{"ok": true, "device": {...}}``.
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

from pangu_tpu_torch import dtype_of, pangu_pretrain, pangu_tiny
from pangu_tpu_torch.aux import load_aux_constants, norm_back_data, synthetic_aux_constants
from pangu_tpu_torch.cli import base_parser, build_config, load_model_and_params
from pangu_tpu_torch.config import (DataConfig, ERA5_SURFACE_VARIABLES, ERA5_UPPER_LEVELS,
                                    ParallelConfig)
from pangu_tpu_torch.data import make_loader, native_loader
from pangu_tpu_torch.data.convert import convert_range
from pangu_tpu_torch.data.dataset import (BATCH_READS, Era5Dataset, NpyStore, SyntheticStore,
                                          date_range)
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
from pangu_tpu_torch.ops import cosine_attention as fca
from pangu_tpu_torch.rollout import make_forecast_step
from pangu_tpu_torch import serving
from pangu_tpu_torch.scripts import (bench_attn_bwd_ab, bench_attn_fwd_ab, bench_mxu_micro,
                                     bench_train_ab, parity_bf16_bound, profile_bwd_split,
                                     profile_train_step)
from pangu_tpu_torch.scripts import rollout as rollout_script
from pangu_tpu_torch.scripts import stats as stats_script
from pangu_tpu_torch.scripts import test as test_script
from pangu_tpu_torch.scripts.ab_common import (KERNEL_RMS_TOL, KERNEL_TOL, PEAK_BF16, PEAK_BYTES,
                                               compare, cuda_times_ms)
from pangu_tpu_torch.scripts.ab_common import bound as ab_bound
from pangu_tpu_torch.train import Batch, make_optimizer, make_train_step
from pangu_tpu_torch.train import checkpoint as ckpt
from pangu_tpu_torch.train.lora import (LoraConfig, attach_lora, changed_param_report,
                                        flatten_trainable, init_lora_params,
                                        lora_target_paths, make_lora_eval_step,
                                        make_lora_train_step, merge_params, set_lora_form)
from pangu_tpu_torch.train.schedule import multistep_lr
from pangu_tpu_torch.train.step import loss_fn, output_loss, set_scheduled_lr
from pangu_tpu_torch.train.trainer import Trainer, epoch_generator
from pangu_tpu_torch.parallel import activate_mesh, distributed_init, make_mesh, pipeline
from pangu_tpu_torch.parallel.mesh import Mesh
from pangu_tpu_torch.parallel.sharding import ShardedOptimizer, zero_bytes_per_device
from pangu_tpu_torch.utils import profiling
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
#: per flagship train step on the A/B routes (the K11 route is not checkpointed;
#: bf16_grads runs the default route with grads_dtype="bfloat16")
AB_LAUNCHES = {
    "fused_block": {"fused_earth_block_train": 16, "fused_earth_block_train_bwd": 16},
    "unfused_tail": {"fused_block_attention": 16, "fused_block_attention_bwd": 16,
                     "fused_residual_postnorm": 32, "fused_residual_postnorm_bwd": 16,
                     "fused_mlp": 16, "fused_mlp_bwd": 16},
    "bf16_grads": TRAIN_LAUNCHES,
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
#: phase 17: the synthetic store's train range (2 samples at 24 h: 2 steps an epoch at
#: batch 1) and val range (1 sample), the epochs, the LoRA rank and alpha (the reference's)
FINETUNE_DATA = dict(store="synthetic", train_start="20240101", train_end="20240104",
                     train_freq="24h", val_start="20240105", val_end="20240107",
                     val_freq="24h")
FINETUNE_EPOCHS, LORA_RANK, LORA_ALPHA = 2, 16, 16.0
#: phase 19: the synthetic store's frames written to an npy store (phase 16's scored range
#: and phase 17's train and val ranges: 7 frames at 24 h, ~2.0 GB at flagship), the free
#: disk it asks for over the bytes it writes, the frames the stats script reads, the
#: read_batch thread counts timed from the page cache and the timed reads at each
DATA_RANGE = ("20240101", "20240107", "24h")
DISK_MARGIN, STATS_LIMIT = 2.0, 2
READ_THREADS, READ_REPEATS = (1, 8), 3
#: phase 18: the process that serves the exported step. It imports the serving module
#: and the profiling tools, never the model; argv: artifact, input fields, output path,
#: trace directory, steps, device. Prints one JSON line.
SERVE = r"""
import json, sys, time
import torch
from pangu_tpu_torch import serving
from pangu_tpu_torch.ops import fused_block_attention as fba
from pangu_tpu_torch.utils import profiling

path, inputs, outputs, trace_dir, steps, dev = sys.argv[1:]
dev = torch.device(dev)
cuda = dev.type == "cuda"
sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
t0 = time.perf_counter()
step = serving.load_forecast_step(path)
sync()
load_s = time.perf_counter() - t0
fields = torch.load(inputs)
u, s = fields["upper"].to(dev), fields["surface"].to(dev)
if cuda:
    torch.cuda.reset_peak_memory_stats(dev)
times, launches = [], []
for i in range(int(steps)):
    fba.LAUNCHES = 0
    t0 = time.perf_counter()
    u, s = step(u, s)
    sync()
    times.append(time.perf_counter() - t0)
    launches.append(fba.LAUNCHES)
    if i == 0:
        torch.save({"upper": u.cpu(), "surface": s.cpu()}, outputs)
peak = torch.cuda.max_memory_allocated(dev) if cuda else None
fba.LAUNCHES = 0
with profiling.trace(trace_dir):
    t0 = time.perf_counter()
    step(u, s)
    sync()
    traced_ms = (time.perf_counter() - t0) * 1e3
program = step.program
print(json.dumps(dict(
    load_s=load_s, step_times_s=times, launches=launches, traced_launches=fba.LAUNCHES,
    peak_bytes=peak, traced_step_ms=traced_ms,
    busy=profiling.trace_device_busy_split(trace_dir),
    graph_ops=dict(serving.graph_ops(program)),
    devices=sorted({str(t.device) for t in (*program.state_dict.values(),
                                            *program.constants.values())}),
    finite=bool(torch.isfinite(u).all() and torch.isfinite(s).all()),
    model_modules=sorted(m for m in sys.modules if m.startswith("pangu_tpu_torch.model")))))
"""

#: phase 20: the seconds the ranks may take together, and a rank of the multi-GPU
#: finetune: a fresh process (never a fork of this CUDA process) that imports this
#: file; argv: the rank's spec as JSON. Prints one JSON line last.
MULTI_GPU_TIMEOUT_S = 600
RANK = r"""
import json, sys
import chip_smoke
print(json.dumps(chip_smoke.multi_gpu_rank(json.loads(sys.argv[1]))), flush=True)
"""

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
    "cosine_window_attention": ("none: the JAX package has no FuXi; the port's SDPA chain in "
                                "model/fuxi.py", "cosine_window_attention.cu"),
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
    """Phase 3: the kernel as the main path calls it, with the block's shift
    and real rows (the folded gather), against its plain version (re-zero,
    roll, block, roll back) at the main path's shapes (``g``, the flagship
    model's geometry); the input's pad rows hold junk (large values, NaN in
    the last row), which the kernel must read as zeros, so the real rows are
    compared. Per shape also ``unfolded_ms``: the call without a fold (the
    slab route's) on the re-zeroed, rolled input. Returns per-shape times."""
    shapes = []
    for name, stage, c, heads, per_step in (("outer", g.outer, 192, 6, 2),
                                            ("inner", g.inner, 384, 12, 6)):
        for shifted in (False, True):
            label = f"K1 {name} {'shifted' if shifted else 'unshifted'}"
            args, statics = block_inputs(stage, c, heads, shifted, dev, seed=len(shapes))
            h, shift = stage.h, [w // 2 if shifted else 0 for w in stage.window]
            x = args[0]
            x[:, :, h:] = 3e4
            x[:, :, -1] = float("nan")
            fold = dict(shift=shift, h=h)
            got = fba.fused_earth_block(*args, *statics, **fold)[:, :, :h]
            torch.cuda.synchronize()
            same = same_bits(label, (got,),
                             (fba.fused_earth_block(*args, *statics, **fold)[:, :, :h],))
            ref = fba.fused_earth_block_folded_reference(*args, *statics, shift, h)[:, :, :h]
            d = (got.float() - ref.float())
            max_abs = d.abs().max().item()
            rms = d.pow(2).mean().sqrt().item()
            ref_max = ref.float().abs().max().item()
            ref_rms = ref.float().pow(2).mean().sqrt().item()
            del got, ref, d
            ms = cuda_times_ms(lambda: fba.fused_earth_block(*args, *statics, **fold))
            plain_ms = cuda_times_ms(
                lambda: fba.fused_earth_block_folded_reference(*args, *statics, shift, h))
            rezeroed = torch.nn.functional.pad(x[:, :, :h], (0, 0, 0, 0, 0, x.shape[2] - h))
            rolled = torch.roll(rezeroed, [-s for s in shift], dims=(1, 2, 3))
            unfolded_ms = cuda_times_ms(lambda: fba.fused_earth_block(rolled, *args[1:], *statics))
            del rezeroed, rolled
            log(f"kernel {name} {'shifted' if shifted else 'unshifted'} x={tuple(x.shape)} "
                f"h={h} shift={shift} heads={heads}: max|d|={max_abs:.6g} rms(d)={rms:.6g} "
                f"max|ref|={ref_max:.6g} rms(ref)={ref_rms:.6g}; kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, unfolded call {unfolded_ms:.4f} ms")
            if not max_abs / max(1.0, ref_max) < KERNEL_TOL or not rms / ref_rms < KERNEL_RMS_TOL:
                raise AssertionError(f"kernel disagrees with its plain version at {name}")
            shapes.append(dict(stage=name, shifted=shifted, shape=list(x.shape), h=h,
                               shift=shift, heads=heads, launches_per_step=per_step,
                               max_abs_err=max_abs, rms_err=rms, same_bits=same, ms=ms,
                               plain_ms=plain_ms, unfolded_ms=unfolded_ms,
                               **bound("fused_earth_block", x.numel() // c, c, heads,
                                       stage.n_type_windows, shifted)))
            del args, x
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


def train_batch(aux, m, dev, rows: int = 1) -> Batch:
    """Seeded physical-unit inputs and targets (targets: inputs plus noise)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    inputs = [aux.upper_mean + aux.upper_std * torch.randn(
        (rows, m.upper_vars, m.levels, m.lat, m.lon), generator=gen, device=dev),
        aux.surface_mean + aux.surface_std * torch.randn(
        (rows, m.surface_vars, m.lat, m.lon), generator=gen, device=dev)]
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
            vcfg = cfg.replace(model=dataclasses.replace(
                cfg.model, grads_dtype=bench_train_ab.variant_config(name).model.grads_dtype))
            model = PanguModel(vcfg.model).to(dev)
            model.load_state_dict(ref["w0"])
            step = make_train_step(model, vcfg, make_optimizer(model, vcfg))
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


def write_weights(cfg, dev, path: str) -> float:
    """Seeded weights of ``cfg.model`` (seed 0, drawn on the host, so the
    same on every call) saved through ``save_params_npz``; returns the
    save's seconds."""
    with dev:
        model = PanguModel(cfg.model)
    init_params(model, seed=0)
    t0 = time.perf_counter()
    save_params_npz(path, model)
    seconds = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    return seconds


def check_forecast_and_score(dev) -> dict:
    """Phase 16: the test and rollout scripts on the kernel route, their
    launches and score tables, the tables against the score step's scores,
    and the kernel route against the plain bf16 route on the first sample.
    ``res["tables"]`` keeps the test script's tables for phase 19."""
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "weights.npz")
        argv = ["--weights", weights, "--out", tmp, *KERNEL_ROUTE, *SCORE_RANGE]
        cfg = build_config(base_parser("").parse_args(argv))
        depth = sum(cfg.model.depths)
        res["save_weights_s"] = write_weights(cfg, dev, weights)

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
        tables = res["tables"] = score_tables(os.path.join(tmp, "test", "24", "csv"),
                                              SCORE_TARGETS)
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


class Scalars:
    """A writer for the Trainer: its scalars by epoch."""

    def __init__(self):
        self.by_epoch = {}

    def add_scalars(self, tag, values, epoch):
        self.by_epoch[epoch] = dict(values)


def want_launches(steps: int, val_samples: int = 0) -> dict:
    """Every kernel's launches over ``steps`` flagship default-route train
    steps and ``val_samples`` eval forwards (K1, once per block: 16)."""
    want = {k: TRAIN_LAUNCHES.get(k, 0) * steps for k in launch_counts()}
    want["fused_earth_block"] = TRAIN_LAUNCHES["fused_block_attention"] * val_samples
    return want


def check_launches(label: str, want: dict) -> dict:
    got = launch_counts()
    log(f"{label}: kernel launches {({k: v for k, v in got.items() if v})}")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")
    return {k: v for k, v in got.items() if v}


def lora_grads(model, cfg, tree, lcfg, batch, aux, dev, unmerged: bool = False):
    """One training forward and backward of ``model`` with ``tree`` attached
    (phase 8's drop-path draws): (loss, the tree's gradients by name)."""
    for t in flatten_trainable(tree).values():
        t.grad = None
    set_lora_form(model, tree, lcfg, unmerged)
    model.train()
    loss = loss_fn(model, batch, aux, cfg, torch.Generator(device=dev).manual_seed(3))
    loss.backward()
    return loss.item(), {k: t.grad.float().clone() for k, t in flatten_trainable(tree).items()}


def lora_deviation(label: str, loss0: float, g0: dict, loss: float, g_ref: dict,
                   hold: bool = True) -> dict:
    """One step's LoRA loss and gradients against a reference step's; with
    ``hold``, phase 8's bounds: the loss within 1%, the global relative L2
    below 1%."""
    d2 = sum((g0[k] - g_ref[k]).pow(2).sum().item() for k in g_ref)
    n2 = sum(g.pow(2).sum().item() for g in g_ref.values())
    rel_l2, loss_dev = math.sqrt(d2 / n2), abs(loss0 - loss) / abs(loss)
    log(f"{label}: loss {loss0:.6g} vs {loss:.6g} (rel {loss_dev:.6g}), gradient rel L2 "
        f"{rel_l2:.6g} over {len(g_ref)} tensors" + ("" if hold else " (reported, no bound)"))
    if hold and not (loss_dev < TRAIN_LOSS_TOL and rel_l2 < TRAIN_GRAD_TOL):
        raise AssertionError(f"{label}: out of phase 8's bounds")
    return dict(loss_rel_dev=loss_dev, grad_rel_l2=rel_l2)


def per_step(spans: dict, steps: int) -> dict:
    """The train loop's spans a step (the checkpoints' ``save`` apart)."""
    loop = {k: v / steps for k, v in spans.items() if k != "save"}
    return {**loop, "total": sum(loop.values())}


def finetune_config(data: dict, tiny: bool = False):
    """Phase 17's run: flagship bf16 on the kernel route, batch 1, 2 epochs,
    a train-state checkpoint each epoch, validation at the last; ``data``
    the DataConfig's fields; ``tiny``: the tiny preset instead (the CPU
    tests' geometry)."""
    kw = dict(compute_dtype="bfloat16", use_pallas_attention=True)
    cfg = pangu_tiny(**kw) if tiny else pangu_pretrain(24, **kw)
    return cfg.replace(data=DataConfig(**data), train=dataclasses.replace(
        cfg.train, epochs=FINETUNE_EPOCHS, batch_size=1, save_interval=1,
        val_interval=FINETUNE_EPOCHS))


def record_losses(trainer: Trainer) -> list:
    """Each train step's loss, in order, as the trainer runs its steps."""
    losses, step = [], trainer.train_step

    def recorded(batch, aux, gen):
        loss = step(batch, aux, gen)
        losses.append(loss.detach().clone())
        return loss

    trainer.train_step = recorded
    return losses


def check_finetune(dev) -> dict:
    """Phase 17: full finetuning through ``Trainer.fit`` (2 epochs of 2
    steps, a checkpoint each epoch, one validation pass, the best params),
    its resume from ``train_1`` against the uninterrupted run, then merged
    LoRA through the same Trainer and the LoRA gradients against the plain
    bf16 route and the unmerged form. ``res["step_losses"]`` keeps the fit's
    losses by step for phase 19."""
    res = {}
    cfg = finetune_config(FINETUNE_DATA)
    m = cfg.model
    aux = synthetic_aux_constants(m, cfg.train, seed=0, device=dev)
    with dev:  # parameters allocated there; .to moves the shift masks built from numpy
        model = PanguModel(m).to(dev)
    init_params(model, seed=0)
    w0 = {k: v.clone() for k, v in model.state_dict().items()}
    train = make_loader(cfg.data, m, "train", cfg.horizon, 1)
    val = make_loader(cfg.data, m, "val", cfg.horizon, 1)
    steps = len(train)
    with tempfile.TemporaryDirectory() as tmp:
        # -- full finetuning, uninterrupted
        writer, spans = Scalars(), {}
        trainer = Trainer(cfg, model, aux, tmp, writer=writer, steps_per_epoch=steps)
        step_losses = record_losses(trainer)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        best, state = trainer.fit(train, val, spans=spans)
        res["fit_s"] = time.perf_counter() - t0
        res["step_losses"] = [float(x) for x in step_losses]
        res["fit_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        n = FINETUNE_EPOCHS * steps
        res["fit_launches"] = check_launches(f"finetune fit ({n} steps, 1 val sample)",
                                             want_launches(n, 1))
        res["fit_per_step_s"] = per_step(spans, n)
        losses = writer.by_epoch[FINETUNE_EPOCHS]
        if not (state.step == n and all(map(math.isfinite, losses.values()))):
            raise AssertionError(f"finetune: {state.step} updates, losses {losses}")
        models = os.path.join(tmp, "models")
        if sorted(os.listdir(models)) != ["best"] + [f"train_{e}" for e in (1, 2)]:
            raise AssertionError(f"checkpoints {sorted(os.listdir(models))}")
        named = dict(model.named_parameters())
        if not all(torch.equal(best[k], named[k]) for k in best):
            raise AssertionError("best/ (epoch 2, the only validation) is not the final params")
        final = {k: p.detach().clone() for k, p in named.items()}
        res["save_train_state_s"] = spans["save"] / FINETUNE_EPOCHS
        res["train_state_bytes"] = os.path.getsize(
            os.path.join(models, "train_1", ckpt.STATE_FILE))
        log(f"finetune fit: {n} steps, epoch {FINETUNE_EPOCHS} losses {losses}, fit "
            f"{res['fit_s']:.3f} s, per step {res['fit_per_step_s']}, peak memory "
            f"{res['fit_peak_bytes'] / 2**30:.3f} GiB, train-state save "
            f"{res['save_train_state_s']:.3f} s for {res['train_state_bytes']} B")
        del trainer, state, best

        # -- resume from train_1: epoch 2 again, from the checkpoint (saving no train state)
        writer2 = Scalars()
        no_saves = cfg.replace(train=dataclasses.replace(cfg.train,
                                                         save_interval=FINETUNE_EPOCHS + 1))
        trainer = Trainer(no_saves, model, aux, tmp, writer=writer2, steps_per_epoch=steps)
        t0 = time.perf_counter()
        state, start = trainer.resume(epoch=1)
        torch.cuda.synchronize(dev)
        res["resume_s"] = time.perf_counter() - t0
        reset_counts()
        trainer.fit(train, val, start_epoch=start, state=state)
        check_launches("finetune resumed epoch", want_launches(steps, 1))
        if writer2.by_epoch[FINETUNE_EPOCHS] != losses:
            raise AssertionError(f"resumed epoch: {writer2.by_epoch} vs {losses}")
        differ = [k for k, p in model.named_parameters() if not torch.equal(p, final[k])]
        if start != 2 or differ:
            raise AssertionError(f"the resumed run (start {start}) differs in {differ[:5]}")
        log(f"resume from train_1 ({res['resume_s']:.3f} s): epoch 2 gives the same loss and "
            "parameter bits as the uninterrupted run")
        del trainer, state, final
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()

    # -- merged LoRA through the same Trainer, from the initial weights
    model.load_state_dict(w0)
    base = model.state_dict()
    lcfg = LoraConfig(rank=LORA_RANK, alpha=LORA_ALPHA, dropout=0.0)
    tree = init_lora_params(base, lcfg, torch.Generator(device=dev).manual_seed(cfg.train.seed))
    lora_cfg = cfg.replace(train=dataclasses.replace(cfg.train, epochs=1))
    with tempfile.TemporaryDirectory() as tmp:
        spans = {}
        trainer = Trainer(
            lora_cfg, model, aux, tmp, steps_per_epoch=steps,
            optimizer=make_optimizer(flatten_trainable(tree).values(), cfg),
            train_step_fn=lambda opt: make_lora_train_step(model, cfg, opt, base, lcfg, tree,
                                                           steps_per_epoch=steps),
            eval_step_fn=make_lora_eval_step(model, cfg, base, lcfg, tree))
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        _, state = trainer.fit(train, spans=spans)
        res["lora_fit_s"] = time.perf_counter() - t0
        res["lora_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        res["lora_launches"] = check_launches(f"merged LoRA fit ({steps} steps)",
                                              want_launches(steps))
        res["lora_per_step_s"] = per_step(spans, steps)
        del trainer, state
    if not all(torch.equal(base[k], w0[k]) for k in w0):
        raise AssertionError("merged LoRA changed a base weight")
    changed = changed_param_report(w0, merge_params(w0, tree, lcfg))
    want = sorted(lora_target_paths(w0, lcfg) + list(tree["full"]))
    if sorted(changed) != want:
        raise AssertionError(f"LoRA changed {len(changed)} params, want the {len(want)} "
                             "targets and heads")
    log(f"merged LoRA: {steps} steps, {res['lora_fit_s']:.3f} s, per step "
        f"{res['lora_per_step_s']}, peak memory {res['lora_peak_bytes'] / 2**30:.3f} GiB; "
        f"changed: the {len(changed)} targets and heads only")

    # -- one step's LoRA gradients, merged and unmerged (adapter dropout 0): the
    #    kernel route against the plain bf16 route under phase 8's bounds; the two
    #    forms against each other reported (in bf16 they round differently: the
    #    merged weight rounds the small delta into W, the unmerged tap keeps it in f32)
    host, _ = next(iter(train))
    batch = Batch(*(to_device(x, dev) for x in host))
    loss_k, g_k = lora_grads(model, cfg, tree, lcfg, batch, aux, dev)
    reset_counts()
    loss_u, g_u = lora_grads(model, cfg, tree, lcfg, batch, aux, dev, unmerged=True)
    unmerged_want = dict.fromkeys(launch_counts(), 0)
    unmerged_want.update(fused_residual_postnorm=32, fused_residual_postnorm_bwd=16)
    check_launches("unmerged LoRA step", unmerged_want)
    with dev:
        plain = PanguModel(dataclasses.replace(m, use_pallas_attention=False)).to(dev)
    plain.load_state_dict(w0)
    ptree = {"lora": {k: {ab: t.detach().clone().requires_grad_() for ab, t in v.items()}
                      for k, v in tree["lora"].items()},
             "full": {k: torch.nn.Parameter(t.detach().clone()) for k, t in tree["full"].items()}}
    attach_lora(plain, ptree, lcfg)
    reset_counts()
    loss_p, g_p = lora_grads(plain, cfg, ptree, lcfg, batch, aux, dev)
    loss_pu, g_pu = lora_grads(plain, cfg, ptree, lcfg, batch, aux, dev, unmerged=True)
    if any(launch_counts().values()):
        raise AssertionError("the plain LoRA steps launched a kernel")
    res["lora_vs_plain"] = lora_deviation("merged LoRA step vs plain bf16 step", loss_k, g_k,
                                          loss_p, g_p)
    res["unmerged_vs_plain"] = lora_deviation(
        "unmerged LoRA step (dropout 0) vs plain bf16 unmerged step", loss_u, g_u, loss_pu, g_pu)
    res["unmerged_vs_merged"] = lora_deviation("unmerged LoRA step vs merged LoRA step",
                                               loss_u, g_u, loss_k, g_k, hold=False)
    del plain, ptree, model, tree, base, w0
    torch.cuda.empty_cache()
    res["card"] = card_line()
    log("finetune: " + json.dumps(
        {k: res[k] for k in ("fit_per_step_s", "lora_per_step_s", "fit_peak_bytes",
                             "lora_peak_bytes", "save_train_state_s", "train_state_bytes",
                             "resume_s", "fit_s", "lora_fit_s", "fit_launches",
                             "lora_launches", "card")}))
    return res


def check_serving(dev) -> dict:
    """Phase 18: the flagship forecast step exported, then loaded and served
    in a fresh process that imports no model code; its first step against
    the eager step; then the bf16 route's deviation from the f32 path. (On
    the CPU, as the tests run it at tiny geometry, K1's operator runs its
    plain version: no launches and no device events.)"""
    res = {}
    cfg, model, aux = build_model(dev)
    m = model.cfg
    depth = sum(m.depths)
    launches = depth if dev.type == "cuda" else 0
    gen = torch.Generator(device=dev).manual_seed(2)
    upper = aux.upper_mean + aux.upper_std * torch.randn(
        (1, m.upper_vars, m.levels, m.lat, m.lon), generator=gen, device=dev)
    surface = aux.surface_mean + aux.surface_std * torch.randn(
        (1, m.surface_vars, m.lat, m.lon), generator=gen, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pangu24.pt2")
        t0 = time.perf_counter()
        program = serving.export_forecast_step(model, aux, path)
        res["export_s"] = time.perf_counter() - t0
        res["artifact_bytes"] = os.path.getsize(path)
        ops = serving.graph_ops(program)
        other = sorted(k for k in ops if k != serving.K1_OP and not k.startswith("aten::"))
        log(f"export: {res['export_s']:.3f} s, {res['artifact_bytes']} bytes, "
            f"{ops[serving.K1_OP]} calls of {serving.K1_OP} (want {depth}), "
            f"{sum(ops.values())} op calls in all; {card_line()}")
        if ops[serving.K1_OP] != depth or other:
            raise AssertionError(f"the exported graph holds {ops[serving.K1_OP]} K1 calls "
                                 f"(want {depth}) and the non-aten ops {other}")
        res["graph_op_calls"] = sum(ops.values())
        del program
        torch.cuda.empty_cache()

        reset_counts()
        eager = make_forecast_step(model, aux)(upper, surface)
        torch.cuda.synchronize()
        only_k1("eager step", launches)
        inputs, outputs = os.path.join(tmp, "inputs.pt"), os.path.join(tmp, "served.pt")
        torch.save({"upper": upper.cpu(), "surface": surface.cpu()}, inputs)
        root = os.path.dirname(os.path.abspath(__file__))
        env = {**os.environ, "PYTHONPATH": root}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", SERVE, path, inputs, outputs, os.path.join(tmp, "trace"),
             str(STEPS), str(dev)], cwd=root, env=env, capture_output=True, text=True,
            timeout=600)
        res["serve_process_s"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the serving process failed: {proc.stderr[-4000:]}")
        served = json.loads(proc.stdout.strip().splitlines()[-1])
        if served["model_modules"]:
            raise AssertionError(f"the serving process imported {served['model_modules']}")
        if served["launches"] != [launches] * STEPS or served["traced_launches"] != launches:
            raise AssertionError(f"served steps launched K1 {served['launches']} and "
                                 f"{served['traced_launches']} times, want {launches} each")
        if served["graph_ops"].get(serving.K1_OP) != depth:
            raise AssertionError(f"the loaded graph holds {served['graph_ops']}")
        if served["devices"] != [str(dev)] or not served["finite"]:
            raise AssertionError(f"the artifact's tensors are on {served['devices']}; "
                                 f"finite outputs: {served['finite']}")
        if dev.type == "cuda" and served["busy"] is None:
            raise AssertionError("the traced served step holds no device events")
        got = torch.load(outputs)
        got = (got["upper"].to(dev), got["surface"].to(dev))
        res["same_bits"] = all(torch.equal(a, b) for a, b in zip(got, eager))
        res["max_abs"], res["rms"] = deviation(got, eager, aux)
        log(f"served step vs eager step: same bits {res['same_bits']}, "
            f"max|d|={res['max_abs']:.6g} rms(d)={res['rms']:.6g} (normalized)")
        if not (res["max_abs"] < STEP_MAX_TOL and res["rms"] < STEP_RMS_TOL):
            raise AssertionError("the served step disagrees with the eager step")
    busy = served["busy"]
    res.update(load_s=served["load_s"], step_s=statistics.median(served["step_times_s"]),
               step_times_s=served["step_times_s"], launches_per_step=served["launches"],
               peak_bytes=served["peak_bytes"], traced_step_ms=served["traced_step_ms"],
               busy=busy, card=card_line(),
               idle_share=busy and 1.0 - busy["modules_ms"] / served["traced_step_ms"])
    log("serving: " + json.dumps(
        {k: res[k] for k in ("export_s", "artifact_bytes", "load_s", "step_s", "step_times_s",
                             "launches_per_step", "peak_bytes", "traced_step_ms", "busy",
                             "idle_share", "same_bits", "serve_process_s", "card")}))
    del model, aux, eager, got, upper, surface
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res["bf16_bound"] = parity_bf16_bound.run(device=dev)
    res["bf16_bound_s"] = time.perf_counter() - t0
    log("bf16 bound: " + json.dumps(res["bf16_bound"]))
    torch.cuda.empty_cache()
    return res


def batch_reads(label: str, want: int, before: dict) -> None:
    """Raise unless the native reader assembled ``want`` batches since
    ``before`` (a copy of ``BATCH_READS``) and the per-sample path none."""
    got = {k: BATCH_READS[k] - before[k] for k in BATCH_READS}
    log(f"{label}: batches by reader {got} (want native {want})")
    if got != {"native": want, "per_sample": 0}:
        raise AssertionError(f"{label}: batches by reader {got}, want native {want} and "
                             "per_sample 0")


def read_rate(paths: list, out: np.ndarray, threads: int) -> float:
    """GB/s of ``read_batch`` of ``paths`` into ``out`` at ``threads``: the
    median of READ_REPEATS timed reads after one untimed (page cache, the
    buffer's pages)."""
    native_loader.read_batch(paths, out, threads=threads)
    times = []
    for _ in range(READ_REPEATS):
        t0 = time.perf_counter()
        native_loader.read_batch(paths, out, threads=threads)
        times.append(time.perf_counter() - t0)
    return out.nbytes / statistics.median(times) / 1e9


def check_data(dev, score: dict, finetune: dict) -> dict:
    """Phase 19: the synthetic store's frames written through
    ``convert_range`` into an npy store; ``load_batch`` there against the
    synthetic store's arrays; the test script over it against phase 16's
    tables (``score``) and one ``Trainer.fit`` epoch over it against phase
    17's first-epoch losses (``finetune``), each batch read by the native
    reader; the stats script; ``read_batch`` rates at 1 and 8 threads."""
    res = {}
    t0 = time.perf_counter()
    if not native_loader.native_available():
        raise AssertionError("the native batch reader did not build (g++ -O3 of "
                             "pangu_tpu_torch/csrc/fastloader.cpp)")
    res["native_build_s"] = time.perf_counter() - t0
    cfg = build_config(base_parser("").parse_args([*KERNEL_ROUTE, *SCORE_RANGE]))
    m = cfg.model
    frames = date_range(*DATA_RANGE)
    frame_bytes = 4 * (m.upper_vars * m.levels + m.surface_vars) * m.lat * m.lon
    with tempfile.TemporaryDirectory() as tmp:
        snap = profiling.system_snapshot(tmp)
        res["disk_free_gb"] = snap["disk_free_gb"]
        if snap["disk_free_gb"] * 2**30 < DISK_MARGIN * len(frames) * frame_bytes:
            raise AssertionError(f"{snap['disk_free_gb']} GiB free under {tmp}: the npy store "
                                 f"needs {len(frames) * frame_bytes} B, {DISK_MARGIN}x that free")
        root = os.path.join(tmp, "npy")
        synthetic = SyntheticStore(m, cfg.data.seed)
        t0 = time.perf_counter()
        written = convert_range(synthetic, root, *DATA_RANGE, log=None)
        res["write_s"] = time.perf_counter() - t0
        files = [os.path.join(d, f) for d, _, names in os.walk(root) for f in names]
        res["write_bytes"] = sum(os.path.getsize(f) for f in files)
        log(f"npy store: {written} frames, {res['write_bytes']} B in {res['write_s']:.3f} s "
            f"({snap['disk_free_gb']} GiB were free)")
        if written != len(frames) or len(files) != 2 * len(frames):
            raise AssertionError(f"wrote {written} frames in {len(files)} files, want "
                                 f"{len(frames)} frames")

        # load_batch through the native reader: the synthetic store's arrays, bit for bit
        ds = Era5Dataset(NpyStore(root), *DATA_RANGE, cfg.horizon)
        before = dict(BATCH_READS)
        indices = [len(ds) - 1, 0]
        arrs, periods = ds.load_batch(indices)
        batch_reads("load_batch", 1, before)
        ref, ref_periods = Era5Dataset(synthetic, *DATA_RANGE, cfg.horizon).load_batch(indices)
        if periods != ref_periods or not all(np.array_equal(a, b) for a, b in zip(arrs, ref)):
            raise AssertionError("load_batch over the npy store differs from the synthetic store")
        del arrs, ref

        # read_batch from the page cache at 1 and 8 threads (the upper frames)
        uppers = sorted(f for f in files if os.sep + "upper" + os.sep in f)
        out = np.empty((len(uppers), m.upper_vars, m.levels, m.lat, m.lon), np.float32)
        res["read_batch_gbps"] = {str(n): read_rate(uppers, out, n) for n in READ_THREADS}
        res["read_batch_bytes"] = out.nbytes
        del out
        log(f"read_batch of {len(uppers)} upper frames ({res['read_batch_bytes']} B): "
            f"GB/s by thread count {res['read_batch_gbps']}")

        # evaluate over the npy store: phase 16's weights, range, launches and tables
        weights = os.path.join(tmp, "weights.npz")
        npy_range = [*SCORE_RANGE, "--set", "data.store=npy", "--set", f"data.root={root}"]
        argv = ["--weights", weights, "--out", tmp, *KERNEL_ROUTE, *npy_range]
        cfg = build_config(base_parser("").parse_args(argv))
        write_weights(cfg, dev, weights)
        spans, before = {}, dict(BATCH_READS)
        reset_counts()
        t0 = time.perf_counter()
        test_script.main(argv, device=dev, spans=spans)
        res["test_main_s"] = time.perf_counter() - t0
        only_k1("test script over the npy store", sum(m.depths) * len(SCORE_TARGETS))
        batch_reads("test script", -(-len(SCORE_TARGETS) // cfg.eval.batch_size), before)
        tables = score_tables(os.path.join(tmp, "test", "24", "csv"), SCORE_TARGETS)
        differ = [k for k in tables if not np.array_equal(tables[k], score["tables"][k])]
        if differ:
            raise AssertionError(f"the npy store's score tables {differ} differ from phase 16's")
        n = len(SCORE_TARGETS)
        res["eval_per_sample_s"] = {k: v / n for k, v in spans.items()}
        res["eval_per_sample_s"]["total"] = sum(spans.values()) / n
        log(f"test script over the npy store: the {len(tables)} tables equal phase 16's")

        # one finetune epoch over the npy store: phase 17's launches and first-epoch losses
        ft = finetune_config({**FINETUNE_DATA, "store": "npy", "root": root})
        ft = ft.replace(train=dataclasses.replace(ft.train, epochs=1,
                                                  save_interval=FINETUNE_EPOCHS))
        aux = synthetic_aux_constants(ft.model, ft.train, seed=0, device=dev)
        with dev:
            model = PanguModel(ft.model).to(dev)
        init_params(model, seed=0)
        train = make_loader(ft.data, ft.model, "train", ft.horizon, 1)
        steps = len(train)
        trainer = Trainer(ft, model, aux, os.path.join(tmp, "fit"), steps_per_epoch=steps)
        losses = record_losses(trainer)
        spans, before = {}, dict(BATCH_READS)
        reset_counts()
        t0 = time.perf_counter()
        trainer.fit(train, spans=spans)
        res["fit_s"] = time.perf_counter() - t0
        check_launches(f"finetune epoch over the npy store ({steps} steps)",
                       want_launches(steps))
        batch_reads("finetune epoch", steps, before)
        res["step_losses"] = [float(x) for x in losses]
        if res["step_losses"] != finetune["step_losses"][:steps]:
            raise AssertionError(f"losses {res['step_losses']} over the npy store, "
                                 f"{finetune['step_losses'][:steps]} in phase 17")
        res["fit_per_step_s"] = per_step(spans, steps)
        log(f"finetune epoch over the npy store: losses {res['step_losses']} equal phase 17's")
        del trainer, model, aux, train
        torch.cuda.empty_cache()

        # the stats script on the store
        t0 = time.perf_counter()
        report = stats_script.main([*npy_range, "--out", os.path.join(tmp, "stats"),
                                    "--limit", str(STATS_LIMIT)])
        res["stats_s"] = time.perf_counter() - t0
        with open(report) as f:
            head = f.readline()
        if f"{STATS_LIMIT} samples" not in head:
            raise AssertionError(f"the stats report opens with {head!r}")
    res["synthetic"] = {"eval_per_sample_s": score["eval_per_sample_s"],
                        "fit_per_step_s": finetune["fit_per_step_s"]}
    res["card"] = card_line()
    log("data: " + json.dumps(
        {k: res[k] for k in ("write_s", "write_bytes", "read_batch_gbps", "read_batch_bytes",
                             "eval_per_sample_s", "fit_per_step_s", "synthetic", "stats_s",
                             "test_main_s", "fit_s", "native_build_s", "disk_free_gb",
                             "card")}))
    return res


def param_digest(model) -> list:
    """A digest of every parameter's bits, in name order, computed where the
    parameters lie: each tensor's 32-bit words times odd per-position
    multipliers, summed modulo 2**64 (one flipped bit changes it)."""
    out = []
    for _, p in model.named_parameters():
        words = p.detach().reshape(-1).view(torch.int32).to(torch.int64)
        mult = torch.arange(words.numel(), device=words.device, dtype=torch.int64)
        out.append(int((words * (mult * _DIGEST_MULT + 1)).sum()))
    return out


#: the odd constant of ``param_digest``'s multipliers (2**64 / golden ratio, as int64)
_DIGEST_MULT = 0x9E3779B97F4A7C15 - 2**64


def multi_gpu_data(world: int) -> dict:
    """Phase 17's store and val range, with ``world`` train samples: one DP
    step an epoch at batch 1 per rank."""
    start = datetime.strptime(FINETUNE_DATA["train_start"], "%Y%m%d")
    return dict(FINETUNE_DATA, train_end=(start + timedelta(days=world + 1)).strftime("%Y%m%d"))


def multi_gpu_rank(spec: dict) -> dict:
    """One rank of phase 20 (its own process): join the group (NCCL on the
    card, gloo on the CPU), then phase 17's config, seeded weights and store
    at batch 1 per rank through ``Trainer.fit`` under a data-parallel mesh
    with ZeRO-2: 2 epochs of one step, a train-state save after each, one
    validation pass; then the resume from ``train_1`` (epoch 2 again). Each
    step's loss, launches and parameter digest are recorded. In a world of
    one, the one-process step (no mesh) on the same weights, batch and
    generator follows. Returns the records, this rank's step split, peak
    memory and, on rank 0, the ZeRO bytes and checkpoint times."""
    world, rank = spec["world"], spec["rank"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = distributed_init(spec["init"], world, rank, rank, spec["device"])
    cuda = dev.type == "cuda"
    try:
        mesh = make_mesh(ParallelConfig(data=world))
        cfg = finetune_config(multi_gpu_data(world), spec["tiny"])
        m = cfg.model
        aux = synthetic_aux_constants(m, cfg.train, seed=0, device=dev)
        with dev:
            model = PanguModel(m).to(dev)
        init_params(model, seed=0)
        w0 = {k: v.clone() for k, v in model.state_dict().items()} if world == 1 else None
        train = make_loader(cfg.data, m, "train", cfg.horizon, 1, num_shards=world, shard=rank)
        val = make_loader(cfg.data, m, "val", cfg.horizon, 1, num_shards=world, shard=rank)
        steps, split, runs, batches = len(train), {}, [], []

        def counted(opt):
            step = make_train_step(model, cfg, opt, steps, spans=split)

            def run(batch, aux_, gen):
                batches.append(batch)  # steps 1 and 2 again below, without loading them
                reset_counts()
                before = dict(split)
                loss = step(batch, aux_, gen)
                runs.append(dict(loss=loss.item(), params=param_digest(model),
                                 launches={k: v for k, v in launch_counts().items() if v},
                                 split={k: v - before.get(k, 0.0) for k, v in split.items()}))
                return loss
            return run

        out = os.path.join(spec["dir"], "finetune")
        res = dict(rank=rank, world=world)
        with activate_mesh(mesh):
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            trainer = Trainer(cfg, model, aux, out, steps_per_epoch=steps, train_step_fn=counted)
            if not isinstance(trainer.optimizer, ShardedOptimizer):
                raise AssertionError("the Trainer's optimizer is not sharded (ZeRO)")
            spans = {}
            _, state = trainer.fit(train, val, spans=spans)
            res.update(updates=state.step, save_s=spans["save"] / FINETUNE_EPOCHS,
                       checkpoints=sorted(os.listdir(os.path.join(out, "models"))),
                       state_bytes=os.path.getsize(os.path.join(out, "models", "train_1",
                                                                ckpt.STATE_FILE)))
            del trainer, state
            # the resume from train_1: epoch 2 again, saving no train state
            no_saves = cfg.replace(train=dataclasses.replace(
                cfg.train, save_interval=FINETUNE_EPOCHS + 1))
            trainer = Trainer(no_saves, model, aux, out, steps_per_epoch=steps,
                              train_step_fn=counted)
            t0 = time.perf_counter()
            state, start = trainer.resume(epoch=1)
            if cuda:
                torch.cuda.synchronize(dev)
            res["load_s"] = time.perf_counter() - t0
            trainer.fit(train, val, start_epoch=start, state=state)
            res["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
            if cuda:  # one more step under torch.profiler, on every rank (it is collective)
                step = make_train_step(model, cfg, state.opt_state, steps)
                res["profile"] = profiled_step(
                    lambda: step(batches[1], aux, epoch_generator(cfg.train.seed, 2, dev)), dev)
            del trainer, state
        res.update(runs=runs, nccl=".".join(map(str, torch.cuda.nccl.version())) if cuda else None)
        if rank == 0:
            named = dict(model.named_parameters())
            res["zero_bytes"] = {n: dict(sharded=zero_bytes_per_device(named, Mesh(None, n, 0)),
                                         replicated=zero_bytes_per_device(
                                             named, Mesh(None, n, 0), enable=False))
                                 for n in sorted({world, 4, 8})}
        if world == 1:  # the one-process step on the same weights, batch and generator
            model.load_state_dict(w0)
            step = make_train_step(model, cfg, make_optimizer(model, cfg), steps)
            loss = step(batches[0], aux, epoch_generator(cfg.train.seed, 1, dev))
            res["one_process"] = dict(loss=loss.item(), params=param_digest(model))
        return res
    finally:
        torch.distributed.destroy_process_group()


def profiled_step(fn, dev) -> dict:
    """The summary of one call of ``fn`` under torch.profiler, with the NCCL
    kernels' device ms and launches (kernels only: the profiler also lists
    each coalesced point-to-point group as a range of the same length)."""
    summary, by_name = profile_train_step._profile(fn, dev, 8)
    nccl = [v for k, v in by_name.items() if k.startswith("ncclDevKernel")]
    return dict(summary, nccl_ms=sum(ms for ms, _ in nccl), nccl_launches=sum(n for _, n in nccl))


def hold_rank_launches(label: str, got: dict, want: dict) -> None:
    """A rank's launches in one DP step against phase 8's."""
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")


def _run_ranks(world: int, spec: dict, code: str, tmp: str, timeout_s: float,
               phase: str) -> list:
    """Spawn ``world`` fresh processes of ``code`` (one per card), each given
    ``spec`` with its rank as JSON; wait, killing the others when one fails
    or the time runs out (the phase then fails with that rank's stderr);
    return each rank's last JSON line."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    procs, files = [], []
    try:
        for r in range(world):
            files.append((open(os.path.join(tmp, f"rank{r}.out"), "w"),
                          open(os.path.join(tmp, f"rank{r}.err"), "w")))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, json.dumps({**spec, "rank": r})],
                stdout=files[r][0], stderr=files[r][1], cwd=repo, env=env))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            late = time.monotonic() > deadline
            if bad or late:
                r = bad[0] if bad else codes.index(None)
                with open(os.path.join(tmp, f"rank{r}.err")) as f:
                    err = f.read()[-4000:]
                raise AssertionError(
                    f"{phase}: rank {r} " + (f"exited {codes[r]}" if bad else
                                             f"ran past {timeout_s} s") +
                    f"; its stderr:\n{err}")
            if all(c == 0 for c in codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()
    ranks = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.out")) as f:
            ranks.append(json.loads([ln for ln in f if ln.startswith("{")][-1]))
    return ranks


def check_multi_gpu(dev, world: int = 0, tiny: bool = False) -> dict:
    """Phase 20: the multi-GPU finetune, ``world`` ranks (default: one per
    card) spawned as fresh processes, joined through a ``file://`` store in a
    temporary directory (``multi_gpu_rank``). The parent waits with a
    timeout and kills the others when one fails or the time runs out; the
    phase then fails with that rank's stderr. It requires phase 8's
    launches per rank and step, the same loss and parameter bits on every
    rank, the resumed step's bits equal to the uninterrupted step's, and in
    a world of one the one-process step's bits; then prints the
    ``multi-gpu:`` line."""
    world = world or torch.cuda.device_count()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        spec = dict(world=world, init="file://" + os.path.join(tmp, "store"), dir=tmp,
                    device=dev.type, tiny=tiny)
        ranks = _run_ranks(world, spec, RANK, tmp, MULTI_GPU_TIMEOUT_S, "phase 20")
    first = ranks[0]
    want = dict(TRAIN_LAUNCHES)
    for res in ranks:
        if len(res["runs"]) != 3 or res["updates"] != 2:
            raise AssertionError(f"rank {res['rank']}: {len(res['runs'])} steps, "
                                 f"{res['updates']} updates in the fit")
        for i, run in enumerate(res["runs"]):
            hold_rank_launches(f"multi-gpu rank {res['rank']} step {i + 1}", run["launches"], want)
        for i, (run, run0) in enumerate(zip(res["runs"], first["runs"])):
            if (run["loss"], run["params"]) != (run0["loss"], run0["params"]):
                raise AssertionError(f"step {i + 1}: rank {res['rank']} differs from rank 0")
    resumed, uninterrupted = first["runs"][2], first["runs"][1]
    if (resumed["loss"], resumed["params"]) != (uninterrupted["loss"], uninterrupted["params"]):
        raise AssertionError("the resumed step differs from the uninterrupted step")
    if first["checkpoints"] != ["best", "train_1", "train_2"]:
        raise AssertionError(f"checkpoints {first['checkpoints']}")
    if world == 1:
        one = first["one_process"]
        if (one["loss"], one["params"]) != (first["runs"][0]["loss"], first["runs"][0]["params"]):
            raise AssertionError(f"world 1: the mesh step (loss {first['runs'][0]['loss']!r}) "
                                 f"differs from the one-process step (loss {one['loss']!r})")
    # the first step pays the first collective's communicator set-up: steps 2 and 3 apart
    later = [r["split"] for r in first["runs"][1:]]
    split = {k: statistics.mean(s[k] for s in later) for k in later[0]}
    split["total"] = sum(split.values())
    line = dict(world=world, nccl=first["nccl"], step_split_s=split,
                step_splits_s=[r["split"] for r in first["runs"]], profile=first.get("profile"),
                losses=[r["loss"] for r in first["runs"]],
                peak_bytes=[r["peak_bytes"] for r in ranks], zero_bytes=first["zero_bytes"],
                save_s=first["save_s"], load_s=first["load_s"],
                state_bytes=first["state_bytes"], card=card_line())
    log(f"multi-gpu: world {world}: every rank the same loss and parameter bits in each of "
        "3 steps, the resume the uninterrupted step's bits" +
        (", the one-process step's bits" if world == 1 else ""))
    log("multi-gpu: " + json.dumps(line))
    return line


#: phase 21: the flagship plane of 21a's slabs (lat, lon), 21b's worlds (cards, mesh axes)
#: and the seconds their ranks may take together
SLAB_PLANE = (2, 2)
SPATIAL_WORLDS = ((2, dict(lat=2)), (4, dict(lat=2, lon=2)))
SPATIAL_TIMEOUT_S = 600
SPATIAL_RANK = r"""
import json, sys
import chip_smoke
print(json.dumps(chip_smoke.spatial_rank(json.loads(sys.argv[1]))), flush=True)
"""


def _place_types(t: torch.Tensor, slab, like: torch.Tensor) -> torch.Tensor:
    """A slab's per-window-type gradient (dbias) put at its types of a
    zero tensor shaped as the whole table ``like``."""
    nz = slab.stage.z // slab.stage.window[0]
    a, b = slab.lat_windows
    out = torch.zeros_like(like).reshape(nz, like.shape[0] // nz, *like.shape[1:])
    out[:, a:b] = t.reshape(nz, b - a, *t.shape[1:])
    return out.reshape(like.shape)


def _hold_slab(label: str, got: torch.Tensor, whole: torch.Tensor) -> dict:
    """A slab launch's output against the same windows of the whole-grid
    launch: the same bits expected; otherwise held to the kernel bounds."""
    same = torch.equal(got, whole)
    c = compare(got, whole)
    if not same and not c["ok"]:
        raise AssertionError(f"{label}: the slab launch disagrees with the whole grid's "
                             f"(max|d| {c['max_abs']:.6g}, rms {c['rms']:.6g})")
    return dict(same_bits=same, max_abs=c["max_abs"])


def _slab_calls(args, statics, gy, s1, s2, slab=None) -> dict:
    """K1, K2, K3, K11 and K12 on ``slab`` of the grid ``args[0]`` (the
    whole grid when None), with the earth bias and shift mask cut to it."""
    x, wqkv, bqkv, wproj, bproj, bias, mask = args[:7]
    if slab is not None:
        (r0, r1), (c0, c1) = slab.rows, slab.cols
        x, gy = (t[:, :, r0:r1, c0:c1].contiguous() for t in (x, gy))
        bias, mask = slab.cut_types(bias), None if mask is None else slab.cut_types(mask)
    a = (x, *args[1:5], bias, mask, *args[7:])
    return {
        "K1": lambda: (fba.fused_earth_block(*a, *statics),),
        "K2": lambda: (fba.fused_block_attention(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                                 None, None, *statics),),
        "K3": lambda: fba.fused_block_attention_bwd(x, wqkv, bqkv, wproj, bias, mask, gy,
                                                    *statics),
        "K11": lambda: (fbt.fused_earth_block_train(*a, s1, s2, *statics),),
        "K12": lambda: fbt.fused_earth_block_train_bwd(*a, s1, s2, gy, *statics),
    }


def _slab_inputs(stage, c: int, heads: int, shifted: bool, dev, seed: int):
    args, statics = block_inputs(stage, c, heads, shifted, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    return args, statics, torch.randn(args[0].shape, generator=gen,
                                      device=dev).to(torch.bfloat16)


def check_slabs(g, dev) -> dict:
    """Phase 21a: K1, K2, K3, K11 and K12 on each slab of the flagship
    lat=2 x lon=2 plane (``parallel.spatial``: whole windows, the earth bias
    and shift mask cut to the slab's lat windows), at both stages, unshifted
    and shifted, against the same windows of the whole-grid launch: the
    forward outputs and the dx of K3 and K12 the same bits (else held to
    the kernel bounds, reported), the weight, bias and earth-bias gradients
    summed over the four slabs within the kernel bounds of the whole grid's.
    Then, shifted, each distinct slab shape's ms per launch beside the whole
    grid's. Returns the results and the launches of the checks."""
    from pangu_tpu_torch.parallel import spatial

    s1, s2 = torch.full((1,), 1.25, device=dev), torch.full((1,), 0.8, device=dev)
    names = {"K3": ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias"),
             "K12": fbt.GRAD_NAMES}
    stages = (("outer", g.outer, 192, 6), ("inner", g.inner, 384, 12))
    planes = {name: [spatial.slab_of(stage, Mesh(None, 1, r, *SLAB_PLANE))
                     for r in range(SLAB_PLANE[0] * SLAB_PLANE[1])]
              for name, stage, _, _ in stages}
    res = []
    reset_counts()
    for name, stage, c, heads in stages:
        for shifted in (False, True):
            label = f"{name} {'shifted' if shifted else 'unshifted'}"
            args, statics, gy = _slab_inputs(stage, c, heads, shifted, dev, 90 + len(res))
            with torch.no_grad():
                whole = {k: fn() for k, fn in _slab_calls(args, statics, gy, s1, s2).items()}
                sums = {k: [None] * len(whole[k]) for k in names}
                held = {k: [] for k in whole}
                for slab in planes[name]:
                    (r0, r1), (c0, c1) = slab.rows, slab.cols
                    for k, fn in _slab_calls(args, statics, gy, s1, s2, slab).items():
                        outs = fn()
                        # forward outputs, and the dx of the backwards: per token
                        held[k].append(_hold_slab(f"{k} {label} slab {slab.rows}x{slab.cols}",
                                                  outs[0], whole[k][0][:, :, r0:r1, c0:c1]))
                        for i, t in enumerate(outs[1:], 1):
                            if names[k][i] == "dbias":
                                t = _place_types(t, slab, whole[k][i])
                            sums[k][i] = t.float() if sums[k][i] is None else sums[k][i] + t
                errs = {k: check_outputs(f"{k} {label} slab sums", {
                    names[k][i]: compare(outs[i], whole[k][i]) for i in range(1, len(outs))})
                    for k, outs in sums.items()}
            res.append(dict(stage=name, shifted=shifted,
                            slabs=[dict(rows=sl.rows, cols=sl.cols) for sl in planes[name]],
                            held=held, sum_max_abs_err=errs,
                            same_bits={k: all(h["same_bits"] for h in v)
                                       for k, v in held.items()}))
            log(f"slabs {label}: the same bits as the whole grid: {res[-1]['same_bits']}; "
                "summed gradients within the kernel bounds")
            del args, gy, whole, sums
            torch.cuda.empty_cache()
    launches = {k: v for k, v in launch_counts().items() if v}
    times = []
    for name, stage, c, heads in stages:  # the timing's launches are not counted
        args, statics, gy = _slab_inputs(stage, c, heads, True, dev, 0)
        shapes = {(sl.rows[1] - sl.rows[0], sl.cols[1] - sl.cols[0]): sl for sl in planes[name]}
        for (h, w), slab in [((stage.h_pad, stage.w), None), *shapes.items()]:
            with torch.no_grad():
                times.append(dict(stage=name, grid=[h, w], whole=slab is None, ms={
                    k: cuda_times_ms(fn)
                    for k, fn in _slab_calls(args, statics, gy, s1, s2, slab).items()}))
            log(f"slab times {name} {h}x{w}{' (whole grid)' if slab is None else ''}: "
                f"{json.dumps({k: round(v, 4) for k, v in times[-1]['ms'].items()})} ms a launch")
        del args, gy
        torch.cuda.empty_cache()
    return dict(checks=res, times=times, launches=launches)


def spatial_rank(spec: dict) -> dict:
    """One rank of phase 21b (its own process): join the group (NCCL on the
    card, gloo on the CPU), make the mesh of ``spec["axes"]`` (data 1), then
    3 ZeRO-2 train steps of phase 8's config, seeded weights, batch and
    drop-path draws on this rank's slabs (launches, loss, parameter digest
    and the step's split each), one validation pass over phase 17's val
    range (K1 on slabs), and on the card one more step under torch.profiler.
    Rank 0 then runs the one-process step from the same weights, batch and
    generator (no mesh), holds the first mesh step's loss and gradients to
    it under phase 8's bounds, and times its steps as the mesh's were
    (``STEPS`` unprofiled, then one profiled)."""
    from pangu_tpu_torch.parallel import zero_shard_opt_state
    from pangu_tpu_torch.train.step import make_eval_step
    from pangu_tpu_torch.train.trainer import sharded_val_stats

    world, rank = spec["world"], spec["rank"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = distributed_init(spec["init"], world, rank, rank, spec["device"])
    cuda = dev.type == "cuda"
    try:
        cfg = finetune_config(FINETUNE_DATA, spec["tiny"])
        m = cfg.model
        mesh = make_mesh(ParallelConfig(data=1, **spec["axes"]), model=m)
        aux = synthetic_aux_constants(m, cfg.train, seed=0, device=dev)
        with dev:
            model = PanguModel(m).to(dev)
        init_params(model, seed=0)
        batch = train_batch(aux, m, dev)
        res = dict(rank=rank, world=world, coords=mesh.coords, runs=[])
        split = {}
        with activate_mesh(mesh):
            opt = zero_shard_opt_state(make_optimizer(model, cfg), mesh)
            step = make_train_step(model, cfg, opt, spans=split)
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            for i in range(STEPS):
                reset_counts()
                before = dict(split)
                t0 = time.perf_counter()
                loss = step(batch, aux, torch.Generator(device=dev).manual_seed(3 + i))
                loss = loss.item()
                res["runs"].append(dict(
                    loss=loss, wall_s=time.perf_counter() - t0, params=param_digest(model),
                    launches={k: v for k, v in launch_counts().items() if v},
                    split={k: v - before.get(k, 0.0) for k, v in split.items()}))
                if i == 0 and rank == 0:
                    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
            res["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
            reset_counts()
            val = make_loader(cfg.data, m, "val", cfg.horizon, 1)
            res["val"] = sharded_val_stats(make_eval_step(model, cfg), val, aux, dev)
            res["val_launches"] = {k: v for k, v in launch_counts().items() if v}
            if cuda:  # one more step under torch.profiler, on every rank (it is collective)
                res["profile"] = profiled_step(
                    lambda: step(batch, aux, torch.Generator(device=dev).manual_seed(3)), dev)
            del step, opt
        if rank == 0:  # the one-process step on the same weights, batch and generator
            init_params(model, seed=0)
            model.zero_grad(set_to_none=True)
            one = make_train_step(model, cfg, make_optimizer(model, cfg))
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            loss = one(batch, aux, torch.Generator(device=dev).manual_seed(3)).item()
            wall = time.perf_counter() - t0
            named = dict(model.named_parameters())
            dev_ = grad_deviation(f"spatial {spec['axes']} step vs the one-process step",
                                  res["runs"][0]["loss"], grads, loss,
                                  {k: named[k].grad.float() for k in grads})
            check_train_bounds(f"the spatial {spec['axes']} step", dev_)
            walls = [wall]
            for i in range(1, STEPS):  # the mesh's steps' timing, unprofiled, for a like pair
                t0 = time.perf_counter()
                one(batch, aux, torch.Generator(device=dev).manual_seed(3 + i)).item()
                walls.append(time.perf_counter() - t0)
            res["one_process"] = dict(loss=loss, step_wall_s=walls, **dev_,
                                      peak_bytes=torch.cuda.max_memory_allocated(dev)
                                      if cuda else 0)
            if cuda:
                summary, by_name = profile_train_step._profile(
                    lambda: one(batch, aux, torch.Generator(device=dev).manual_seed(3)), dev, 8)
                res["one_process"]["profile"] = summary
            del grads, one
        torch.distributed.barrier()
        return res
    finally:
        torch.distributed.destroy_process_group()


def check_spatial(dev, worlds=None, tiny: bool = False) -> dict:
    """Phase 21b: for each (cards, axes) of ``worlds`` (default: those of
    ``SPATIAL_WORLDS`` this host has the cards for) the ranks of
    ``spatial_rank`` as fresh processes over NCCL. Requires phase 8's
    launches in each rank's every step, the same loss and parameter bits on
    every rank, the same validation value on every rank and 16 K1 launches
    a validation sample; prints a ``spatial:`` line per world (the step's
    wall and split, the profile's busy, NCCL time and launches, each rank's
    peak memory, all beside the one-process step's). On a host with one
    card it prints why it did not run and returns None."""
    if worlds is None:
        cards = torch.cuda.device_count()
        worlds = [(n, axes) for n, axes in SPATIAL_WORLDS if n <= cards]
        if not worlds:
            log(f"spatial: phase 21b did not run: it needs 2 or 4 cards (one process per "
                f"card over NCCL) and this host has {cards}")
            return None
    lines = []
    for world, axes in worlds:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            spec = dict(world=world, axes=axes, init="file://" + os.path.join(tmp, "store"),
                        device=dev.type, tiny=tiny)
            ranks = _run_ranks(world, spec, SPATIAL_RANK, tmp, SPATIAL_TIMEOUT_S,
                               f"phase 21b {axes}")
        first = ranks[0]
        for res in ranks:
            for i, (run, run0) in enumerate(zip(res["runs"], first["runs"])):
                hold_rank_launches(f"spatial {axes} rank {res['rank']} step {i + 1}",
                                   run["launches"], dict(TRAIN_LAUNCHES))
                if (run["loss"], run["params"]) != (run0["loss"], run0["params"]):
                    raise AssertionError(f"spatial {axes} step {i + 1}: rank {res['rank']} "
                                         "differs from rank 0")
            if res["val"] != first["val"]:
                raise AssertionError(f"spatial {axes}: rank {res['rank']} validates "
                                     f"{res['val']}, rank 0 {first['val']}")
            hold_rank_launches(f"spatial {axes} rank {res['rank']} validation",
                               res["val_launches"], {"fused_earth_block": 16 * first["val"][1]})
        later = [r["split"] for r in first["runs"][1:]]
        line = dict(world=world, axes=axes, losses=[r["loss"] for r in first["runs"]],
                    step_wall_s=[r["wall_s"] for r in first["runs"]],
                    step_split_s={k: statistics.mean(s[k] for s in later) for k in later[0]},
                    val=first["val"], profile=[r.get("profile") for r in ranks],
                    peak_bytes=[r["peak_bytes"] for r in ranks],
                    one_process=first["one_process"], card=card_line())
        one_later = first["one_process"]["step_wall_s"][1:]
        log(f"spatial {axes}: steps 2-{STEPS} unprofiled, mean "
            f"{statistics.mean(line['step_wall_s'][1:]):.6f} s a step; the one-process step "
            f"in the same process {statistics.mean(one_later):.6f} s")
        log(f"spatial {axes}: every rank the same loss and parameter bits in each of "
            f"{STEPS} steps and the same validation value; step 1 within phase 8's bounds of "
            "the one-process step")
        log("spatial: " + json.dumps(line))
        lines.append(line)
    return lines


#: phase 22: the microbatches of 22a, 22b's worlds by the cards they need ((cards, mesh
#: axes, microbatches)) and the seconds their ranks may take together
PIPELINE_MICRO = 2
PIPELINE_WORLDS = {2: [(2, dict(pipe=2), 2)],
                   4: [(4, dict(pipe=4), 4), (4, dict(data=2, pipe=2), 2)]}
PIPELINE_TIMEOUT_S = 600
PIPELINE_RANK = r"""
import json, sys
import chip_smoke
print(json.dumps(chip_smoke.pipeline_rank(json.loads(sys.argv[1]))), flush=True)
"""


def pipeline_config(tiny: bool = False):
    """Phase 22's run: phase 8's config (the tiny preset's on the CPU) with
    drop path 0, as the JAX pipeline test's."""
    kw = dict(compute_dtype="bfloat16", matmul_precision="default", use_pallas_attention=True,
              drop_path_max=0.0)
    return pangu_tiny(**kw) if tiny else pangu_pretrain(24, **kw)


def stage_blocks(stage) -> int:
    """The transformer blocks of a pipeline stage."""
    return sum(len(stage.get_submodule(pipeline.MODULE_NAMES[op]).blocks)
               for op in stage.ops if op.startswith("layer"))


def stage_launches(stage, micro: int) -> dict:
    """A stage's launches in one train step: phase 8's per block (of 16), by
    its blocks, times the microbatches."""
    blocks = stage_blocks(stage)
    return {k: v // 16 * blocks * micro for k, v in TRAIN_LAUNCHES.items()} if blocks else {}


def adam_bytes(optimizer) -> int:
    """The bytes of an optimizer's parameters and per-element state."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = [v for p in params for v in optimizer.state.get(p, {}).values()
             if torch.is_tensor(v) and v.dim() > 0]
    return sum(t.numel() * t.element_size() for t in params + state)


def counted(fn, into: dict):
    """``fn()``, its launches added into ``into``."""
    before = launch_counts()
    out = fn()
    for k, v in launch_counts().items():
        if v - before[k]:
            into[k] = into.get(k, 0) + v - before[k]
    return out


def check_pipeline_one_card(dev, tiny: bool = False) -> dict:
    """Phase 22a: the default 4-way split's stages on one card, fed one
    another's outputs in the transport dtype by the pipeline's own stage
    functions in GPipe order, against the one-process model: the eval
    forward of each sample against the forecast step (the same bits, else
    phase 4's bounds), one train step of 2 microbatches against the
    one-process step with ``accumulation_steps`` = 2 (phase 8's bounds; the
    bits reported); each stage's launches and parameter + Adam bytes."""
    cfg = pipeline_config(tiny)
    m, micro = cfg.model, PIPELINE_MICRO
    transport = dtype_of(m.compute_dtype)
    aux = synthetic_aux_constants(m, cfg.train, seed=0, device=dev)
    with dev:
        model = PanguModel(m).to(dev)
    init_params(model, seed=0)
    w0 = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch(aux, m, dev, rows=micro)
    stages = []
    for ops, part in zip(pipeline.DEFAULT_STAGES,
                         pipeline.split_stage_params(w0, pipeline.DEFAULT_STAGES)):
        with dev:
            stages.append(pipeline.PanguStage(m, ops).to(dev))
        stages[-1].load_state_dict(part)
    rows = [slice(i, i + 1) for i in range(micro)]

    # the eval forward: K1 on the stages' blocks
    launches = [{} for _ in stages]
    fwd = dict(same_bits=True, max_abs=0.0, rms=0.0)
    forecast = make_forecast_step(model, aux)
    for r in rows:
        ref = forecast(batch.upper[r], batch.surface[r])
        payload = (batch.upper[r], batch.surface[r])
        with torch.no_grad():
            for stage, into in zip(stages, launches):
                run = counted(lambda: pipeline.stage_forward(stage.eval(), payload, aux,
                                                             grad=False), into)
                payload = tuple(o.to(transport) for o in run.outputs) \
                    if stage is not stages[-1] else run.outputs
        got = norm_back_data(*payload, aux)
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        max_abs, rms = deviation(got, ref, aux)
        if not same and not (max_abs < STEP_MAX_TOL and rms < STEP_RMS_TOL):
            raise AssertionError(f"pipeline stages' forward: max|d| {max_abs}, rms {rms} "
                                 "against the one-process forecast step")
        fwd = dict(same_bits=fwd["same_bits"] and same, max_abs=max(fwd["max_abs"], max_abs),
                   rms=max(fwd["rms"], rms))
    for stage, into in zip(stages, launches):
        hold_rank_launches(f"pipeline stage {stage.ops} forward", into,
                           {"fused_earth_block": stage_blocks(stage) * micro})
    fwd["launches"] = launches
    log(f"pipeline stages' forward: {micro} samples, the one-process forecast step's bits "
        f"{fwd['same_bits']} (max|d| {fwd['max_abs']:.6g}); K1 by stage "
        f"{[d.get('fused_earth_block', 0) for d in launches]}")

    # one train step: the one-process step with accumulation_steps = micro, then the stages
    acc_cfg = cfg.replace(train=dataclasses.replace(cfg.train, accumulation_steps=micro))
    ref_loss = make_train_step(model, acc_cfg, make_optimizer(model, acc_cfg))(
        Batch(*(t.reshape(micro, 1, *t.shape[1:]) for t in batch)), aux).item()
    ref_grads = {k: p.grad.float() for k, p in model.named_parameters()}
    ref_params = {k: p.detach() for k, p in model.named_parameters()}
    del forecast
    model.zero_grad(set_to_none=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    opts = [make_optimizer(stage.train(), cfg) for stage in stages]
    launches = [{} for _ in stages]
    runs = [[None] * micro for _ in stages]
    loss_sum = torch.zeros((), device=dev)
    for i, r in enumerate(rows):  # every forward, microbatch by microbatch
        payload = (batch.upper[r], batch.surface[r])
        for s, (stage, into) in enumerate(zip(stages, launches)):
            run = counted(lambda: pipeline.stage_forward(stage, payload, aux), into)
            if stage is stages[-1]:
                loss = output_loss(*run.outputs, batch.target_upper[r], batch.target_surface[r],
                                   aux, cfg)
                run = run._replace(outputs=(loss,))
                loss_sum = loss_sum + loss.detach()
            else:
                payload = tuple(o.detach().to(transport) for o in run.outputs)
            runs[s][i] = run
    for i in range(micro):  # then every backward, in the same microbatch order
        grads = None
        for s in reversed(range(len(stages))):
            grads = counted(lambda: pipeline.stage_backward(runs[s][i], grads), launches[s])
            runs[s][i] = None
    schedule = multistep_lr(cfg.train.lr, cfg.train.lr_milestones, cfg.train.lr_gamma, 1)
    grads = {}
    for stage, opt in zip(stages, opts):
        for k, p in stage.named_parameters():
            p.grad.div_(micro)
            grads[k] = p.grad
        set_scheduled_lr(opt, schedule)
        opt.step()
    loss = (loss_sum / micro).item()
    d = grad_deviation("pipeline stages' step vs the one-process accumulation step", loss,
                       grads, ref_loss, ref_grads)
    check_train_bounds("the pipeline stages' step", d)
    params = {k: p.detach() for stage in stages for k, p in stage.named_parameters()}
    step = dict(**d, loss=loss, ref_loss=ref_loss, same_loss_bits=loss == ref_loss,
                same_grad_bits=all(torch.equal(grads[k].float(), ref_grads[k]) for k in grads),
                same_param_bits=all(torch.equal(params[k], ref_params[k]) for k in params),
                launches=launches)
    for stage, into in zip(stages, launches):
        hold_rank_launches(f"pipeline stage {stage.ops} step", into,
                           stage_launches(stage, micro))
    log(f"pipeline stages' step: loss {loss!r} against {ref_loss!r}; the one-process "
        f"accumulation step's bits: loss {step['same_loss_bits']}, gradients "
        f"{step['same_grad_bits']}, parameters {step['same_param_bits']}")
    out = dict(forward=fwd, step=step,
               stages=[dict(ops=list(stage.ops), bytes=adam_bytes(opt))
                       for stage, opt in zip(stages, opts)])
    log(f"pipeline stages' parameter + Adam bytes: {[s['bytes'] for s in out['stages']]}")
    del model, stages, opts, runs, ref_grads, ref_params, grads, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def pipeline_rank(spec: dict) -> dict:
    """One rank of phase 22b (its own process): join the group (NCCL on the
    card, gloo on the CPU), make the mesh of ``spec["axes"]``, load phase
    22's seeded weights into this rank's stage and take 3 steps of the
    global batch (launches, loss, split and wall each; step 1's gradients
    gathered to each replica's first stage), then on the card one profiled
    step. Rank 0 then runs the one-process step with ``accumulation_steps``
    = microbatches x data on the same batch and weights, holds step 1's loss
    and gradients to it under phase 8's bounds, and times its steps as the
    pipeline's were (``STEPS`` unprofiled)."""
    world, rank, micro = spec["world"], spec["rank"], spec["micro"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = distributed_init(spec["init"], world, rank, rank, spec["device"])
    cuda = dev.type == "cuda"
    try:
        pcfg = ParallelConfig(**spec["axes"])
        cfg = pipeline_config(spec["tiny"]).replace(parallel=pcfg)
        m = cfg.model
        mesh = make_mesh(pcfg)
        aux = synthetic_aux_constants(m, cfg.train, seed=0, device=dev)
        whole = PanguModel(m)  # on the host
        init_params(whole, seed=0)
        pipe = pipeline.PanguPipeline(cfg, mesh, dev)
        pipe.load_state_dict(whole.state_dict())
        batch = train_batch(aux, m, dev, rows=micro * mesh.data)
        opt = make_optimizer(pipe.stage, cfg)
        split = {}
        step = pipe.make_train_step(opt, micro, spans=split)
        res = dict(rank=rank, coords=mesh.coords, ops=list(pipe.stage.ops), runs=[],
                   want=stage_launches(pipe.stage, micro))
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        for i in range(STEPS):
            reset_counts()
            before = dict(split)
            t0 = time.perf_counter()
            loss = step(batch, aux).item()
            res["runs"].append(dict(
                loss=loss, wall_s=time.perf_counter() - t0,
                launches={k: v for k, v in launch_counts().items() if v},
                split={k: v - before.get(k, 0.0) for k, v in split.items()}))
            if i == 0:
                grads = pipe.gather({k: p.grad for k, p in pipe.stage.named_parameters()})
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
        res["stage_bytes"] = adam_bytes(opt)
        if cuda:  # one more step under torch.profiler, on every rank (it is collective)
            res["profile"] = profiled_step(lambda: step(batch, aux), dev)
        del step, opt, pipe
        if rank == 0:  # the one-process step on the same weights and batch
            if cuda:
                torch.cuda.empty_cache()
            model = whole.to(dev)
            acc = micro * mesh.data
            acc_cfg = cfg.replace(train=dataclasses.replace(cfg.train, accumulation_steps=acc))
            one = make_train_step(model, acc_cfg, make_optimizer(model, acc_cfg))
            acc_batch = Batch(*(t.reshape(acc, -1, *t.shape[1:]) for t in batch))
            walls, losses = [], []
            for i in range(STEPS):
                t0 = time.perf_counter()
                losses.append(one(acc_batch, aux).item())
                walls.append(time.perf_counter() - t0)
                if i == 0:
                    named = dict(model.named_parameters())
                    ref = {k: named[k].grad.float() for k in grads}
                    got = {k: g.to(dev) for k, g in grads.items()}
                    d = grad_deviation(f"pipeline {spec['axes']} step vs the one-process "
                                       "accumulation step", res["runs"][0]["loss"], got,
                                       losses[0], ref)
                    d["same_grad_bits"] = all(torch.equal(got[k].float(), ref[k]) for k in ref)
                    d["same_loss_bits"] = res["runs"][0]["loss"] == losses[0]
                    check_train_bounds(f"the pipeline {spec['axes']} step", d)
                    del named, ref, got
            res["one_process"] = dict(losses=losses, step_wall_s=walls, **d)
        torch.distributed.barrier()
        return res
    finally:
        torch.distributed.destroy_process_group()


def check_pipeline(dev, worlds=None, tiny: bool = False) -> list | None:
    """Phase 22b: for each (cards, axes, microbatches) of ``worlds``
    (default: ``PIPELINE_WORLDS`` of the most cards this host has) the ranks
    of ``pipeline_rank`` as fresh processes over NCCL. Requires each rank's
    launches in every step to be its stage's and every rank's loss the same
    in every step; logs a ``pipeline 22b`` line per world (the step's wall
    and split beside the one-process step's, the profile's busy, NCCL time
    and launches, each rank's peak memory and bytes, the bubble). On a host
    with one card it prints why it did not run and returns None."""
    if worlds is None:
        cards = torch.cuda.device_count()
        fits = [n for n in PIPELINE_WORLDS if n <= cards]
        if not fits:
            log(f"pipeline: phase 22b did not run: it needs 2 or 4 cards (one process per card "
                f"over NCCL) and this host has {cards}")
            return None
        worlds = PIPELINE_WORLDS[max(fits)]
    lines = []
    for world, axes, micro in worlds:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            spec = dict(world=world, axes=axes, micro=micro, device=dev.type, tiny=tiny,
                        init="file://" + os.path.join(tmp, "store"))
            ranks = _run_ranks(world, spec, PIPELINE_RANK, tmp, PIPELINE_TIMEOUT_S,
                               f"phase 22b {axes}")
        first = ranks[0]
        for res in ranks:
            for i, (run, run0) in enumerate(zip(res["runs"], first["runs"])):
                hold_rank_launches(f"pipeline {axes} rank {res['rank']} step {i + 1}",
                                   run["launches"], res["want"])
                if run["loss"] != run0["loss"]:
                    raise AssertionError(f"pipeline {axes} step {i + 1}: rank {res['rank']} "
                                         f"loss {run['loss']!r}, rank 0 {run0['loss']!r}")
        one = first["one_process"]
        later = [r["split"] for r in first["runs"][1:]]
        stages = world // axes.get("data", 1)
        line = dict(world=world, axes=axes, microbatches=micro,
                    bubble=pipeline.bubble_fraction(stages, micro),
                    losses=[r["loss"] for r in first["runs"]],
                    step_wall_s=[r["wall_s"] for r in first["runs"]],
                    step_split_s={k: statistics.mean(s[k] for s in later) for k in later[0]},
                    step1={k: one[k] for k in ("loss_rel_dev", "grad_rel_l2", "same_loss_bits",
                                                "same_grad_bits")},
                    one_process_step_wall_s=one["step_wall_s"],
                    profile=[r.get("profile") for r in ranks],
                    peak_bytes=[r["peak_bytes"] for r in ranks],
                    stage_bytes=[r["stage_bytes"] for r in ranks], card=card_line())
        log(f"pipeline {axes}, {micro} microbatches: steps 2-{STEPS} unprofiled, mean "
            f"{statistics.mean(line['step_wall_s'][1:]):.6f} s a step; the one-process "
            f"accumulation step in rank 0's process {statistics.mean(one['step_wall_s'][1:]):.6f}"
            f" s; every rank the same loss in each of {STEPS} steps; step 1 within phase 8's "
            f"bounds (the same gradient bits: {one['same_grad_bits']})")
        log("pipeline 22b: " + json.dumps(line))
        lines.append(line)
    return lines


def fuxi_attention_inputs(dev, shifted: bool, seed: int, b: int = 1, cfg=None):
    """The attention inputs of a FuXi block at ``cfg``'s widths (FuXi-Short's
    by default: qkv (B, 90, 180, 3 x 1536)), seeded: unit-normal qkv,
    temperatures in [1, 100], a position bias of 16 sigmoid less its row
    maxima (bf16); the model's order, inverse and labels."""
    from pangu_tpu_torch.model import fuxi

    cfg = cfg or fuxi.fuxi_short()
    (h, w), heads, t = cfg.tokens, cfg.heads, cfg.window[0] * cfg.window[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, h, w, 3 * cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    temp = torch.exp(torch.rand((heads,), generator=gen, device=dev) * math.log(100.0))
    scale = torch.stack([temp, torch.ones_like(temp)]).view(2, heads, 1)
    bias = 16 * torch.sigmoid(torch.randn((heads, t, t), generator=gen, device=dev))
    bias = (bias - bias.amax(-1, keepdim=True))[None].to(torch.bfloat16)
    order = fuxi.window_order(h, w, cfg.window, shifted).to(dev)
    labels = fuxi.shift_labels(h, w, cfg.window).to(dev) if shifted else None
    return qkv, (scale, bias, order.int(), torch.argsort(order), labels)


def sdpa_alone(qkv, scale, bias, order, inverse, labels):
    """The yardstick's one library call: ``scaled_dot_product_attention`` on
    the gathered windows of ``qkv`` with their bias (+ mask), formed here
    outside the timed call."""
    b, h, w, c3 = qkv.shape
    heads, t = scale.shape[1], bias.shape[-1]
    work = qkv.clone()
    fca.cosine_(work.view(b, h * w, 3, heads, -1), scale)
    win = work.view(b, h * w, c3).index_select(1, order)
    q, k, v = win.view(-1, t, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4).unbind(0)
    if labels is not None:
        bias = fca._shifted_bias(bias, fca.label_mask(labels, t, bias.dtype), b)
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                                    scale=1.0)


def check_fuxi_attention(dev) -> dict:
    """Phase 23: FuXi's attention kernel against its plain version at
    FuXi-Short's shape, timed beside its bound, the plain version and SDPA;
    then one FuXi-Short step on the kernel (48 launches)."""
    from pangu_tpu_torch.model import FuxiConstants, FuxiModel, fuxi_short

    shapes = []
    for shifted in (False, True):
        label = f"fuxi attention {'shifted' if shifted else 'unshifted'}"
        qkv, args = fuxi_attention_inputs(dev, shifted, seed=23 + shifted)
        got = fca.cosine_window_attention(qkv, *args)
        torch.cuda.synchronize()
        same = same_bits(label, (got,), (fca.cosine_window_attention(qkv, *args),))
        r = compare(got, fca.cosine_window_attention_reference(qkv.clone(), *args))
        del got
        if not r["ok"]:
            raise AssertionError(f"{label} disagrees with its plain version: {r}")
        work = qkv.clone()
        call = lambda: fca.cosine_window_attention(qkv, *args)  # noqa: E731
        n, c3 = qkv.shape[1] * qkv.shape[2], qkv.shape[-1]
        heads, t = args[0].shape[1], args[1].shape[-1]
        nbytes = (qkv.numel() * 2 + n * c3 // 3 * 2 + args[1].numel() * 2 + 4 * n
                  + (n if shifted else 0) + args[0].numel() * 4)
        shapes.append(dict(
            shifted=shifted, shape=list(qkv.shape), heads=heads, tokens=t,
            max_abs_err=r["max_abs"], rms_err=r["rms"], ref_max=r["ref_max"],
            ref_rms=r["ref_rms"], same_bits=same, ms=cuda_times_ms(call),
            device_ms=cuda_times_ms(lambda: [call() for _ in range(20)]) / 20,
            plain_ms=cuda_times_ms(lambda: fca.cosine_window_attention_reference(work, *args)),
            library_ms=cuda_times_ms(sdpa_alone(qkv, *args)),
            **ab_bound(4 * t * t * (c3 // 3 // heads) * heads * (n // t), nbytes)))
        log(f"{label}: " + json.dumps(shapes[-1]))
        del qkv, work, args, call
        torch.cuda.empty_cache()

    cfg = fuxi_short()
    with torch.random.fork_rng(devices=[dev]), torch.device(dev):
        torch.manual_seed(23)
        model = FuxiModel(cfg)
    v = cfg.variables
    k = FuxiConstants(torch.zeros((1, v, 1, 1), device=dev), torch.ones((1, v, 1, 1), device=dev))
    gen = torch.Generator(device=dev).manual_seed(23)
    state = [torch.randn((1, v, cfg.lat, cfg.lon), generator=gen, device=dev) for _ in range(2)]
    step = make_forecast_step(model, k)
    before = fca.LAUNCHES
    t0 = time.perf_counter()
    out = step(*state)[1]
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = fca.LAUNCHES - before
    finite = bool(torch.isfinite(out).all())
    del model, step, state, out
    torch.cuda.empty_cache()
    if launches != cfg.depth or not finite:
        raise AssertionError(f"the FuXi step launched {launches} (want {cfg.depth}), "
                             f"finite {finite}")
    res = dict(shapes=shapes, step_launches=launches, first_step_s=step_s, card=card_line())
    log("fuxi attention: " + json.dumps(res))
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
    t0 = time.perf_counter()
    finetune = check_finetune(dev)
    log(f"phase 17 (finetune): {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    serve = check_serving(dev)
    log(f"phase 18 (serving): {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    data = check_data(dev, score, finetune)
    log(f"phase 19 (data): {time.perf_counter() - t0:.3f} s")
    del score["tables"]
    t0 = time.perf_counter()
    multi = check_multi_gpu(dev)
    log(f"phase 20 (multi-GPU finetune): {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    slabs = check_slabs(model_geom, dev)
    log(f"phase 21a (kernels on slabs): {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    spatial = check_spatial(dev)
    log(f"phase 21b (spatial finetune): {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    pipe = dict(one_card=check_pipeline_one_card(dev))
    log(f"phase 22a (pipeline stages on one card): {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    pipe["worlds"] = check_pipeline(dev)
    log(f"phase 22b (pipeline over cards): {time.perf_counter() - t0:.3f} s")
    log("pipeline: " + json.dumps({**pipe, "card": card_line()}))
    t0 = time.perf_counter()
    fuxi_attn = check_fuxi_attention(dev)
    log(f"phase 23 (FuXi's attention): {time.perf_counter() - t0:.3f} s")

    log("detail: " + json.dumps({"slice": sl, **shapes, "products": products, "train": tr,
                                 "ab": ab, "two_kernel_path": tail_path, "mxu_micro": micro,
                                 "attn_fwd_ab": fwd_ab, "attn_bwd_ab": bwd_ab,
                                 "forecast_and_score": score, "finetune": finetune,
                                 "serving": serve, "data": data, "multi_gpu": multi,
                                 "slabs": slabs, "spatial": spatial, "pipeline": pipe,
                                 "fuxi_attention": fuxi_attn}))
    # launches over the run of each kernel's path
    launches = {"fused_earth_block": sl["launches"], **tr["launches"],
                **{k: ab["unfused_tail"]["launches"][k] for k in ("fused_mlp", "fused_mlp_bwd")},
                **{k: ab["fused_block"]["launches"][k]
                   for k in ("fused_earth_block_train", "fused_earth_block_train_bwd")},
                **tail_path["launches"], **micro_counts, **fwd_counts, **bwd_counts,
                "cosine_window_attention": fuxi_attn["step_launches"]}
    scripts = {**{f"bench_mxu_micro:{v}": r for v, r in micro.items()},
               **{f"bench_attn_fwd_ab:{v}": r for v, r in fwd_ab.items()},
               **{f"bench_attn_bwd_ab:{v}": r for v, r in bwd_ab.items()}}
    kernels = []
    for name, (replaces, source) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": "pangu_tpu_torch/csrc/" + source,
                 "replaces": replaces, "launches": launches.get(name, 0)}
        if name == "cosine_window_attention":
            sh = fuxi_attn["shapes"]
            entry.update(max_abs_err=max(x["max_abs_err"] for x in sh),
                         **{k: sum(x[k] for x in sh) / len(sh)
                            for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")},
                         bound_by=sh[0]["bound_by"])
        elif name in scripts:
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
