"""Host-clock time of the flagship forecast step, and the host cost of one
block call, on one CUDA card: the A/B of two checkouts' eager step.

    PYTHONPATH=TREE python pangu_tpu_torch/scripts/time_forecast_step.py [--steps N]

Run as a file with ``PYTHONPATH`` naming the checkout to time, so that one
call on the card can time checkouts that lack this script (old, new, new,
old). Builds the checkout's kernels, then the flagship bf16 model with
seeded weights, aux constants and fields; 3 warm-up steps of
``make_forecast_step``, then ``--steps`` steps (default 20), each ended by
a synchronize. Then the host time of one block call at the inner stage
(C 384, shifted), enqueue only, over 100 calls without a synchronize: the
public ``fused_earth_block`` (argument checks, and in a checkout that
registers K1 as an operator, the dispatcher) and the bare launch
``_launch``; their difference is what the wrapper adds. Prints one JSON
line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
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

CALLS = 100


def _block_args(stage, dev):
    """Seeded bf16 block inputs at the inner stage (C 384, 12 heads, shifted)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    c, bf, f32 = 384, torch.bfloat16, torch.float32

    def rn(*shape, std=0.05, mean=0.0, dtype=bf):
        return (mean + std * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    mask = torch.from_numpy(shift_attention_mask(stage)).to(dev)
    args = (rn(1, stage.z, stage.h_pad, stage.w, c), rn(3 * c, c), rn(3 * c), rn(c, c), rn(c),
            rn(stage.n_type_windows, 12, 144, 144, dtype=f32), mask,
            rn(c, mean=1.0, dtype=f32), rn(c, dtype=f32), rn(4 * c, c), rn(4 * c),
            rn(c, 4 * c), rn(c), rn(c, mean=1.0, dtype=f32), rn(c, dtype=f32))
    return args, (stage.window, 12, 32 ** -0.5)


def _host_us(fn, dev) -> float:
    """Host microseconds per call of ``fn``, enqueue only, over CALLS calls."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    us = (time.perf_counter() - t0) / CALLS * 1e6
    torch.cuda.synchronize(dev)
    return us


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    args = p.parse_args(argv)
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()

    cfg = pangu_pretrain(24, compute_dtype="bfloat16", matmul_precision="default",
                         use_pallas_attention=True)
    m = cfg.model
    model = PanguModel(m).to(dev).eval()
    init_params(model, seed=0)
    aux = synthetic_aux_constants(m, cfg.train, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    upper = aux.upper_mean + aux.upper_std * torch.randn(
        (1, m.upper_vars, m.levels, m.lat, m.lon), generator=gen, device=dev)
    surface = aux.surface_mean + aux.surface_std * torch.randn(
        (1, m.surface_vars, m.lat, m.lon), generator=gen, device=dev)
    step = make_forecast_step(model, aux)
    for _ in range(3):
        step(upper, surface)
    torch.cuda.synchronize(dev)
    times = []
    fba.LAUNCHES = 0
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step(upper, surface)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    launches = fba.LAUNCHES / args.steps

    block, statics = _block_args(model.geom.inner, dev)
    with torch.inference_mode():
        for fn in (fba.fused_earth_block, fba._launch):
            fn(*block, *statics)
        wrapper_us = _host_us(lambda: fba.fused_earth_block(*block, *statics), dev)
        launch_us = _host_us(lambda: fba._launch(*block, *statics), dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    out = dict(tree=fba.__file__.rsplit("/pangu_tpu_torch/", 1)[0],
               operator=hasattr(fba, "FUSED_EARTH_BLOCK_OP"),
               step_s_median=statistics.median(times), step_s_min=min(times), step_s=times,
               k1_launches_per_step=launches, block_wrapper_host_us=wrapper_us,
               block_launch_host_us=launch_us, wrapper_minus_launch_us=wrapper_us - launch_us,
               card=card)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
