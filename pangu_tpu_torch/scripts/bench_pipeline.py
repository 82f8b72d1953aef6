"""Relative step time of the parallelism layouts at equal global batch (port
of ``scripts/bench_pipeline.py``), one process per card over the same world
of N ranks (N a multiple of 4):

  * DP       -- data=N (ZeRO-2)
  * DP x SP  -- data=N/4, lat=2, lon=2 (ZeRO-2 over the data axis)
  * PP x DP  -- data=N/4, pipe=4 (GPipe, M microbatches, stage-local Adam)

Each layout takes one warm-up step, then ``--steps`` steps timed by the host
clock and ended by a synchronize, from the same seeded weights and the same
global batch, drop path off. The JSON line on rank 0 has the JAX script's
keys; its ``note`` names the device. The JAX script ran on a virtual CPU
mesh and showed schedule overhead only; on the cards the collectives and
the point-to-point transfers are real. The default model is ``pangu_tiny``
at lon 192, where each rank of the lat x lon plane gets whole windows (at
lon 96 the inner stage has one lon window, and the port refuses the axis).

    torchrun --nproc-per-node 4 -m pangu_tpu_torch.scripts.bench_pipeline \\
        [--steps 6] [--microbatches 2] [--batch 8] [--preset tiny|pretrain] [--set k=v]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.config import ParallelConfig, apply_overrides, pangu_pretrain, pangu_tiny
from pangu_tpu_torch.interop.from_jax import init_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.parallel import (activate_mesh, distributed_init, is_main, make_mesh,
                                      shard_batch, zero_shard_opt_state)
from pangu_tpu_torch.parallel.pipeline import NUM_STAGES, PanguPipeline, bubble_fraction
from pangu_tpu_torch.train.step import Batch, make_optimizer, make_train_step


def timed_steps(step, batch, aux, steps: int, dev: torch.device) -> float:
    """Seconds a step: one warm-up, then ``steps`` steps ended by a synchronize."""
    step(batch, aux)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(batch, aux)
    loss.item()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / steps


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    """Returns the results (printed as JSON on rank 0)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--microbatches", type=int, default=2)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--preset", choices=["tiny", "pretrain"], default="tiny")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted config override")
    args = p.parse_args(argv)
    dev = distributed_init(device=device)
    world = torch.distributed.get_world_size()
    if world % NUM_STAGES:
        raise SystemExit(f"the pipeline layout needs a multiple of {NUM_STAGES} ranks (one "
                         f"group per stage); WORLD_SIZE is {world}")
    base = pangu_tiny(lon=192) if args.preset == "tiny" else pangu_pretrain(24)
    cfg = apply_overrides(base, args.overrides)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, drop_path_max=0.0))
    m = cfg.model
    aux = synthetic_aux_constants(m, cfg.train, device=dev)
    w0 = PanguModel(m)
    init_params(w0, seed=0)
    w0 = w0.state_dict()
    rng = np.random.default_rng(0)
    upper = rng.standard_normal((args.batch, m.upper_vars, m.levels, m.lat, m.lon),
                                dtype=np.float32)
    surface = rng.standard_normal((args.batch, m.surface_vars, m.lat, m.lon), dtype=np.float32)
    batch = Batch(*(torch.from_numpy(x).to(dev) for x in (upper, surface, upper + 0.1,
                                                           surface + 0.1)))
    results = {}

    def spmd_case(name: str, pcfg: ParallelConfig) -> None:
        c = cfg.replace(parallel=pcfg)
        mesh = make_mesh(pcfg, model=m)
        with dev:
            model = PanguModel(m).to(dev)
        model.load_state_dict(w0)
        with activate_mesh(mesh):
            opt = zero_shard_opt_state(make_optimizer(model, c), mesh)
            results[name] = timed_steps(make_train_step(model, c, opt),
                                        shard_batch(batch, mesh), aux, args.steps, dev)

    spmd_case(f"dp{world}", ParallelConfig(data=world))
    spmd_case(f"dp{world // 4}_sp4", ParallelConfig(data=world // 4, lat=2, lon=2))
    pcfg = ParallelConfig(data=world // NUM_STAGES, pipe=NUM_STAGES)
    c = cfg.replace(parallel=pcfg)
    pipeline = PanguPipeline(c, make_mesh(pcfg), dev)
    pipeline.load_state_dict(w0)
    step = pipeline.make_train_step(make_optimizer(pipeline.stage, c), args.microbatches)
    results[f"pp{NUM_STAGES}_dp{world // NUM_STAGES}_m{args.microbatches}"] = timed_steps(
        step, batch, aux, args.steps, dev)

    out = {
        "global_batch": args.batch,
        "steps": args.steps,
        "seconds_per_step": results,
        f"relative_to_dp{world}": {k: v / results[f"dp{world}"] for k, v in results.items()},
        "gpipe_bubble_fraction": bubble_fraction(NUM_STAGES, args.microbatches),
        "note": (f"{world} x {torch.cuda.get_device_name(dev)}, NCCL" if dev.type == "cuda"
                 else f"{world} CPU processes over gloo: schedule overhead only"),
    }
    if is_main():
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
