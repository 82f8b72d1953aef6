"""The control of a cell's comparison: the reference put in the program's
place at a precision below the configuration's, read by the same
comparison at the cell's own size, on the seeds given. Its numbers set the
upper readings of the cell's limits (``limits/<cell>.json``); the
benchmark's own runs never run it.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 [--precision fp8]

Rollout cells: one step from each seeded initial state of the pool and one
from the reference's own next state, the control against the f32
reference. Train cells: the first steps of the run, the control's losses,
first gradient and change against the f32 reference's. A configuration in
f32 (TF32 off) also reads the program itself with TF32 on, which is its own
path to the lower precision. Each control's readings are judged as a run's
are (``harness.judge`` with ``limits/<cell>.json``); prints one JSON line
per seed and control, each number beside its limit, and exits 1 if any
control reads correct.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from benchmark import arch as contract
from benchmark import compare, harness


def rollout_readings(cell, seed: int, device, precision: str) -> dict:
    config, t = cell.config, cell.traffic
    arch = harness.architecture(config)
    k = arch.constants(config, seed, device)
    pool = arch.states(config, k, seed, device, t["pool"], t["batch"])
    params = arch.weights(config, seed, device)
    readings, starts = [], list(pool)
    with torch.no_grad():
        for i, state in enumerate(starts):
            ref = arch.reference_step(params, config, state, k)
            ctl = arch.to_state(arch.reference_step(params, config, state, k, precision), k)
            readings.append(arch.forecast_gaps(ctl, ref, k))
            if i == 0:
                starts.append(arch.to_state(ref, k))
    out = {"reference_" + precision: readings}
    if (device.type == "cuda" and not config["allow_tf32"]
            and config["model"]["compute_dtype"] == "float32"):
        out["program_tf32"] = program_tf32(cell, seed, device, params, k, pool)
    return out


def program_tf32(cell, seed, device, params, k, pool) -> dict:
    """The program's own forecast step with TF32 on against the reference."""
    arch = harness.architecture(cell.config)
    with torch.no_grad():
        refs = [arch.reference_step(params, cell.config, state, k) for state in pool]
    _, model = arch.build_model(cell, seed, device)
    step = arch.forecast_step(model, arch.aux_constants(k))
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        return [arch.forecast_gaps(step(*state), ref, k) for state, ref in zip(pool, refs)]
    finally:
        harness.set_precision(cell.config)


def train_readings(cell, seed: int, device, precision: str) -> dict:
    config, t = cell.config, cell.traffic
    arch = harness.architecture(config, contract.TRAINING)
    k = arch.constants(config, seed, device)
    pool = arch.pairs(config, k, seed, device, t)[:t["first_steps"]]
    ref = arch.reference_steps(config, k, pool, seed, device)
    ctl = arch.reference_steps(config, k, pool, seed, device, precision)
    return {"reference_" + precision: [compare.train_gaps(ctl, ref)]}


def verdicts(cell, seed: int, device, precision: str) -> dict:
    """Each control's record, judged by the cell's limits as a run is."""
    read = train_readings if cell.traffic["loop"] == "train" else rollout_readings
    out = {}
    for name, readings in read(cell, seed, device, precision).items():
        rec = harness.Record(cell=cell, setup_s=0.0, window=harness.Window(0, 0.0, []),
                             samples_per_step=0, flops_per_step=0.0, window_peak_bytes=0)
        harness.judge(rec, readings)
        out[name] = rec
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--precision", choices=contract.PRECISIONS[1:], default=None,
                   help="default: fp8 below bf16, tf32 below f32")
    args = p.parse_args(argv)
    root = os.getcwd()
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        cell = harness.load_cell(json.load(f), args.workload, root)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    harness.set_precision(cell.config)
    precision = args.precision or ("fp8" if cell.config["model"]["compute_dtype"] == "bfloat16"
                                   else "tf32")
    passed = []
    for seed in args.seeds:
        for name, rec in verdicts(cell, seed, device, precision).items():
            checks = {n: {"value": v, "limit": lim} for n, (v, lim) in rec.checks.items()}
            print(json.dumps({"workload": cell.name, "seed": seed, "control": name,
                              "correct": rec.correct, "checks": checks}), flush=True)
            if rec.correct:
                passed.append((seed, name))
        torch.cuda.empty_cache()
    if passed:
        print(f"control: read correct, so the limits do not catch it: {passed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
