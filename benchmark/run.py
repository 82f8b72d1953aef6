"""Run one cell of the benchmark once, on the card(s) of this machine.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Finds the cell in ``BENCHMARK.json``, its
configuration, traffic and limits files and its architecture module
(``arch/<name>.py``) by name; builds the program's kernels into the
checkout (``build/``); makes weights, constants and inputs on the card from
the seed; warms up the cell's shapes; measures for ``--seconds``; compares
what the window produced with the plain reference; prints each number
compared beside its limit as the last lines of standard error, and one JSON
line as the last line of standard output. With
``--trace 1`` it also profiles a few steps after the window and reports the
cell's per-layer metrics instead of its end-to-end ones.

Exits non-zero, printing no result, without a CUDA card, for a cell of
more than one card (no cell runs over several yet), on a card that
``peaks.json`` does not list, or when a module of JAX or of the JAX package
was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

#: top-level module names that no run may load
BANNED = ("jax", "jaxlib", "flax", "pangu_tpu")


def banned_modules(modules=None) -> list:
    """Loaded modules whose top-level name is banned, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["USE_FLAX"] = "0"


def counters() -> dict:
    from benchmark import kernels

    return {name: mod.COUNTER for name, mod in kernels.load_all().items()}


def execute(cell, seed: int, seconds: float, trace: bool, device, peaks, t0: float):
    """One run of ``cell`` on ``device``: its loop's record."""
    import importlib

    loop = importlib.import_module(f"benchmark.loops.{cell.traffic['loop']}")
    ctx = SimpleNamespace(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device,
                          peaks=peaks, t0=t0, counters=counters())
    return loop.run(ctx)


def result(rec, device_info: dict, trace: bool) -> dict:
    """The result line of a record."""
    from benchmark import harness
    from benchmark import trace as tr

    if trace:
        metrics = harness.read_metrics(rec, rec.cell.per_layer, required=False)
        prof = rec.profile
        device_info = dict(device_info, busy_s=tr.busy_us(prof.events) * 1e-6,
                           window_s=prof.wall_s)
    else:
        metrics = harness.read_metrics(rec, rec.cell.end_to_end, required=True)
    out = {"correct": rec.correct, "attempted": rec.window.steps * rec.samples_per_step,
           "failed": rec.failed, "metrics": metrics, "device": device_info}
    if trace:
        out["breakdown"] = {"device_ops": tr.top_device_ops(rec.profile.events),
                            "idle_gaps": tr.idle_gaps(rec.profile.events)}
    out["checks"] = {n: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                     for n, (v, lim) in rec.checks.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    root = os.getcwd()
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    from benchmark import harness, work

    cell = harness.load_cell(spec, args.workload, root)
    cache_dirs(root)
    import torch

    if cell.chips != 1:
        print(f"benchmark: {cell.name} asks for {cell.chips} cards; this harness runs a cell "
              "on one", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("benchmark: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    name = torch.cuda.get_device_name(device)
    peaks = work.peaks(name)
    harness.architecture(cell.config).build_kernels()
    rec = execute(cell, args.seed, args.seconds, bool(args.trace), device, peaks, T0)
    print(f"benchmark: set-up {rec.setup_s:.3f} s, window {rec.window.seconds:.3f} s of "
          f"{rec.window.steps} steps, whole run {time.perf_counter() - T0:.3f} s",
          file=sys.stderr)
    found = banned_modules()
    if found:
        print(f"benchmark: modules loaded that no run may load: {found}", file=sys.stderr)
        return 3
    out = result(rec, {"platform": "gpu", "kind": name, "count": cell.chips,
                       "memory_peak_bytes": max(rec.window_peak_bytes, rec.setup_peak_bytes)},
                 bool(args.trace))
    for n, c in out["checks"].items():
        print(f"check {n} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
