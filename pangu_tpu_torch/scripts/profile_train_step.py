"""Where a flagship train step's device time goes, on one CUDA card.

    python -m pangu_tpu_torch.scripts.profile_train_step [variant ...]

For each variant of ``bench_train_ab`` (default: base fused_block
unfused_tail): seeded weights and batch, two warm-up steps, then one step
under ``torch.profiler``. Prints one JSON line per variant: the step's wall
time (host clock, ended by a synchronize), the device busy time (the union
of the kernels' intervals), the idle share, the number of kernels, and the
device time by kernel name (summed over launches, largest first).
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from typing import Sequence

import torch
from torch.profiler import DeviceType, ProfilerActivity, profile

from pangu_tpu_torch.scripts import bench_train_ab


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def profile_variant(name: str, seed: int = 0, top: int = 25) -> dict:
    """The profile of one seeded train step of variant ``name``."""
    dev = torch.device("cuda", torch.cuda.current_device())
    with bench_train_ab.variant_flags(name):
        step = bench_train_ab.seeded_step(bench_train_ab.variant_config(name), seed, dev)
        bench_train_ab.timed_steps(step, 2, 0, dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, counts = defaultdict(float), defaultdict(int)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
        counts[e.name] += 1
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    del step
    torch.cuda.empty_cache()
    return {"variant": name, "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall * 1e3), "kernels": len(kernels),
            "by_name_ms": [(k, v / 1e3, counts[k]) for k, v in ranked]}


def main(argv: Sequence[str]) -> int:
    variants = list(argv) or list(bench_train_ab.DEFAULT)
    for name in variants:
        bench_train_ab.check_variant(name)
    if not torch.cuda.is_available():
        raise RuntimeError("the profile needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in variants:
        print(json.dumps(profile_variant(name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
