"""Where a flagship train step's, or the forecast step's, device time goes,
on one CUDA card.

    python -m pangu_tpu_torch.scripts.profile_train_step [variant ...]

For each variant of ``bench_train_ab`` (default: base fused_block
unfused_tail): seeded weights and batch, two warm-up steps, then one step
under ``torch.profiler``. The variant ``forecast`` profiles the flagship 24 h
forecast step (``make_forecast_step``, bf16, seeded weights and fields) the
same way, and splits the block kernel K1 into its two kernels: the window
attention and the token tail. Prints one JSON line per variant: the step's
wall time (host clock, ended by a synchronize), the device busy time (the
union of the kernels' intervals), the idle share, the number of kernels, and
the device time by kernel name (summed over launches, largest first).
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from typing import Callable, Sequence

import torch
from torch.profiler import DeviceType, ProfilerActivity, profile

from pangu_tpu_torch import pangu_pretrain
from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.interop.from_jax import init_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.rollout import make_forecast_step
from pangu_tpu_torch.scripts import bench_train_ab
from pangu_tpu_torch.utils.profiling import busy_us

#: K1's two kernels, by a part of their names: the window attention (mma.sync,
#: scores and probabilities in registers) and the token tail (wgmma/TMA)
K1_KERNELS = {"attention window_attention_kernel (mma.sync)": "window_attention_kernel",
              "tail mlp_tail_kernel (wgmma)": "mlp_tail_kernel"}


def _profile(fn: Callable[[], object], dev: torch.device, top: int):
    """One call of ``fn`` under torch.profiler: the profile's summary and the
    device (ms, launches) of every kernel name."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, counts = defaultdict(float), defaultdict(int)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
        counts[e.name] += 1
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return ({"wall_ms": wall * 1e3, "device_busy_ms": busy,
             "idle_share": 1.0 - busy / (wall * 1e3), "kernels": len(kernels),
             "by_name_ms": [(k, v / 1e3, counts[k]) for k, v in ranked[:top]]},
            {k: (v / 1e3, counts[k]) for k, v in ranked})


def profile_variant(name: str, seed: int = 0, top: int = 25) -> dict:
    """The profile of one seeded train step of variant ``name``."""
    dev = torch.device("cuda", torch.cuda.current_device())
    with bench_train_ab.variant_flags(name):
        step = bench_train_ab.seeded_step(bench_train_ab.variant_config(name), seed, dev)
        bench_train_ab.timed_steps(step, 2, 0, dev)
        summary, _ = _profile(step, dev, top)
    del step
    torch.cuda.empty_cache()
    return {"variant": name, **summary}


def profile_forecast(model: PanguModel, aux, upper: torch.Tensor, surface: torch.Tensor,
                     top: int = 25) -> dict:
    """The profile of one forecast step of ``model`` from (upper, surface),
    after two warm-up steps, with K1 split into its two kernels (device ms
    and launches of each)."""
    dev = upper.device
    step = make_forecast_step(model, aux)
    for _ in range(2):
        step(upper, surface)
    torch.cuda.synchronize(dev)
    summary, names = _profile(lambda: step(upper, surface), dev, top)
    split = {part: [sum(ms for n, (ms, _) in names.items() if key in n),
                    sum(c for n, (_, c) in names.items() if key in n)]
             for part, key in K1_KERNELS.items()}
    return {"variant": "forecast", **summary, "k1_split_ms_launches": split}


def seeded_forecast(seed: int, dev: torch.device):
    """The flagship bf16 model with seeded weights and aux constants, and
    seeded physical fields: (model, aux, upper, surface)."""
    cfg = pangu_pretrain(24, compute_dtype="bfloat16", matmul_precision="default",
                         use_pallas_attention=True)
    m = cfg.model
    model = PanguModel(m).to(dev).eval()
    init_params(model, seed=seed)
    aux = synthetic_aux_constants(m, cfg.train, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    upper = aux.upper_mean + aux.upper_std * torch.randn(
        (1, m.upper_vars, m.levels, m.lat, m.lon), generator=gen, device=dev)
    surface = aux.surface_mean + aux.surface_std * torch.randn(
        (1, m.surface_vars, m.lat, m.lon), generator=gen, device=dev)
    return model, aux, upper, surface


def main(argv: Sequence[str]) -> int:
    variants = list(argv) or list(bench_train_ab.DEFAULT)
    for name in variants:
        if name != "forecast":
            bench_train_ab.check_variant(name)
    if not torch.cuda.is_available():
        raise RuntimeError("the profile needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    for name in variants:
        if name == "forecast":
            res = profile_forecast(*seeded_forecast(0, dev))
            torch.cuda.empty_cache()
        else:
            res = profile_variant(name)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
