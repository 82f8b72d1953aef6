"""A/B of train-step variants at full geometry on one CUDA card (port of
``scripts/bench_train_ab.py``).

    python -m pangu_tpu_torch.scripts.bench_train_ab [variant ...]

Variants (default: base fused_block unfused_tail):

* ``base``: the flagship bf16 train step (remat, drop path 0.2, Adam) on the
  default kernel route, K2-K7;
* ``noremat``: the same without the per-block checkpoint;
* ``fused_block``: ``fused_block_train._TRAIN_FUSION = True``, each block one
  call of the training block kernel K11 (backward K12);
* ``unfused_block``: the switch explicitly off, the same route as ``base``;
* ``unfused_tail``: ``fused_mlp._POSTNORM_FUSION = False``, the MLP tail as
  the raw MLP K8 (backward K9) followed by the plain post-norm residual;
* ``save_attn``, ``save_attn_mlp``: the remat policy's flags set as the JAX
  script sets them, ``remat_save_attention`` (and ``remat_save_mlp``) True;
  the config's defaults already keep both outputs, as ``base`` does;
* ``bf16_grads``: ``grads_dtype="bfloat16"``, the gradients taken with
  respect to a bf16 copy of the f32 parameters and cast up once (the f32
  masters and moments unchanged), on ``base``'s route.

The JAX script's ``xla_mlp``, ``xla_epilogue`` and ``xla_tails`` time the XLA
formula in place of a kernel; on the card the port runs its kernels or
raises, and a plain version is no yardstick, so they are refused: they raise
ValueError before anything runs.

Each variant runs in turn with every patched flag saved and restored in a
``finally``; the step time is the median of the timed steps after the
warm-up, each ended by ``torch.cuda.synchronize()``. One JSON line per
variant, then ``{"train_ab": {...}, "device_kind": ...}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import sys
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch

from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.config import PanguConfig, pangu_pretrain
from pangu_tpu_torch.interop.from_jax import init_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.ops import fused_block_attention, fused_block_train, fused_epilogue, fused_mlp
from pangu_tpu_torch.train import Batch, make_optimizer, make_train_step

VARIANTS = ("base", "noremat", "fused_block", "unfused_block", "unfused_tail", "save_attn",
            "save_attn_mlp", "bf16_grads")
#: variants of the JAX script that the port does not run, with the reason
REFUSED = {
    "xla_mlp": "times the XLA formula of the MLP; on the card the port runs its kernels or "
               "raises, and the plain version is no yardstick",
    "xla_epilogue": "times the XLA formula of the residual epilogue; on the card the port runs "
                    "its kernels or raises, and the plain version is no yardstick",
    "xla_tails": "times the XLA formulas of both epilogues; on the card the port runs its "
                 "kernels or raises, and the plain version is no yardstick",
}
DEFAULT = ("base", "fused_block", "unfused_tail")


def check_variant(name: str) -> None:
    """Raise ValueError for a variant the port does not run (with the
    reason) or does not know."""
    if name in REFUSED:
        raise ValueError(f"variant {name!r} is not run by the port: {REFUSED[name]}")
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; choose from {VARIANTS}")


@contextlib.contextmanager
def variant_flags(name: str) -> Iterator[None]:
    """Set the module flags of variant ``name`` for the duration of the
    block; every patched flag is restored in a ``finally``."""
    check_variant(name)
    origs = (fused_block_train._TRAIN_FUSION, fused_mlp._POSTNORM_FUSION)
    try:
        if name == "fused_block":
            fused_block_train._TRAIN_FUSION = True
        if name in ("unfused_block", "unfused_tail"):
            fused_block_train._TRAIN_FUSION = False
        if name == "unfused_tail":
            fused_mlp._POSTNORM_FUSION = False
        yield
    finally:
        fused_block_train._TRAIN_FUSION, fused_mlp._POSTNORM_FUSION = origs


def variant_config(name: str) -> PanguConfig:
    """The flagship bf16 kernel-route config of variant ``name``."""
    check_variant(name)
    kw = {}
    if name in ("save_attn", "save_attn_mlp"):
        kw["remat_save_attention"] = True
    if name == "save_attn_mlp":
        kw["remat_save_mlp"] = True
    if name == "bf16_grads":
        kw["grads_dtype"] = "bfloat16"
    return pangu_pretrain(24, compute_dtype="bfloat16", matmul_precision="default",
                          use_pallas_attention=True, remat=name != "noremat", **kw)


def timed_steps(step: Callable[[], torch.Tensor], warmup: int, steps: int,
                device: torch.device) -> List[float]:
    """Host seconds of ``steps`` calls of ``step`` after ``warmup`` untimed
    ones, each ended by a synchronize of ``device`` (a CUDA device)."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return times


def launch_counts() -> Dict[str, int]:
    """Launches of every training kernel so far in this process."""
    return {"fused_block_attention": fused_block_attention.ATTN_FWD_LAUNCHES,
            "fused_block_attention_bwd": fused_block_attention.ATTN_BWD_LAUNCHES,
            "fused_residual_postnorm": fused_epilogue.FWD_LAUNCHES,
            "fused_residual_postnorm_bwd": fused_epilogue.BWD_LAUNCHES,
            "fused_mlp_postnorm": fused_mlp.FWD_LAUNCHES,
            "fused_mlp_postnorm_bwd": fused_mlp.BWD_LAUNCHES,
            "fused_mlp": fused_mlp.RAW_FWD_LAUNCHES,
            "fused_mlp_bwd": fused_mlp.RAW_BWD_LAUNCHES,
            "fused_earth_block_train": fused_block_train.FWD_LAUNCHES,
            "fused_earth_block_train_bwd": fused_block_train.BWD_LAUNCHES}


def seeded_step(cfg: PanguConfig, seed: int, device: torch.device) -> Callable[[], torch.Tensor]:
    """One flagship train step of ``cfg`` as a closure over seeded weights,
    aux constants, batch (inputs plus noise as targets) and drop-path
    generator on ``device``; each call is one optimizer update."""
    m = cfg.model
    model = PanguModel(m).to(device)
    init_params(model, seed=seed)
    aux = synthetic_aux_constants(m, cfg.train, seed=seed, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    fields = [aux.upper_mean + aux.upper_std * torch.randn(
        (1, m.upper_vars, m.levels, m.lat, m.lon), generator=gen, device=device),
        aux.surface_mean + aux.surface_std * torch.randn(
        (1, m.surface_vars, m.lat, m.lon), generator=gen, device=device)]
    batch = Batch(*fields, *(f + 0.5 * std * torch.randn(f.shape, generator=gen, device=device)
                             for f, std in zip(fields, (aux.upper_std, aux.surface_std))))
    step = make_train_step(model, cfg, make_optimizer(model, cfg))
    return lambda: step(batch, aux, gen)


def run_variant(name: str, warmup: int = 1, steps: int = 3, seed: int = 0,
                device: Optional[torch.device] = None) -> dict:
    """One variant on the card: ``warmup`` + ``steps`` seeded train steps.
    Returns the median step time, the step times, the peak memory and the
    kernel launches per step."""
    dev = device or torch.device("cuda", torch.cuda.current_device())
    with variant_flags(name):
        step = seeded_step(variant_config(name), seed, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = launch_counts()
        times = timed_steps(step, warmup, steps, dev)
        after = launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
    del step
    torch.cuda.empty_cache()
    n = warmup + steps
    return {"step_s": statistics.median(times), "times_s": times, "peak_bytes": peak,
            "launches_per_step": {k: (after[k] - before[k]) // n for k in after
                                  if after[k] != before[k]}}


def main(argv: Sequence[str]) -> int:
    variants = list(argv) or list(DEFAULT)
    for name in variants:  # refuse before any device minute is spent
        check_variant(name)
    if not torch.cuda.is_available():
        raise RuntimeError("the A/B needs a CUDA card")
    out = {}
    for name in variants:
        res = run_variant(name)
        out[name] = round(res["step_s"], 6)
        print(json.dumps({name: res}), flush=True)
    print(json.dumps({"train_ab": out, "device_kind": torch.cuda.get_device_name(0)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
