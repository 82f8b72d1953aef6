"""Full-geometry numerical-error bound of the bf16 kernel route against the
f32 path (port of ``scripts/parity_bf16_bound.py``).

The same f32 weights and the same inputs go through both configurations at
the published geometry (721x1440x13): the f32 path (float32, plain
composition, full-f32 products and convolutions: TF32 off) and the bf16
route (bfloat16 compute, the block kernel K1: the CUDA kernel on the card,
its plain version on the CPU). The deviation is measured in the model's
normalized output space (unit scale by construction, so the numbers read as
fractions of a standard deviation).

Prints one JSON line: max / mean|d| / RMS(d) per output plus per-variable
RMS, and the RMS relative to the f32 output's RMS, with the geometry, the
backend, the device's name and whether the kernel route ran.

    python -m pangu_tpu_torch.scripts.parity_bf16_bound [--tiny]

(``--tiny``: the pangu_tiny geometry on the CPU, a wiring check; the CUDA
kernel takes only the flagship widths.) The flagship reading needs the card.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.cli import require_device
from pangu_tpu_torch.config import pangu_pretrain, pangu_tiny
from pangu_tpu_torch.interop.from_jax import init_params
from pangu_tpu_torch.model import PanguModel


def _stats(ref: torch.Tensor, got: torch.Tensor, var_axis: int = 1) -> dict:
    d = got.double() - ref.double()
    per_var = [round(float(d.select(var_axis, i).pow(2).mean().sqrt()), 6)
               for i in range(d.shape[var_axis])]
    rms = float(d.pow(2).mean().sqrt())
    return {
        "max_abs": round(float(d.abs().max()), 6),
        "mean_abs": round(float(d.abs().mean()), 6),
        "rms": round(rms, 6),
        "rel_rms": round(rms / float(ref.double().pow(2).mean().sqrt()), 6),
        "per_var_rms": per_var,
    }


def run(tiny: bool = False, device="cuda") -> dict:
    device = require_device(device)
    make = pangu_tiny if tiny else (lambda **kw: pangu_pretrain(24, **kw))
    # the parity-tested configuration (tests/test_full_model_parity.py)
    cfg32 = make(compute_dtype="float32", matmul_precision="highest")
    # the kernel route
    cfg16 = make(compute_dtype="bfloat16", matmul_precision="default",
                 use_pallas_attention=True)
    m = cfg32.model
    aux = synthetic_aux_constants(m, cfg32.train, device=device)

    rng = np.random.default_rng(7)
    upper = torch.from_numpy(rng.standard_normal(
        (1, m.upper_vars, m.levels, m.lat, m.lon)).astype(np.float32)).to(device)
    surface = torch.from_numpy(rng.standard_normal(
        (1, m.surface_vars, m.lat, m.lon)).astype(np.float32)).to(device)

    t0 = time.monotonic()
    with device:  # parameters allocated there; .to moves the shift masks built from numpy
        model32, model16 = PanguModel(cfg32.model).to(device), PanguModel(cfg16.model).to(device)
    init_params(model32, seed=0)
    model16.load_state_dict(model32.state_dict())
    print(f"[bound +{time.monotonic() - t0:.0f}s] params ready", file=sys.stderr, flush=True)

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            u32, s32 = model32.eval()(upper, surface, aux)
            print(f"[bound +{time.monotonic() - t0:.0f}s] f32 path done", file=sys.stderr,
                  flush=True)
            u16, s16 = model16.eval()(upper, surface, aux)
            print(f"[bound +{time.monotonic() - t0:.0f}s] bf16 path done", file=sys.stderr,
                  flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    return {
        "geometry": "tiny" if tiny else "full-721x1440x13",
        "backend": device.type,
        "device_kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"),
        "pallas": bool(cfg16.model.use_pallas_attention),
        "upper": _stats(u32, u16),
        "surface": _stats(s32, s16),
    }


def main(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """``device`` defaults to the card, and to the CPU with ``--tiny``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    tiny = "--tiny" in argv
    out = run(tiny=tiny, device=device or ("cpu" if tiny else "cuda"))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
