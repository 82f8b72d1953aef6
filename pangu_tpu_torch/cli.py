"""Shared CLI plumbing for the port's scripts (port of ``pangu_tpu/cli.py``).

One flag system over the dataclass config: every script takes
``--config file.yaml`` and repeated ``--set key=value`` dotted overrides.
The config's default is the f32 plain path; the kernel route is
``--set model.compute_dtype=bfloat16 --set model.use_pallas_attention=true``.
Models and aux constants go to the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse

import torch

from pangu_tpu_torch.config import (
    PanguConfig,
    apply_overrides,
    load_config,
    pangu_pretrain,
    pangu_tiny,
)


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", type=str, default=None,
                   help="YAML/JSON config file (default: pretrained preset)")
    p.add_argument("--preset", type=str, default="pretrain",
                   choices=["pretrain", "tiny"],
                   help="base preset when --config is not given")
    p.add_argument("--horizon", type=int, default=24, choices=[1, 3, 6, 24])
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted config override")
    p.add_argument("--out", type=str, default=None, help="output directory")
    p.add_argument("--weights", type=str, default=None,
                   help="checkpoint: reference .pth or params .npz")
    p.add_argument("--aux-dir", type=str, default=None,
                   help="directory with normalization/mask .npy files "
                        "(synthetic constants when absent)")
    return p


def build_config(args) -> PanguConfig:
    if args.config:
        cfg = load_config(args.config)
    elif args.preset == "tiny":
        cfg = pangu_tiny()
    else:
        cfg = pangu_pretrain(horizon=args.horizon)
    if args.horizon and not args.config:
        cfg = cfg.replace(horizon=args.horizon)
    cfg = apply_overrides(cfg, args.overrides)
    if args.out:
        cfg = cfg.replace(out_dir=args.out)
    return cfg


def require_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it is the card and there is
    none (never carries on on the CPU unasked)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def load_model_and_params(cfg: PanguConfig, args, aux, device="cuda"):
    """Build the model on ``device`` and load its weights from --weights: a
    reference ``.pth`` (the port's names are the reference's, so the state
    dict loads strictly as it is) or a params ``.npz`` written by either
    package; without --weights, seeded weights from ``cfg.train.seed``.
    Returns the model, in eval mode."""
    from pangu_tpu_torch.interop.from_jax import init_params, load_jax_params
    from pangu_tpu_torch.model import PanguModel

    device = require_device(device)
    with device:  # parameters are allocated and default-initialized there
        model = PanguModel(cfg.model)
    if args.weights:
        path = args.weights
        if path.endswith(".pth"):
            from pangu_tpu_torch.interop.torch_import import load_torch_checkpoint

            state = load_torch_checkpoint(path)
            model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                                  strict=True)
        elif path.endswith(".npz"):
            from pangu_tpu_torch.interop.npz_io import load_params_npz

            load_jax_params(model, cfg.model, load_params_npz(path))
        else:
            raise NotImplementedError(
                f"{path}: orbax checkpoint directories belong to the trainer, which is not "
                "ported yet (ROADMAP queue 1, item 6); convert the params to .npz with the "
                "JAX package")
    else:
        init_params(model, cfg.train.seed)
    return model.to(device).eval()
