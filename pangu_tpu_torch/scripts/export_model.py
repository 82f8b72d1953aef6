"""Export a serving artifact (port of ``scripts/export_model.py``; role of
the reference's ONNX model files, which its inference engine runs through
onnxruntime, inference/inference_*.py ort.InferenceSession usage).

The artifact is a ``torch.export`` program of the whole forecast step (the
forward, then de-normalization) with the weights and aux constants inside,
which any process serves through
``pangu_tpu_torch.serving.load_forecast_step`` with no model code:

    python -m pangu_tpu_torch.scripts.export_model --weights ckpt.npz \\
        --aux-dir aux/ --out-file pangu24.pt2 \\
        --set model.compute_dtype=bfloat16 --set model.use_pallas_attention=true

The two overrides take the kernel route (bf16, the block kernel K1 as the
operator ``pangu_tpu_torch::fused_earth_block``); without them the artifact
holds the f32 plain path. ``--platforms`` names the one device the artifact
holds its weights on (``cuda``, the default, or ``cpu``). The artifact is
tied to the torch version that wrote it. Runs on the card;
``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from pangu_tpu_torch.aux import load_aux_constants
from pangu_tpu_torch.cli import base_parser, build_config, load_model_and_params, require_device
from pangu_tpu_torch.utils.logger import get_logger


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> str:
    """Returns the artifact's path."""
    p = base_parser("Export a serving artifact (torch.export program)")
    p.add_argument("--out-file", type=str, default="pangu_forecast.pt2",
                   help="output artifact path")
    p.add_argument("--batch", type=int, default=1,
                   help="batch dimension baked into the artifact")
    p.add_argument("--platforms", type=str, default=None,
                   help="the one device the artifact holds its weights on (cuda or cpu); "
                        "default: the device the model is built on")
    p.add_argument("--skip-check", action="store_true",
                   help="skip the load-back smoke check of the artifact")
    args = p.parse_args(argv)
    device = require_device(device)

    cfg = build_config(args)
    logger = get_logger("export_model")

    from pangu_tpu_torch.serving import export_device, export_forecast_step, load_forecast_step

    aux = load_aux_constants(cfg.model, cfg.train, args.aux_dir, cfg.horizon, device=device)
    model = load_model_and_params(cfg, args, aux, device=device)
    platforms = ([s.strip() for s in args.platforms.split(",") if s.strip()]
                 if args.platforms else None)
    target = export_device(model, platforms)

    logger.info("exporting forecast step (horizon %dh, batch %d, %s) -> %s",
                cfg.horizon, args.batch, target, args.out_file)
    export_forecast_step(model, aux, args.out_file, batch=args.batch, platforms=platforms)
    size = os.path.getsize(args.out_file)
    logger.info("wrote %s (%.1f MB)", args.out_file, size / 1e6)

    if not args.skip_check:
        m = cfg.model
        step = load_forecast_step(args.out_file)
        u = torch.zeros((args.batch, m.upper_vars, m.levels, m.lat, m.lon), device=target)
        s = torch.zeros((args.batch, m.surface_vars, m.lat, m.lon), device=target)
        ou, os_ = step(u, s)
        assert bool(torch.isfinite(ou).all()) and bool(torch.isfinite(os_).all()), \
            "artifact produced non-finite outputs on the zero field"
        logger.info("load-back check passed: %s %s", tuple(ou.shape), tuple(os_.shape))
    return args.out_file


if __name__ == "__main__":
    main()
