"""Standalone evaluation (port of ``scripts/test.py``; reference
inference/test_main.py): load weights, score the test range, write
rmse_*/acc_* CSVs under ``<out>/test/<horizon>/csv``.

    python -m pangu_tpu_torch.scripts.test --weights params_24.npz \\
        --set model.compute_dtype=bfloat16 --set model.use_pallas_attention=true

The two overrides take the kernel route (bf16, the block kernel); without
them the model runs the f32 plain path, the config's default. Runs on the
card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from pangu_tpu_torch.aux import load_aux_constants
from pangu_tpu_torch.cli import base_parser, build_config, load_model_and_params, require_device
from pangu_tpu_torch.data import make_loader
from pangu_tpu_torch.eval import evaluate
from pangu_tpu_torch.utils.logger import get_logger


def main(argv: Optional[Sequence[str]] = None, device="cuda",
         spans: Optional[dict] = None) -> float:
    """Returns the mean test loss; ``spans``, when given, gains evaluate's
    wall seconds by phase (``pangu_tpu_torch.eval.evaluate``)."""
    p = base_parser("Evaluate a Pangu-Weather checkpoint")
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--lora-weights", type=str, default=None,
                   help="merge a LoRA trainable tree before evaluating (not ported yet)")
    args = p.parse_args(argv)
    if args.lora_weights:
        raise SystemExit("--lora-weights: LoRA is not ported yet (ROADMAP queue 1, item 7)")
    device = require_device(device)

    cfg = build_config(args)
    out_dir = os.path.join(cfg.out_dir, "test", str(cfg.horizon))
    os.makedirs(out_dir, exist_ok=True)
    logger = get_logger("test", os.path.join(out_dir, "test.log"))

    aux = load_aux_constants(cfg.model, cfg.train, args.aux_dir, cfg.horizon, device=device)
    model = load_model_and_params(cfg, args, aux, device=device)
    loader = make_loader(cfg.data, cfg.model, "test", cfg.horizon, cfg.eval.batch_size)
    loss = evaluate(model, loader, aux, cfg, out_dir, visualize=args.visualize, logger=logger,
                    spans=spans)
    logger.info("done; csv scores under %s", os.path.join(out_dir, "csv"))
    return loss


if __name__ == "__main__":
    main()
