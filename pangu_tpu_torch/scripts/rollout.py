"""Autoregressive rollout inference (port of ``scripts/rollout.py``; reference
inference/inference_singleOutput.py, inference_multiOutput.py, the mix24
variants and inference_iterative.py — selected by --mode). Scores land under
``<out>/rollout_<mode>/<horizon>``.

    python -m pangu_tpu_torch.scripts.rollout --mode multi --lead-days 2 \\
        --weights params_24.npz \\
        --set model.compute_dtype=bfloat16 --set model.use_pallas_attention=true

The two overrides take the kernel route (bf16, the block kernel); without
them the models run the f32 plain path, the config's default. Runs on the
card; ``main(argv, device="cpu")`` runs on the CPU. ``--aggregate`` needs
pandas (and matplotlib for its plots).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from pangu_tpu_torch.aux import load_aux_constants
from pangu_tpu_torch.cli import base_parser, build_config, load_model_and_params, require_device
from pangu_tpu_torch.data import make_loader
from pangu_tpu_torch.data.dataset import Era5Dataset, _freq_hours, make_store
from pangu_tpu_torch.rollout import (
    ModelBundle,
    iterative_eval,
    multi_output_rollout,
    single_output_eval,
)
from pangu_tpu_torch.rollout.engines import mix24_rule
from pangu_tpu_torch.utils.logger import get_logger


def _bundle_for(cfg, args, aux, horizon, weights, device):
    sub = argparse.Namespace(**vars(args))
    sub.weights = weights
    return ModelBundle(load_model_and_params(cfg, sub, aux, device=device), aux, horizon)


def _aggregate(args, out_dir: str) -> None:
    from pangu_tpu_torch.rollout.aggregate import write_aggregates

    write_aggregates(out_dir, os.path.join(out_dir, "agg"),
                     family=args.agg_family, column=args.agg_column, plot=True)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> str:
    """Returns the directory the scores were written under."""
    p = base_parser("Rollout inference")
    p.add_argument("--mode", default="multi",
                   choices=["single", "multi", "mix24", "iterative"])
    p.add_argument("--lead-days", type=int, default=10)
    p.add_argument("--weights-6", type=str, default=None)
    p.add_argument("--weights-3", type=str, default=None)
    p.add_argument("--weights-1", type=str, default=None)
    p.add_argument("--weights-24", type=str, default=None)
    p.add_argument("--aggregate", action="store_true",
                   help="also write forecast-hour aggregation CSVs/plots")
    p.add_argument("--agg-family", default="surface_wind_speed",
                   help="score family to aggregate (e.g. upper_wind_speed "
                        "for the reference's calculate_avg_rmse_upper role)")
    p.add_argument("--agg-column", default=None,
                   help="column within the family (e.g. 850 for 850hPa)")
    p.add_argument("--score-weights", type=str, default=None,
                   help="score this checkpoint while --weights drives the "
                        "autoregressive state (mixed evaluation)")
    args = p.parse_args(argv)
    device = require_device(device)

    cfg = build_config(args)
    out_dir = os.path.join(cfg.out_dir, f"rollout_{args.mode}", str(cfg.horizon))
    os.makedirs(out_dir, exist_ok=True)
    logger = get_logger("rollout", os.path.join(out_dir, "rollout.log"))

    aux = load_aux_constants(cfg.model, cfg.train, args.aux_dir, cfg.horizon, device=device)
    base = _bundle_for(cfg, args, aux, cfg.horizon, args.weights, device)

    if args.mode == "single":
        loader = make_loader(cfg.data, cfg.model, "test", cfg.horizon, 1)
        # autoregressive depth: the target is horizon hours out, reached in
        # test-frequency-sized model applications (reference
        # inference_singleOutput.py:141-153, spaces = h // freq)
        steps = max(1, cfg.horizon // _freq_hours(cfg.data.test_freq))
        single_output_eval(base, loader, cfg, out_dir, steps=steps)
        logger.info("scores under %s/csv (%d autoregressive steps)",
                    out_dir, steps)
        return out_dir

    store = make_store(cfg.data, cfg.model)
    dataset = Era5Dataset(store, cfg.data.test_start, cfg.data.test_end,
                          cfg.data.test_freq, cfg.horizon)

    bundles = {cfg.horizon: base}
    for h, w in ((24, args.weights_24), (6, args.weights_6),
                 (3, args.weights_3), (1, args.weights_1)):
        if w is None:
            continue
        if h == cfg.horizon and args.weights is None:
            # --weights-<h> naming the BASE horizon replaces the base
            # bundle: silently keeping `base` here would score a
            # randomly initialized model on the ladder's own rung
            hcfg = cfg
        elif h in bundles:
            continue
        else:
            hcfg = cfg.replace(horizon=h)
        # aux is horizon-keyed (constantMask{h}.npy, the horizon's land
        # mask); each bundle must load its own
        h_aux = load_aux_constants(cfg.model, cfg.train, args.aux_dir, h, device=device)
        bundles[h] = _bundle_for(hcfg, args, h_aux, h, w, device)
        if h == cfg.horizon:
            base = bundles[h]

    if args.mode == "iterative":
        missing = [h for h in (24, 6, 3, 1) if h not in bundles]
        if missing:
            logger.warning("iterative ladder missing horizons %s; "
                           "reusing the base model for them", missing)
            for h in missing:
                bundles[h] = base
        iterative_eval(bundles, dataset, cfg, out_dir,
                       spill_dir=os.path.join(out_dir, "spill"))
        if args.aggregate:
            _aggregate(args, out_dir)
        logger.info("per-init ladder scores under %s", out_dir)
        return out_dir

    rule = mix24_rule(cfg.horizon) if args.mode == "mix24" else None
    if args.mode == "mix24":
        # validate up front: the rule may select any of these horizons and
        # multi_output_rollout looks bundles up unguarded — a missing one
        # would KeyError minutes into the rollout
        need = {24} | ({6} if cfg.horizon == 3 else set())
        missing = sorted(need - set(bundles))
        if missing:
            raise SystemExit(
                f"--mode mix24 with base {cfg.horizon}h needs weights for "
                f"horizons {missing} (--weights-24 / --weights-6)")
    score_bundle = (
        _bundle_for(cfg, args, aux, cfg.horizon, args.score_weights, device)
        if args.score_weights else None
    )
    multi_output_rollout(bundles, dataset, cfg, out_dir, cfg.horizon,
                         lead_days=args.lead_days, choose_horizon=rule,
                         score_bundle=score_bundle)
    if args.aggregate:
        _aggregate(args, out_dir)
    logger.info("per-init scores under %s", out_dir)
    return out_dir


if __name__ == "__main__":
    main()
