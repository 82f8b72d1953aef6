"""Full finetuning entry point (port of ``scripts/finetune.py``; reference
finetune/finetune_fully.py): train with validation, early stopping,
best-model tracking and checkpoint-resume, then score the test range.

    python -m pangu_tpu_torch.scripts.finetune --weights params_24.npz \\
        --set model.compute_dtype=bfloat16 --set model.use_pallas_attention=true

The two overrides take the kernel route (bf16; K2-K7 in the train step, K1
in the test forecast); without them the model runs the f32 plain path.
Checkpoints go to ``<out>/finetune_fully/<horizon>/models`` (``train_<n>/``,
``best/``); ``--resume`` continues from the latest. Runs on the card;
``main(argv, device="cpu")`` runs on the CPU.

Data parallel, one process per card, ZeRO-2 by default (``parallel.*``),
with the token grid optionally sharded over a lat x lon plane of ranks:

    torchrun --nproc-per-node N -m pangu_tpu_torch.scripts.finetune ...
    torchrun --nproc-per-node 4 -m pangu_tpu_torch.scripts.finetune ... \
        --set parallel.lat=2 --set parallel.lon=2

The data axis holds N / (lat * lon) replicas (``resolve_mesh``). Each
replica loads ``train.batch_size // replicas`` samples a step from its
shard of the train and val ranges, the same on each of its spatial peers;
rank 0 writes the checkpoints, the log file and the writer, and scores the
test range. ``parallel.pipe`` > 1 raises in a world of processes: the
pipeline trains through ``pangu_tpu_torch.scripts.pipeline_train`` (the JAX
script would run its SPMD step with the pipe devices replicating one
another). Any axis > 1 in a single process raises.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

from pangu_tpu_torch.aux import load_aux_constants
from pangu_tpu_torch.cli import base_parser, build_config, load_model_and_params, require_device
from pangu_tpu_torch.data import make_loader
from pangu_tpu_torch.eval import evaluate
from pangu_tpu_torch.parallel import (activate_mesh, distributed_init, is_main, resolve_mesh,
                                      shard_params)
from pangu_tpu_torch.train.trainer import Trainer, init_train_state
from pangu_tpu_torch.utils.logger import get_logger
from pangu_tpu_torch.utils.summary import param_count


def rank_logger(name: str, path: str) -> logging.Logger:
    """The script's logger: rank 0 logs to ``path`` and the stream; other
    ranks log warnings to the stream only."""
    if is_main():
        return get_logger(name, path)
    logger = get_logger(name)
    logger.setLevel(logging.WARNING)
    return logger


def shard_of_world(mesh) -> tuple:
    """(data replicas, this rank's data coordinate) of ``mesh``: the loaders'
    shards (spatial peers load the same samples); (1, 0) without one."""
    return (mesh.data, mesh.data_rank) if mesh is not None else (1, 0)


def refuse_pipeline(cfg) -> None:
    """Raise for ``parallel.pipe`` > 1: this script's step runs no pipeline."""
    if cfg.parallel.pipe > 1:
        raise ValueError(f"parallel.pipe={cfg.parallel.pipe}: the pipeline trains through "
                         "pangu_tpu_torch.scripts.pipeline_train (torchrun --nproc-per-node N "
                         "-m pangu_tpu_torch.scripts.pipeline_train ...)")


def open_writer(out_dir: str):
    """A tensorboardX writer under ``out_dir/writer`` when tensorboardX imports."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(os.path.join(out_dir, "writer"))


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> Optional[float]:
    """Returns the mean test loss of the best params on rank 0, None on the
    other ranks."""
    p = base_parser("Fully finetune the Pangu-Weather model")
    p.add_argument("--only-test", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest train_{n} checkpoint")
    p.add_argument("--visualize", action="store_true")
    args = p.parse_args(argv)
    device = distributed_init(device=require_device(device))

    cfg = build_config(args)
    # resolve_mesh expands a default config over every rank and refuses any axis > 1 in
    # one process
    mesh = resolve_mesh(cfg.parallel, device, cfg.model)
    refuse_pipeline(cfg)
    world, rank = shard_of_world(mesh)
    out_dir = os.path.join(cfg.out_dir, "finetune_fully", str(cfg.horizon))
    os.makedirs(out_dir, exist_ok=True)
    logger = rank_logger("finetune", os.path.join(out_dir, "finetune.log"))

    aux = load_aux_constants(cfg.model, cfg.train, args.aux_dir, cfg.horizon, device=device)
    model = load_model_and_params(cfg, args, aux, device=device)
    logger.info("model parameters: %s", f"{param_count(model):,}")

    per_rank_batch = max(1, cfg.train.batch_size // world)
    train_loader = make_loader(cfg.data, cfg.model, "train", cfg.horizon, per_rank_batch,
                               accumulation=cfg.train.accumulation_steps,
                               num_shards=world, shard=rank)
    # each rank's shard, wrap-padded to equal counts: validation runs in lockstep
    val_loader = make_loader(cfg.data, cfg.model, "val", cfg.horizon, 1,
                             num_shards=world, shard=rank)

    with activate_mesh(mesh):
        # --visualize covers both reference surfaces: val-time triptychs during
        # fit (pangu_sample.py:332-358, one process only) and test-time PNGs after
        trainer = Trainer(cfg, model, aux, out_dir,
                          writer=open_writer(out_dir) if is_main() else None, logger=logger,
                          steps_per_epoch=len(train_loader), visualize=args.visualize)
        state = init_train_state(model, cfg, aux, trainer.optimizer)
        start_epoch = 1
        if args.resume:
            state, start_epoch = trainer.resume()
            logger.info("resumed at epoch %d", start_epoch)
        if mesh is not None:
            shard_params(state.params, mesh)

        if not args.only_test:
            best_params, state = trainer.fit(train_loader, val_loader, start_epoch=start_epoch,
                                             state=state)
            model.load_state_dict(best_params)

    if not is_main():
        return None
    logger.info("Begin testing...")
    test_loader = make_loader(cfg.data, cfg.model, "test", cfg.horizon, cfg.eval.batch_size)
    return evaluate(model, test_loader, aux, cfg, out_dir, visualize=args.visualize,
                    logger=logger)


if __name__ == "__main__":
    main()
