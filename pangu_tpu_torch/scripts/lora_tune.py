"""LoRA finetuning entry point (port of ``scripts/lora_tune.py``; reference
finetune/lora_tune.py).

Routes the LoRA tree through the SAME Trainer as full finetuning --
validation, early stopping, best-model tracking and checkpoint-resume all
apply (the reference routes LoRA through its shared train() engine,
finetune/lora_tune.py:250 -> models/pangu_sample.py:278-381).

    python -m pangu_tpu_torch.scripts.lora_tune --weights params_24.npz \\
        --set model.compute_dtype=bfloat16 --set model.use_pallas_attention=true

On the kernel route the merged form (the default) runs K2-K7 with the
merged weights; ``--unmerged`` takes peft's adapter-dropout form, whose
adapted sites run the plain path. The best tree is written to
``<out>/lora/<horizon>/lora_best.npz`` in the JAX package's layout. Runs on
the card; ``main(argv, device="cpu")`` runs on the CPU.

Data parallel as the finetune script (``torchrun --nproc-per-node N -m
pangu_tpu_torch.scripts.lora_tune ...``, ``parallel.lat``/``lon`` too):
replicated adapters whose gradients are averaged over the data axis, each
replica on its shard of every global batch (the JAX script's "replicated
adapters + data-sharded global batches"); under a spatial mesh the adapters
of the blocks' linears are summed over the plane first, as every tensor
used on a slab is; rank 0 writes the files and scores the test range.
``parallel.pipe`` > 1 raises, as in the finetune script.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from pangu_tpu_torch.aux import load_aux_constants
from pangu_tpu_torch.cli import base_parser, build_config, load_model_and_params, require_device
from pangu_tpu_torch.data import make_loader
from pangu_tpu_torch.eval import evaluate
from pangu_tpu_torch.interop.from_jax import load_lora_npz, save_lora_npz
from pangu_tpu_torch.parallel import activate_mesh, distributed_init, is_main, resolve_mesh
from pangu_tpu_torch.parallel.sharding import shard_params
from pangu_tpu_torch.scripts.finetune import (open_writer, rank_logger, refuse_pipeline,
                                             shard_of_world)
from pangu_tpu_torch.train.lora import (
    LoraConfig,
    changed_param_report,
    count_trainable,
    detach_lora,
    flatten_trainable,
    init_lora_params,
    make_lora_eval_step,
    make_lora_train_step,
    merge_params,
    unflatten_trainable,
)
from pangu_tpu_torch.train.step import TrainState, make_optimizer
from pangu_tpu_torch.train.trainer import Trainer
from pangu_tpu_torch.utils.summary import param_count


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> Optional[float]:
    """Returns the mean test loss of the merged best tree on rank 0, None on
    the other ranks."""
    p = base_parser("LoRA-finetune the Pangu-Weather model")
    p.add_argument("--rank", type=int, default=16)
    p.add_argument("--alpha", type=float, default=16.0)
    p.add_argument("--only-test", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest train_{n} LoRA checkpoint")
    p.add_argument("--lora-weights", type=str, default=None,
                   help="previously saved LoRA trainable tree (.npz)")
    p.add_argument("--dropout", type=float, default=0.1,
                   help="lora-dropout rate (reference lora_tune.py:176)")
    p.add_argument("--unmerged", action="store_true",
                   help="train with peft's unmerged per-element adapter-dropout forward "
                        "instead of the merged weights (identical when --dropout 0; "
                        "train.lora docstring)")
    args = p.parse_args(argv)
    device = distributed_init(device=require_device(device))

    cfg = build_config(args)
    mesh = resolve_mesh(cfg.parallel, device, cfg.model)
    refuse_pipeline(cfg)
    world, rank = shard_of_world(mesh)
    out_dir = os.path.join(cfg.out_dir, "lora", str(cfg.horizon))
    os.makedirs(out_dir, exist_ok=True)
    logger = rank_logger("lora", os.path.join(out_dir, "lora.log"))

    aux = load_aux_constants(cfg.model, cfg.train, args.aux_dir, cfg.horizon, device=device)
    model = load_model_and_params(cfg, args, aux, device=device)
    # the base weights stay frozen and the heads are replaced, not changed:
    # the state dict's tensors stay the base
    base_params = model.state_dict()
    lcfg = LoraConfig(rank=args.rank, alpha=args.alpha, dropout=args.dropout)

    trainable = (
        load_lora_npz(args.lora_weights, cfg.model, device)
        if args.lora_weights
        else init_lora_params(base_params, lcfg,
                              torch.Generator(device=device).manual_seed(cfg.train.seed))
    )
    logger.info(
        "trainable params: %s of %s (%.2f%%)",
        f"{count_trainable(trainable):,}", f"{param_count(base_params):,}",
        100.0 * count_trainable(trainable) / param_count(base_params),
    )

    if not args.only_test:
        train_loader = make_loader(cfg.data, cfg.model, "train", cfg.horizon,
                                   max(1, cfg.train.batch_size // world),
                                   num_shards=world, shard=rank)
        val_loader = make_loader(cfg.data, cfg.model, "val", cfg.horizon, 1,
                                 num_shards=world, shard=rank)
        steps = len(train_loader)
        with activate_mesh(mesh):
            # a plain optimizer: the adapters and their moments stay replicated
            trainer = Trainer(
                cfg, model, aux, out_dir, writer=open_writer(out_dir) if is_main() else None,
                logger=logger, steps_per_epoch=steps,
                optimizer=make_optimizer(flatten_trainable(trainable).values(), cfg),
                train_step_fn=lambda opt: make_lora_train_step(
                    model, cfg, opt, base_params, lcfg, trainable, unmerged=args.unmerged,
                    steps_per_epoch=steps),
                eval_step_fn=make_lora_eval_step(model, cfg, base_params, lcfg, trainable),
            )
            state = TrainState(flatten_trainable(trainable), trainer.optimizer)
            start_epoch = 1
            if args.resume:
                state, start_epoch = trainer.resume(template=state)
                logger.info("resumed at epoch %d", start_epoch)
            if mesh is not None:
                shard_params(state.params, mesh)

            best, state = trainer.fit(train_loader, val_loader, start_epoch=start_epoch,
                                      state=state)
        trainable = unflatten_trainable(best)
        if is_main():
            save_lora_npz(os.path.join(out_dir, "lora_best.npz"), cfg.model, trainable)

    if not is_main():
        return None

    merged = merge_params(base_params, trainable, lcfg)
    changed = changed_param_report(base_params, merged)
    logger.info("changed params after LoRA: %d (e.g. %s)", len(changed), changed[:5])
    detach_lora(model)
    model.load_state_dict(merged)
    test_loader = make_loader(cfg.data, cfg.model, "test", cfg.horizon, cfg.eval.batch_size)
    return evaluate(model, test_loader, aux, cfg, out_dir, logger=logger)


if __name__ == "__main__":
    main()
