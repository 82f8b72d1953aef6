"""Pipeline-parallel training entry point (port of ``scripts/pipeline_train.py``;
the role of the reference's ``deepspeed --num_gpus=8
models/pangu_model_deepspeed.py`` smoke trainer, reference
models/pangu_model_deepspeed.py:102-125 + train.sh:55).

Runs the GPipe schedule (``pangu_tpu_torch.parallel.pipeline``) over a
``(data, pipe)`` mesh, one process per card, for a bounded number of steps
and logs the losses on rank 0: the pipeline counterpart of the finetune
script. ``parallel.pipe`` picks the stage count (any contiguous partition
size of the 8-op backbone chain: 2 the mid-network cut, 4 the reference's
U-Net joints, the default when unset); the data axis holds WORLD_SIZE / pipe
replicas. Each rank loads the global batch of ``--microbatches`` x replicas
samples (the first stage reads its inputs, the last its targets). Runs on
the card; ``main(argv, device="cpu")`` runs on the CPU over gloo.

    torchrun --nproc-per-node 4 -m pangu_tpu_torch.scripts.pipeline_train \\
        --preset tiny --set data.store=synthetic --set parallel.pipe=4 \\
        --steps 4 --microbatches 2
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

from pangu_tpu_torch.aux import load_aux_constants
from pangu_tpu_torch.cli import base_parser, build_config, load_model_and_params, require_device
from pangu_tpu_torch.data import make_loader
from pangu_tpu_torch.parallel import distributed_init, resolve_mesh
from pangu_tpu_torch.parallel.pipeline import PanguPipeline
from pangu_tpu_torch.scripts.finetune import rank_logger
from pangu_tpu_torch.train.step import make_optimizer


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> List[float]:
    """Returns the step losses (the same on every rank)."""
    p = base_parser("GPipe pipeline-parallel training")
    p.add_argument("--steps", type=int, default=4, help="number of optimizer steps to run")
    p.add_argument("--microbatches", type=int, default=2)
    args = p.parse_args(argv)
    device = distributed_init(device=require_device(device))
    cfg = build_config(args)
    if cfg.parallel.pipe == 1:
        cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel, pipe=4))
    mesh = resolve_mesh(cfg.parallel, device, cfg.model)

    out_dir = os.path.join(cfg.out_dir, "pipeline_train", str(cfg.horizon))
    os.makedirs(out_dir, exist_ok=True)
    logger = rank_logger("pipeline", os.path.join(out_dir, "pipeline.log"))

    aux = load_aux_constants(cfg.model, cfg.train, args.aux_dir, cfg.horizon, device=device)
    pipeline = PanguPipeline(cfg, mesh, device)
    # the whole model on the host; the pipeline copies its stage's tensors to the card
    pipeline.load_state_dict(load_model_and_params(cfg, args, aux, device="cpu").state_dict())
    loader = make_loader(cfg.data, cfg.model, "train", cfg.horizon,
                         args.microbatches * mesh.data)
    # steps_per_epoch converts the epoch-valued lr_milestones to step boundaries,
    # as the finetune script does
    step = pipeline.make_train_step(make_optimizer(pipeline.stage, cfg), args.microbatches,
                                    steps_per_epoch=len(loader))

    losses, it = [], iter(loader)
    for i in range(args.steps):
        try:
            batch, _ = next(it)
        except StopIteration:
            it = iter(loader)
            batch, _ = next(it)
        losses.append(float(step(batch, aux)))
        logger.info("step %d: loss %.6f", i, losses[-1])

    final = pipeline.state_dict()
    if final is not None:
        logger.info("done: %d steps, %s params, mesh %s", args.steps,
                    f"{sum(t.numel() for t in final.values()):,}",
                    dict(data=mesh.data, pipe=mesh.pipe, lat=1, lon=1))
    return losses


if __name__ == "__main__":
    main()
