"""One rank of the port's data-parallel jig (tests/test_torch_parallel.py).

Run as: python tests/torch_parallel_worker.py '<spec as JSON>'

The spec holds ``world``, ``rank``, ``init`` (a ``file://`` store), ``dir``
(the fixture's directory: the weights, the global batch and the world-1
checkpoint written by the test, and where each rank saves its results) and
``cases``, the list of cases to run in order, and ``out``, where the rank
saves ``rank<r>.pt``: each case's loss, parameters and whatever else it
records. The rank joins a gloo group through
``pangu_tpu_torch.parallel.distributed_init``; with ``"device": "cuda"`` in
the spec an NCCL group on card ``rank``, where the ``card`` case runs.
It imports nothing of jax or the JAX package.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_card as card  # noqa: E402
from pangu_tpu_torch.aux import synthetic_aux_constants  # noqa: E402
from pangu_tpu_torch.config import DataConfig, ParallelConfig, pangu_tiny  # noqa: E402
from pangu_tpu_torch.data import make_loader  # noqa: E402
from pangu_tpu_torch.interop.from_jax import init_params  # noqa: E402
from pangu_tpu_torch.model import PanguModel  # noqa: E402
from pangu_tpu_torch.parallel import (activate_mesh, distributed_init, make_mesh,  # noqa: E402
                                      resolve_mesh, shard_batch, zero_shard_opt_state)
from pangu_tpu_torch.train import Batch, make_eval_step, make_optimizer, make_train_step  # noqa
from pangu_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from pangu_tpu_torch.train.step import TrainState  # noqa: E402
from pangu_tpu_torch.train.trainer import sharded_val_stats  # noqa: E402

#: the three modes of the mesh step: (zero_opt_state, zero_gradients)
MODES = {"zero2": (True, True), "zero1": (True, False), "dp": (False, False)}
#: the synthetic store's ranges of the validation case and the script cases
DATES = dict(store="synthetic", train_start="20180101", train_end="20180104", train_freq="24h",
             val_start="20180105", val_end="20180109", val_freq="24h",
             test_start="20180108", test_end="20180110", test_freq="24h", prefetch=0)


def config(mode: str = "zero2", drop_path: float = 0.2):
    cfg = pangu_tiny(drop_path_max=drop_path)
    zero_opt, zero_grads = MODES[mode]
    return cfg.replace(parallel=ParallelConfig(data=1, zero_opt_state=zero_opt,
                                               zero_gradients=zero_grads))


def model_from(path: str, cfg):
    model = PanguModel(cfg.model)
    model.load_state_dict(torch.load(path))
    return model


def sharded_step(model, cfg, mesh, steps_per_epoch: int = 1):
    """(step, train state) of the mesh's mode: the optimizer sharded when
    ``cfg.parallel.zero_opt_state``."""
    opt = zero_shard_opt_state(make_optimizer(model, cfg), mesh, cfg.parallel.zero_opt_state)
    return (make_train_step(model, cfg, opt, steps_per_epoch),
            TrainState(dict(model.named_parameters()), opt))


def params_of(model) -> dict:
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def case_modes(spec, mesh, aux, out):
    """One step of each mode from the same weights and global batch, drop
    path on (the generator the same on every rank)."""
    batch = shard_batch(Batch(*torch.load(os.path.join(spec["dir"], "batch.pt"))), mesh)
    for mode in MODES:
        cfg = config(mode)
        model = model_from(os.path.join(spec["dir"], "w0.pt"), cfg)
        step, _ = sharded_step(model, cfg, mesh)
        loss = step(batch, aux, torch.Generator().manual_seed(5))
        out[mode] = dict(loss=loss.item(), params=params_of(model))


def case_jax(spec, mesh, aux, out):
    """The ZeRO-2 step from the JAX package's initial weights, drop path off."""
    cfg = config(drop_path=0.0)
    batch = shard_batch(Batch(*torch.load(os.path.join(spec["dir"], "batch.pt"))), mesh)
    model = model_from(os.path.join(spec["dir"], "w_jax.pt"), cfg)
    step, _ = sharded_step(model, cfg, mesh)
    out["jax"] = dict(loss=step(batch, aux).item(), params=params_of(model))


def case_val(spec, mesh, aux, out):
    """``sharded_val_stats`` over this rank's shard of a 3-sample range."""
    cfg = config(drop_path=0.0).replace(data=DataConfig(**DATES))
    model = model_from(os.path.join(spec["dir"], "w_jax.pt"), cfg)
    val = make_loader(cfg.data, cfg.model, "val", cfg.horizon, 1, num_shards=mesh.data,
                      shard=mesh.rank)
    out["val"] = sharded_val_stats(make_eval_step(model, cfg), val, aux, torch.device("cpu"),
                                   count=mesh.data)


def case_ckpt(spec, mesh, aux, out):
    """ZeRO-2: step 1, a save of ``train_1`` from every rank, step 2; then a
    fresh model and optimizer restored from that checkpoint, and from the
    world-1 checkpoint the test wrote, each taking step 2."""
    cfg = config()
    batch = shard_batch(Batch(*torch.load(os.path.join(spec["dir"], "batch.pt"))), mesh)
    model = model_from(os.path.join(spec["dir"], "w0.pt"), cfg)
    step, state = sharded_step(model, cfg, mesh)
    step(batch, aux, torch.Generator().manual_seed(11))
    ckpt.save_train_state(os.path.join(spec["dir"], "ckpt"), 1, state)
    loss = step(batch, aux, torch.Generator().manual_seed(12))
    out["uninterrupted"] = dict(loss=loss.item(), params=params_of(model))
    for name, d in (("resumed", "ckpt"), ("from_world1", "ckpt_w1")):
        model = model_from(os.path.join(spec["dir"], "w0.pt"), cfg)
        step, state = sharded_step(model, cfg, mesh)
        state, epoch = ckpt.restore_train_state(os.path.join(spec["dir"], d), 1, state)
        loss = step(batch, aux, torch.Generator().manual_seed(12))
        out[name] = dict(loss=loss.item(), params=params_of(model), epoch=epoch,
                         updates=state.step)


def case_refusals(spec, mesh, aux, out):
    """``resolve_mesh`` in this world: the default expands over it, a
    ``parallel.data`` of another size raises."""
    got = resolve_mesh(ParallelConfig())
    out["resolved"] = (got.data, got.rank)
    try:
        resolve_mesh(ParallelConfig(data=2 * mesh.data))
    except ValueError as e:
        out["refused"] = str(e)


def case_scripts(spec, mesh, aux, out):
    """``finetune.main`` and ``lora_tune.main`` on the CPU in this world,
    each rank's step losses recorded."""
    from pangu_tpu_torch.scripts import finetune, lora_tune
    from pangu_tpu_torch.train import trainer as trainer_mod

    losses = []
    init = trainer_mod.Trainer.__init__

    def recording(self, *a, **kw):
        init(self, *a, **kw)
        step = self.train_step

        def run(batch, aux, gen):
            loss = step(batch, aux, gen)
            losses.append(loss.item())
            return loss
        self.train_step = run

    trainer_mod.Trainer.__init__ = recording
    argv = ["--preset", "tiny", "--out", os.path.join(spec["dir"], "scripts"),
            *[f"--set=data.{k}={v}" for k, v in DATES.items()], "--set", "train.epochs=2",
            "--set", "train.batch_size=2"]
    out["finetune"] = dict(result=finetune.main(argv, device="cpu"), losses=list(losses))
    losses.clear()
    out["lora"] = dict(result=lora_tune.main(argv + ["--dropout", "0"], device="cpu"),
                       losses=list(losses))


def case_card(spec, mesh, aux, out):
    """The checkpoint case on the card at flagship widths, bf16 on the
    kernel route: seeded weights and a global batch of one sample a rank
    made on the card; ZeRO-2 step 1, a save of ``train_1``, step 2; the
    weights and optimizer restored from it, step 2 again. Each step's loss,
    parameter digest and launches; in a world of one, then the one-process
    step (no mesh) from the same weights, batch and drop-path draws."""
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = card.flagship().replace(parallel=ParallelConfig(data=mesh.data))
    m = cfg.model
    aux = synthetic_aux_constants(m, cfg.train, device=dev)
    with dev:
        model = PanguModel(m).to(dev)
    init_params(model, seed=0)
    w0 = {k: v.clone() for k, v in model.state_dict().items()}
    batch = shard_batch(card.seeded_batch(aux, m, dev, rows=mesh.data), mesh)
    runs = []

    def run(step, seed):
        before = card.launches()
        loss = step(batch, aux, torch.Generator(dev).manual_seed(seed)).item()
        runs.append(dict(loss=loss, params=card.digest(model), launches=card.launched(before)))

    step, state = sharded_step(model, cfg, mesh)
    run(step, 11)
    ckpt.save_train_state(os.path.join(spec["dir"], "card_ckpt"), 1, state)
    run(step, 12)
    model.load_state_dict(w0)
    step, state = sharded_step(model, cfg, mesh)
    state, epoch = ckpt.restore_train_state(os.path.join(spec["dir"], "card_ckpt"), 1, state)
    run(step, 12)
    if mesh.data == 1:
        model.load_state_dict(w0)
        with activate_mesh(None):
            run(make_train_step(model, cfg, make_optimizer(model, cfg)), 11)
    out["card"] = dict(runs=runs, epoch=epoch)


CASES = {"modes": case_modes, "jax": case_jax, "val": case_val, "ckpt": case_ckpt,
         "refusals": case_refusals, "scripts": case_scripts, "card": case_card}


def main() -> None:
    spec = json.loads(sys.argv[1])
    torch.set_num_threads(2)
    distributed_init(spec["init"], spec["world"], spec["rank"], spec["rank"],
                     spec.get("device", "cpu"))
    mesh = make_mesh(ParallelConfig(data=spec["world"]))
    cfg = pangu_tiny()
    aux = synthetic_aux_constants(cfg.model, cfg.train, device="cpu")
    out = {}
    with activate_mesh(mesh):
        for name in spec["cases"]:
            CASES[name](spec, mesh, aux, out)
    torch.save(out, os.path.join(spec["out"], f"rank{spec['rank']}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
