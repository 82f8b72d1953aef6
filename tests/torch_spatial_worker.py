"""One rank of the port's spatial-sharding jig (tests/test_torch_spatial.py).

Run as: python tests/torch_spatial_worker.py '<spec as JSON>'

The spec holds ``world``, ``rank``, ``init`` (a ``file://`` store), ``dir``
(the fixture's directory: the weights, the global batch and the world-1
checkpoint the test wrote), ``out`` (where the rank saves ``rank<r>.pt``)
and ``cases``: [case, mesh] pairs run in order, ``mesh`` the
``ParallelConfig`` fields of the case's mesh (each case makes its own over
the same gloo world; with ``"device": "cuda"`` in the spec an NCCL world,
one card a rank, where the ``card`` case runs). It imports nothing of jax
or the JAX package.
"""

import dataclasses
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
                                      shard_batch, zero_shard_opt_state)
from pangu_tpu_torch.parallel import spatial  # noqa: E402
from pangu_tpu_torch.train import Batch, make_eval_step, make_optimizer, make_train_step  # noqa
from pangu_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from pangu_tpu_torch.train.step import TrainState  # noqa: E402
from pangu_tpu_torch.train.trainer import sharded_val_stats  # noqa: E402

#: the synthetic store's ranges of the validation case and the script cases
DATES = dict(store="synthetic", train_start="20180101", train_end="20180104", train_freq="24h",
             val_start="20180105", val_end="20180109", val_freq="24h",
             test_start="20180108", test_end="20180110", test_freq="24h", prefetch=0)
#: the card case's validation range (1 sample at 24 h)
CARD_VAL = dict(store="synthetic", val_start="20240105", val_end="20240107", val_freq="24h")
#: the halo case's grid: 3 x 3 windows of (2, 6, 12), uneven over 2 ranks on both axes
HALO_GRID, HALO_WINDOW = (1, 4, 18, 36, 3), (2, 6, 12)


def config(drop_path: float = 0.2, remat: bool = False, **mesh):
    """``pangu_tiny`` at lon 192 and depth 2 a layer (outer 3 x 4 windows,
    inner 2 x 2; the odd blocks shifted), ZeRO-2, the mesh's axes."""
    cfg = pangu_tiny(lon=192, depths=(2, 2, 2, 2), drop_path_max=drop_path, remat=remat)
    return cfg.replace(parallel=ParallelConfig(**mesh))


def params_of(model) -> dict:
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def model_from(path: str, cfg):
    model = PanguModel(cfg.model)
    model.load_state_dict(torch.load(path))
    return model


def _batch(spec, mesh):
    return shard_batch(Batch(*torch.load(os.path.join(spec["dir"], "batch.pt"))), mesh)


def _step(model, cfg, mesh):
    opt = zero_shard_opt_state(make_optimizer(model, cfg), mesh, cfg.parallel.zero_opt_state)
    return make_train_step(model, cfg, opt), TrainState(dict(model.named_parameters()), opt)


def case_step(spec, cfg, mesh, aux):
    """One ZeRO-2 step from the seeded weights, drop path on, the block
    inputs recorded; the remat and data=2 variants are the mesh's."""
    model = model_from(os.path.join(spec["dir"], "w0.pt"), cfg)
    step, _ = _step(model, cfg, mesh)
    with spatial.record_shardings() as log:
        loss = step(_batch(spec, mesh), aux, torch.Generator().manual_seed(5))
    return dict(loss=loss.item(), params=params_of(model), log=log)


def case_jax(spec, cfg, mesh, aux):
    """The step from the JAX package's initial weights, drop path off."""
    cfg = config(drop_path=0.0, **spec_mesh(cfg))
    model = model_from(os.path.join(spec["dir"], "w_jax.pt"), cfg)
    step, _ = _step(model, cfg, mesh)
    return dict(loss=step(_batch(spec, mesh), aux).item(), params=params_of(model))


def case_val(spec, cfg, mesh, aux):
    """Lockstep validation over the data coordinate's shard of 3 samples,
    and one eval step on the fixture's batch."""
    cfg = config(drop_path=0.0, **spec_mesh(cfg)).replace(data=DataConfig(**DATES))
    model = model_from(os.path.join(spec["dir"], "w0.pt"), cfg)
    val = make_loader(cfg.data, cfg.model, "val", cfg.horizon, 1, num_shards=mesh.data,
                      shard=mesh.data_rank)
    stats = sharded_val_stats(make_eval_step(model, cfg), val, aux, torch.device("cpu"),
                              count=mesh.data)
    return dict(stats=stats, loss=make_eval_step(model, cfg)(_batch(spec, mesh), aux).item())


def case_k1(spec, cfg, mesh, aux):
    """A forecast step on K1's route (bf16, ``use_pallas_attention``; the
    plain version on the CPU) on the rank's slabs, then with no mesh on the
    whole grid: the output, the shift, the real rows and the rows of each
    operator call, and the launches that folded them."""
    from pangu_tpu_torch.ops import fused_block_attention as fba
    from pangu_tpu_torch.rollout import make_forecast_step

    cfg = config(drop_path=0.0, **spec_mesh(cfg))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16",
                                                use_pallas_attention=True))
    model = model_from(os.path.join(spec["dir"], "w0.pt"), cfg)
    upper, surface = torch.load(os.path.join(spec["dir"], "batch.pt"))[:2]
    op, calls = fba.FUSED_EARTH_BLOCK_OP, []

    def spy(*args):
        calls.append((list(args[-2]), args[-1], args[0].shape[2]))
        return op(*args)

    res, folded = {}, fba.FOLDED_LAUNCHES
    fba.FUSED_EARTH_BLOCK_OP = spy
    try:
        for name, m in (("slab", mesh), ("whole", None)):
            with activate_mesh(m):
                out = make_forecast_step(model, aux)(upper[:1], surface[:1])
            res[name] = dict(out=out, calls=list(calls))
            calls.clear()
    finally:
        fba.FUSED_EARTH_BLOCK_OP = op
    res["folded"] = fba.FOLDED_LAUNCHES - folded
    return res


def case_ckpt(spec, cfg, mesh, aux):
    """Step 1, a save of ``train_1`` from every rank, step 2; then a fresh
    model and optimizer restored from that checkpoint and from the world-1
    checkpoint the test wrote, each taking step 2."""
    batch = _batch(spec, mesh)
    model = model_from(os.path.join(spec["dir"], "w0.pt"), cfg)
    step, state = _step(model, cfg, mesh)
    step(batch, aux, torch.Generator().manual_seed(11))
    ckpt.save_train_state(os.path.join(spec["dir"], "ckpt"), 1, state)
    res = dict(step1=params_of(model))
    loss = step(batch, aux, torch.Generator().manual_seed(12))
    res["uninterrupted"] = dict(loss=loss.item(), params=params_of(model))
    for name, d in (("resumed", "ckpt"), ("from_world1", "ckpt_w1")):
        model = model_from(os.path.join(spec["dir"], "w0.pt"), cfg)
        step, state = _step(model, cfg, mesh)
        state, epoch = ckpt.restore_train_state(os.path.join(spec["dir"], d), 1, state)
        loss = step(batch, aux, torch.Generator().manual_seed(12))
        res[name] = dict(loss=loss.item(), params=params_of(model), epoch=epoch,
                         updates=state.step)
    return res


def lora_steps(model, cfg, aux, batch, steps: int = 2) -> dict:
    """Two unmerged LoRA steps (rank 4, adapter dropout 0) from the model's
    weights, the adapters on every linear, the heads trained fully (plain
    Adam: the adapters train replicated); returns the flattened tree."""
    from pangu_tpu_torch.train.lora import (LoraConfig, flatten_trainable, init_lora_params,
                                            make_lora_train_step)

    lcfg = LoraConfig(rank=4, alpha=4.0, dropout=0.0)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    tree = init_lora_params(base, lcfg, torch.Generator().manual_seed(7))
    opt = make_optimizer(flatten_trainable(tree).values(), cfg)
    step = make_lora_train_step(model, cfg, opt, base, lcfg, tree, unmerged=True)
    losses = [step(batch, aux, torch.Generator().manual_seed(20 + i)).item()
              for i in range(steps)]
    return dict(losses=losses, tree={k: t.detach().clone()
                                     for k, t in flatten_trainable(tree).items()})


def case_lora(spec, cfg, mesh, aux):
    """``lora_steps`` under the mesh: the adapters of the layers' linears
    are summed over the plane, the joints' adapters and the heads are not."""
    return lora_steps(model_from(os.path.join(spec["dir"], "w0.pt"), cfg), cfg, aux,
                      _batch(spec, mesh))


def case_halo(spec, cfg, mesh, aux):
    """``spatial.roll`` by the shifted block's -window//2 and back on the
    rank's slab of a seeded grid of uneven slabs, gathered, against
    ``torch.roll`` of the whole grid; the backward (a seeded upstream
    gradient) against the roll of the upstream gradient. Bit for bit."""
    from pangu_tpu_torch.geometry import StageGeometry

    b, z, hp, w, c = HALO_GRID
    wz, wh, ww = HALO_WINDOW
    stage = StageGeometry(z=z, h=hp, w=w, h_pad=hp, n_lon_windows=w // ww,
                          n_type_windows=(z // wz) * (hp // wh), window=HALO_WINDOW)
    slab = spatial.slab_of(stage, mesh)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(HALO_GRID, generator=gen)
    gy = torch.randn(HALO_GRID, generator=gen)
    res = {}
    for sign in (-1, 1):
        shifts = [sign * (k // 2) for k in HALO_WINDOW]
        xs = spatial.scatter(x.clone().requires_grad_(True), slab)
        xs.retain_grad()
        y = spatial.roll(xs, shifts, slab)
        (y * spatial.scatter(gy, slab)).sum().backward()
        whole = spatial.gather(y.detach(), slab)
        ref = torch.roll(x, shifts, dims=(1, 2, 3))
        gref = torch.roll(gy, [-s for s in shifts], dims=(1, 2, 3))
        (r0, r1), (c0, c1) = slab.rows, slab.cols
        res[sign] = dict(forward=torch.equal(whole, ref),
                         backward=torch.equal(xs.grad, gref[:, :, r0:r1, c0:c1]),
                         slab=tuple(xs.shape))
    return res


def case_scripts(spec, cfg, mesh, aux):
    """``finetune.main`` and ``lora_tune.main`` on the CPU in this world with
    the mesh's lat/lon overrides (the default tiny preset), each rank's step
    losses recorded. Run with no mesh active: each script makes its own, and
    rank 0 scores the test range alone after leaving it."""
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
    try:
        argv = ["--preset", "tiny", "--out", os.path.join(spec["dir"], "scripts"),
                *[f"--set=data.{k}={v}" for k, v in DATES.items()], "--set", "train.epochs=2",
                "--set", "train.batch_size=1",
                *[f"--set=parallel.{k}={v}" for k, v in spec_mesh(cfg).items()]]
        res = dict(finetune=dict(result=finetune.main(argv, device="cpu"), losses=list(losses)))
        losses.clear()
        res["lora"] = dict(result=lora_tune.main(argv + ["--dropout", "0"], device="cpu"),
                           losses=list(losses))
    finally:
        trainer_mod.Trainer.__init__ = init
    return res


def case_card(spec, cfg, mesh, aux):
    """On the card at flagship widths, bf16 on the kernel route: 3 ZeRO-2
    steps of one seeded sample on the rank's slabs from seeded weights and
    drop-path draws (each step's loss, parameter digest and launches), then
    one validation pass over a 1-sample range (its value and launches). Rank
    0 then takes the one-process step (no mesh) from the same weights, batch
    and draws, and compares the first mesh step's loss and gradients with
    it (``torch_card.train_deviation``)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = card.flagship().replace(parallel=cfg.parallel, data=DataConfig(**CARD_VAL))
    m = cfg.model
    aux = synthetic_aux_constants(m, cfg.train, device=dev)
    with dev:
        model = PanguModel(m).to(dev)
    init_params(model, seed=0)
    batch = card.seeded_batch(aux, m, dev)
    step, _ = _step(model, cfg, mesh)
    runs = []
    for i in range(3):
        before = card.launches()
        loss = step(batch, aux, torch.Generator(dev).manual_seed(3 + i)).item()
        runs.append(dict(loss=loss, params=card.digest(model), launches=card.launched(before)))
        if i == 0:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    before = card.launches()
    val = make_loader(cfg.data, m, "val", cfg.horizon, 1)
    res = dict(runs=runs, val=sharded_val_stats(make_eval_step(model, cfg), val, aux, dev),
               val_launches=card.launched(before))
    if mesh.rank == 0:
        init_params(model, seed=0)
        model.zero_grad(set_to_none=True)
        with activate_mesh(None):
            one = make_train_step(model, cfg, make_optimizer(model, cfg))
            loss = one(batch, aux, torch.Generator(dev).manual_seed(3)).item()
        named = dict(model.named_parameters())
        res["one_process"] = card.train_deviation(runs[0]["loss"], grads, loss,
                                                  {k: named[k].grad for k in grads})
    torch.distributed.barrier()
    return res


def spec_mesh(cfg) -> dict:
    p = cfg.parallel
    return dict(data=p.data, lat=p.lat, lon=p.lon)


CASES = {"step": case_step, "jax": case_jax, "val": case_val, "ckpt": case_ckpt,
         "halo": case_halo, "lora": case_lora, "scripts": case_scripts, "k1": case_k1,
         "card": case_card}


def main() -> None:
    spec = json.loads(sys.argv[1])
    torch.set_num_threads(2)
    distributed_init(spec["init"], spec["world"], spec["rank"], spec["rank"],
                     spec.get("device", "cpu"))
    aux = synthetic_aux_constants(config().model, config().train, device="cpu")
    out = {}
    for name, axes in spec["cases"]:
        remat = axes.pop("remat", False)
        cfg = config(remat=remat, **axes)
        mesh = make_mesh(cfg.parallel, model=cfg.model)
        key = name + ":" + ",".join(f"{k}={v}" for k, v in sorted(axes.items())) + \
            (",remat" if remat else "")
        with activate_mesh(None if name == "scripts" else mesh):
            out[key] = CASES[name](spec, cfg, mesh, aux)
    torch.save(out, os.path.join(spec["out"], f"rank{spec['rank']}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
