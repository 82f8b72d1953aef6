"""One rank of the port's pipeline jig (tests/test_torch_pipeline.py).

Run as: python tests/torch_pipeline_worker.py '<spec as JSON>'

The spec holds ``world``, ``rank``, ``init`` (a ``file://`` store), ``dir``
(the fixture's directory: the weights and the global batch the test wrote),
``out`` (where the rank saves ``rank<r>.pt``) and ``cases``: [case, mesh]
pairs run in order, ``mesh`` the ``ParallelConfig`` fields of the case's
mesh and, for a forward, ``transport`` (a dtype name); for the ``card``
case, ``micro``. Each case makes its own mesh over the same gloo world;
with ``"device": "cuda"`` in the spec an NCCL world, one card a rank, where
the ``card`` case runs. It imports nothing of jax or the JAX package.
"""

import dataclasses
import json
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_card as card  # noqa: E402
from pangu_tpu_torch import dtype_of  # noqa: E402
from pangu_tpu_torch.aux import synthetic_aux_constants  # noqa: E402
from pangu_tpu_torch.config import ParallelConfig, pangu_tiny  # noqa: E402
from pangu_tpu_torch.interop.from_jax import init_params  # noqa: E402
from pangu_tpu_torch.model import PanguModel  # noqa: E402
from pangu_tpu_torch.parallel import distributed_init, make_mesh, resolve_mesh  # noqa: E402
from pangu_tpu_torch.parallel.pipeline import MODULE_NAMES, PanguPipeline  # noqa: E402
from pangu_tpu_torch.train import Batch, make_optimizer, make_train_step  # noqa: E402

#: the microbatches of every case
MICRO = 2
#: the synthetic store's train range of the script case (4 samples at 24 h)
DATES = dict(store="synthetic", train_start="20180101", train_end="20180105",
             train_freq="24h", prefetch=0)


def config(drop_path: float = 0.0, **mesh):
    """``pangu_tiny`` (depth 1 a layer, the JAX pipeline tests' geometry), the mesh's axes."""
    return pangu_tiny(drop_path_max=drop_path).replace(parallel=ParallelConfig(**mesh))


def _load(spec, name):
    return torch.load(os.path.join(spec["dir"], name))


def _pipeline(spec, cfg, mesh, weights="w_jax.pt", **kw):
    pipe = PanguPipeline(cfg, mesh, "cpu", **kw)
    pipe.load_state_dict(_load(spec, weights))
    return pipe


def case_forward(spec, cfg, mesh, aux, transport=None):
    """The eval forward of the global batch from the JAX init's weights."""
    pipe = _pipeline(spec, cfg, mesh,
                     transport_dtype=dtype_of(transport) if transport else None)
    u, s = _load(spec, "batch.pt")[:2]
    return dict(zip(("upper", "surface"), pipe.forward(u, s, aux, MICRO)))


def case_step(spec, cfg, mesh, aux):
    """One train step from the JAX init's weights, drop path off: the loss
    on this rank, the whole model's parameters on each replica's first stage."""
    pipe = _pipeline(spec, cfg, mesh)
    step = pipe.make_train_step(make_optimizer(pipe.stage, cfg), MICRO)
    loss = step(Batch(*_load(spec, "batch.pt")), aux).item()
    return dict(loss=loss, params=pipe.state_dict())


def case_droppath(spec, cfg, mesh, aux):
    """Steps at drop path 0.2 from the seeded weights, each from a fresh
    pipeline: without a generator twice, with seeds 1 and 2; each step's
    loss and this stage's parameters."""
    cfg = config(drop_path=0.2, **axes_of(cfg))
    batch = Batch(*_load(spec, "batch.pt"))
    out = {}
    for name, seed in (("free", None), ("free_again", None), ("seed1", 1), ("seed2", 2)):
        pipe = _pipeline(spec, cfg, mesh, "w0.pt")
        step = pipe.make_train_step(make_optimizer(pipe.stage, cfg), MICRO)
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        loss = step(batch, aux, gen).item()
        out[name] = dict(loss=loss, params={k: p.detach().clone()
                                            for k, p in pipe.stage.named_parameters()})
    return out


def case_script(spec, cfg, mesh, aux):
    """``pipeline_train.main`` over this world with the mesh's pipe (3 steps
    of the default tiny preset on the synthetic store), each step's batch
    recorded by a sum of its inputs and of its targets; then the finetune
    script with the same pipe, which must refuse it."""
    from pangu_tpu_torch.scripts import finetune, pipeline_train

    seen, make = [], PanguPipeline.make_train_step

    def recording(self, *a, **kw):
        step = make(self, *a, **kw)

        def run(batch, aux, generator=None):
            seen.append(tuple(float(torch.as_tensor(x).double().abs().sum())
                              for x in (batch[0], batch[2])))
            return step(batch, aux, generator)
        return run

    out_dir = os.path.join(spec["dir"], "script")
    argv = ["--preset", "tiny", "--out", out_dir,
            *[f"--set=data.{k}={v}" for k, v in DATES.items()],
            f"--set=parallel.pipe={mesh.pipe}", "--steps", "3", "--microbatches", str(MICRO)]
    PanguPipeline.make_train_step = recording
    try:
        losses = pipeline_train.main(argv, device="cpu")
    finally:
        PanguPipeline.make_train_step = make
    try:
        finetune.main(argv[:-4], device="cpu")
        refused = ""
    except ValueError as e:
        refused = str(e)
    return dict(losses=losses, seen=seen, refused=refused, out=out_dir)


def case_groups(spec, cfg, mesh, aux):
    """The mesh's coordinates and groups (as global ranks), and what
    ``resolve_mesh`` makes of ``parallel.pipe`` alone in this world."""
    resolved = resolve_mesh(ParallelConfig(pipe=mesh.pipe))
    return dict(coords=mesh.coords, pipe_group=dist.get_process_group_ranks(mesh.pipe_group),
                data_group=dist.get_process_group_ranks(mesh.data_group),
                resolved=(resolved.data, resolved.pipe, resolved.coords))


def case_bench(spec, cfg, mesh, aux):
    """``bench_pipeline.main`` over this world: one timed step a layout."""
    from pangu_tpu_torch.scripts import bench_pipeline

    return bench_pipeline.main(["--steps", "1", "--batch", "4"], device="cpu")


def case_card(spec, cfg, mesh, aux, micro=MICRO):
    """On the card at flagship widths, bf16 on the kernel route, drop path
    off: the mesh's pipeline from seeded weights takes 3 steps of a seeded
    global batch of ``micro`` x data samples (each step's loss and
    launches, and what the stage's blocks and outsides should launch; step 1's gradients
    gathered to each replica's first stage). Rank 0 then takes the
    one-process step with ``accumulation_steps`` = ``micro`` x data on the
    same batch and weights, and compares step 1's loss and gradients with
    it (``torch_card.train_deviation``)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = card.flagship(drop_path_max=0.0).replace(parallel=cfg.parallel)
    m = cfg.model
    aux = synthetic_aux_constants(m, cfg.train, device=dev)
    whole = PanguModel(m)  # on the host
    init_params(whole, seed=0)
    pipe = PanguPipeline(cfg, mesh, dev)
    pipe.load_state_dict(whole.state_dict())
    batch = card.seeded_batch(aux, m, dev, rows=micro * mesh.data)
    step = pipe.make_train_step(make_optimizer(pipe.stage, cfg), micro)
    runs = []
    for i in range(3):
        before = card.launches()
        runs.append(dict(loss=step(batch, aux).item(), launches=card.launched(before)))
        if i == 0:
            grads = pipe.gather({k: p.grad for k, p in pipe.stage.named_parameters()})
    blocks = sum(len(pipe.stage.get_submodule(MODULE_NAMES[op]).blocks)
                 for op in pipe.stage.ops if op.startswith("layer"))
    res = dict(runs=runs, want=card.stage_launches(pipe.stage.ops, blocks, micro))
    del step, pipe
    if dist.get_rank() == 0:
        model = whole.to(dev)
        acc = micro * mesh.data
        acc_cfg = cfg.replace(train=dataclasses.replace(cfg.train, accumulation_steps=acc))
        one = make_train_step(model, acc_cfg, make_optimizer(model, acc_cfg))
        loss = one(Batch(*(t.reshape(acc, -1, *t.shape[1:]) for t in batch)), aux).item()
        named = dict(model.named_parameters())
        res["one_process"] = card.train_deviation(
            runs[0]["loss"], {k: g.to(dev) for k, g in grads.items()}, loss,
            {k: named[k].grad for k in grads})
    dist.barrier()
    return res


def axes_of(cfg) -> dict:
    p = cfg.parallel
    return dict(data=p.data, pipe=p.pipe)


CASES = {"forward": case_forward, "step": case_step, "droppath": case_droppath,
         "script": case_script, "groups": case_groups, "bench": case_bench, "card": case_card}


def key(name: str, axes: dict) -> str:
    return name + ":" + ",".join(f"{k}={v}" for k, v in sorted(axes.items()))


def main() -> None:
    spec = json.loads(sys.argv[1])
    torch.set_num_threads(2)
    distributed_init(spec["init"], spec["world"], spec["rank"], spec["rank"],
                     spec.get("device", "cpu"))
    aux = synthetic_aux_constants(config().model, config().train, device="cpu")
    out = {}
    for name, axes in spec["cases"]:
        kw = {k: axes.pop(k) for k in ("transport", "micro") if k in axes}
        cfg = config(**axes)
        mesh = make_mesh(cfg.parallel, model=cfg.model)
        out[key(name, dict(axes, **kw))] = CASES[name](spec, cfg, mesh, aux, **kw)
    torch.save(out, os.path.join(spec["out"], f"rank{spec['rank']}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
