"""The port's GPipe pipeline (``pangu_tpu_torch.parallel.pipeline``) on the CPU.

Ranks are real processes (``tests/torch_pipeline_worker.py``, which imports
nothing of jax or the JAX package) joined over gloo, spawned by
``test_torch_parallel._spawn`` (120 s a world). The module fixture runs a
world of 2 (pipe=2: forward, step, drop path, the scripts) and a world of 4
(pipe=4: forward, step, bf16 transport; data=2 x pipe=2: forward, step; the
mesh's groups; the bench script) once each, in threads while this process
computes the JAX pipeline's references, from one set of weights (the JAX
init through ``load_jax_params``) and one global batch of 4 samples, 2
microbatches, at ``pangu_tiny`` (the JAX pipeline tests' geometry).

Tolerances:

* the pipelined forward against the JAX ``PanguPipeline.make_forward`` on
  the virtual CPU mesh: atol 2e-5 (the JAX test's); against the port's
  whole model: rtol 1e-5, atol 1e-6; with bf16 transport against the JAX
  bf16 transport: 2e-2 of max|ref| (the JAX test's bound against f32);
* a train step against the JAX pipeline step: loss rtol 1e-5, every
  parameter within 5e-5 of its max|ref| (the JAX test's); against the
  port's one-process step with ``accumulation_steps`` = microbatches x data
  on the same batch: loss rtol 1e-5, parameters rtol 2e-5 / atol 1e-7
  (``tests/test_torch_parallel.py``'s); every rank the same loss;
* the in-process stage chain against the whole port model: the same bits.
"""

import dataclasses
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pangu_tpu.aux import synthetic_aux_constants as jax_aux
from pangu_tpu.config import ParallelConfig as JaxParallelConfig
from pangu_tpu.config import pangu_pretrain as jax_pretrain
from pangu_tpu.config import pangu_tiny as jax_tiny
from pangu_tpu.interop.torch_import import state_dict_from_params
from pangu_tpu.model import PanguModel as JaxPanguModel
from pangu_tpu.parallel import make_mesh as jax_make_mesh
from pangu_tpu.parallel import pipeline as jax_pipeline
from pangu_tpu.train import step as jax_step
from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.config import ParallelConfig, pangu_pretrain, pangu_tiny
from pangu_tpu_torch.interop.from_jax import init_params, load_jax_params
from pangu_tpu_torch.interop.torch_import import reference_key_map
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.parallel import make_mesh, resolve_mesh
from pangu_tpu_torch.parallel import pipeline as pp
from pangu_tpu_torch.parallel.mesh import Mesh
from pangu_tpu_torch.train import Batch, make_optimizer, make_train_step
from pangu_tpu_torch.train.step import output_loss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_pipeline_worker as worker  # noqa: E402
from test_torch_parallel import _close, _spawn  # noqa: E402

WORKER = os.path.join(REPO, "tests", "torch_pipeline_worker.py")
ROWS, MICRO = 4, worker.MICRO
PIPE2, PIPE4, DATA2_PIPE2 = dict(pipe=2), dict(pipe=4), dict(data=2, pipe=2)
#: world -> the [case, mesh] pairs its ranks run, in order
CASES = {
    2: [["forward", PIPE2], ["step", PIPE2], ["droppath", PIPE2], ["script", PIPE2]],
    4: [["forward", PIPE4], ["step", PIPE4], ["forward", dict(PIPE4, transport="bfloat16")],
        ["forward", DATA2_PIPE2], ["step", DATA2_PIPE2], ["groups", DATA2_PIPE2],
        ["bench", PIPE4]],
}
#: the step and forward cases: (world, mesh)
MESHES = [(2, PIPE2), (4, PIPE4), (4, DATA2_PIPE2)]


def _jax_references(jparams, arrays):
    """The JAX pipeline at pipe=4 on the virtual CPU mesh: the forward with
    bf16 transport and in f32, and one train step (drop path off, no ZeRO,
    as the JAX test's)."""
    jcfg = jax_tiny(drop_path_max=0.0).replace(parallel=JaxParallelConfig(
        pipe=4, zero_opt_state=False, zero_gradients=False))
    jaux = jax_aux(jcfg.model, jcfg.train)
    mesh = jax_make_mesh(jcfg.parallel)
    out = {}
    for name, dtype in (("bf16", jnp.bfloat16), ("forward", None)):  # the f32 one kept
        pipe = jax_pipeline.PanguPipeline(jcfg, mesh, jparams, transport_dtype=dtype)
        out[name] = [np.asarray(x) for x in pipe.make_forward(MICRO)(
            pipe.stack_params(jparams), arrays[0], arrays[1], jaux)]
    optimizer = jax_step.make_optimizer(jcfg)
    state, loss = pipe.make_train_step(optimizer, MICRO)(
        pipe.init_train_state(jparams, optimizer), jax_step.Batch(*arrays), jaux)
    tree = jax.tree_util.tree_map(np.asarray, pipe.unstack_params(state.params))
    out["step"] = dict(loss=float(loss), params={
        k: torch.from_numpy(v.copy()) for k, v in state_dict_from_params(jcfg.model, tree).items()})
    return out


def _one_process_step(w, batch, aux, accumulation):
    """The port's one-process step on the global batch, split into
    ``accumulation`` microbatches of consecutive rows."""
    cfg = worker.config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, accumulation_steps=accumulation))
    model = PanguModel(cfg.model)
    model.load_state_dict(w)
    acc = Batch(*(t.reshape(accumulation, -1, *t.shape[1:]) for t in batch))
    loss = make_train_step(model, cfg, make_optimizer(model, cfg))(acc, pp_aux(cfg)).item()
    return loss, {k: p.detach().clone() for k, p in model.named_parameters()}


def pp_aux(cfg):
    return synthetic_aux_constants(cfg.model, cfg.train, device="cpu")


@pytest.fixture(scope="module")
def jig(tmp_path_factory):
    """Writes the weights (the port's seeded init, and the JAX init through
    ``load_jax_params``) and a global batch; runs the world-2 and world-4
    ranks in threads while computing the JAX and one-process references."""
    d = str(tmp_path_factory.mktemp("pipeline"))
    cfg = worker.config()
    m = cfg.model
    model = PanguModel(m)
    init_params(model, seed=0)
    torch.save(model.state_dict(), os.path.join(d, "w0.pt"))
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal((ROWS,) + shape).astype(np.float32) for shape in (
        (m.upper_vars, m.levels, m.lat, m.lon), (m.surface_vars, m.lat, m.lon))]
    arrays += [a + 0.1 for a in arrays]
    jcfg = jax_tiny()
    jparams = jax.tree_util.tree_map(np.asarray, jax.jit(JaxPanguModel(jcfg.model).init)(
        jax.random.PRNGKey(0), arrays[0][:1], arrays[1][:1], jax_aux(jcfg.model, jcfg.train)))
    load_jax_params(model, m, jparams)
    w_jax = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save(w_jax, os.path.join(d, "w_jax.pt"))
    batch = Batch(*(torch.from_numpy(a) for a in arrays))
    torch.save(tuple(batch), os.path.join(d, "batch.pt"))
    with ThreadPoolExecutor(2) as pool:
        worlds = {world: pool.submit(_spawn, world, dict(dir=d, cases=cases),
                                     os.path.join(d, f"world{world}"), WORKER)
                  for world, cases in CASES.items()}
        ref = _jax_references(jparams, arrays)
        aux = pp_aux(cfg)
        model.eval()
        with torch.no_grad():
            ref["port_forward"] = model(batch.upper, batch.surface, aux)
        ref["one_process"] = {
            worker.key("step", mesh): _one_process_step(w_jax, batch, aux,
                                                         MICRO * mesh.get("data", 1))
            for _, mesh in MESHES}
        res = {world: f.result() for world, f in worlds.items()}
    return dict(dir=d, res=res, ref=ref, jparams=jparams, w0=torch.load(os.path.join(d, "w0.pt")),
                w_jax=w_jax, batch=batch, aux=aux)


def _rank_results(jig, world, name, mesh) -> list:
    return [r[worker.key(name, mesh)] for r in jig["res"][world]]


# ---- the stage tables, without processes --------------------------------------------------


@pytest.mark.parametrize("n", range(1, 9))
def test_stage_tables_and_boundary_shapes_equal_the_jax_ones(n):
    """``default_stages``, the validation and the payload shapes at every
    cut, at the tiny and the flagship geometry, equal the JAX module's."""
    assert (pp.OPS, pp.DEFAULT_STAGES, pp.NUM_STAGES, pp.STAGE_MODULES) == (
        jax_pipeline.OPS, jax_pipeline.DEFAULT_STAGES, jax_pipeline.NUM_STAGES,
        jax_pipeline.STAGE_MODULES)
    stages = pp.default_stages(n)
    assert stages == jax_pipeline.default_stages(n)
    assert pp._validate_stages(stages) == jax_pipeline._validate_stages(stages)
    for port, jcfg in ((pangu_tiny(), jax_tiny()), (pangu_pretrain(24), jax_pretrain(24))):
        for b in (1, 2):
            assert pp._payload_shapes(port.model, b, stages) == \
                jax_pipeline._payload_shapes(jcfg.model, b, stages)
    for bad in ((("layer0", "patch_embed"),) + stages[1:], stages + ((),)):
        with pytest.raises(ValueError):
            pp._validate_stages(bad)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_stage_params_split_and_merge_and_map_onto_the_jax_split(n):
    """``split_stage_params`` of the port's state dict round-trips through
    ``merge_stage_params``, each stage's keys are the keys of a
    ``PanguStage`` of its ops, and the JAX op of each key (its reference
    key map's path) is a top-level key of the JAX ``split_stage_params``'s
    stage tree."""
    cfg = pangu_tiny()
    model = PanguModel(cfg.model)
    init_params(model, seed=0)
    state = model.state_dict()
    stages = pp.default_stages(n)
    parts = pp.split_stage_params(state, stages)
    merged = pp.merge_stage_params(parts)
    assert sorted(merged) == sorted(state)
    assert all(torch.equal(merged[k], state[k]) for k in state)
    jparams = {"params": {op: {} for op in pp.OPS}}
    jax_parts = jax_pipeline.split_stage_params(jparams, stages)
    jax_op = {key: path[0] for key, path, _ in reference_key_map(cfg.model)}
    for ops, part, jpart in zip(stages, parts, jax_parts):
        assert sorted(part) == sorted(pp.PanguStage(cfg.model, ops).state_dict())
        assert {jax_op[k] for k in part} == set(jpart["params"]) == set(ops)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_in_process_stage_chain_equals_the_whole_model(n):
    """The stages of an n-way split, each fed the previous one's outputs
    through ``stage_forward`` / ``stage_backward``: the eval forward and,
    in training, the loss and every parameter gradient give the whole
    model's bits (at n = 4 and 8 the skip crosses 2 and 5 cuts)."""
    cfg = worker.config()
    m = cfg.model
    model = PanguModel(m)
    init_params(model, seed=0)
    aux = pp_aux(cfg)
    rng = np.random.default_rng(5)
    u, s = (torch.from_numpy(rng.standard_normal((2,) + shape).astype(np.float32)) for shape in (
        (m.upper_vars, m.levels, m.lat, m.lon), (m.surface_vars, m.lat, m.lon)))
    stages = [pp.PanguStage(m, ops) for ops in pp.default_stages(n)]
    for stage, part in zip(stages, pp.split_stage_params(model.state_dict(),
                                                         pp.default_stages(n))):
        stage.load_state_dict(part)
    model.eval()
    payload = (u, s)
    with torch.no_grad():
        ref = model(u, s, aux)
        for stage in stages:
            payload = pp.stage_forward(stage.eval(), payload, aux, grad=False).outputs
    assert all(torch.equal(a, b) for a, b in zip(payload, ref))

    model.train()
    loss = output_loss(*model(u, s, aux), u + 0.1, s + 0.1, aux, cfg)
    loss.backward()
    runs, payload = [], (u, s)
    for stage in stages:
        runs.append(pp.stage_forward(stage.train(), payload, aux))
        payload = runs[-1].outputs
    got = output_loss(*payload, u + 0.1, s + 0.1, aux, cfg)
    runs[-1] = runs[-1]._replace(outputs=(got,))
    grads = None
    for run in reversed(runs):
        grads = pp.stage_backward(run, grads)
    assert got.item() == loss.item() and grads == ()
    named = {k: p for stage in stages for k, p in stage.named_parameters()}
    assert sorted(named) == sorted(dict(model.named_parameters()))
    for k, p in model.named_parameters():
        assert torch.equal(named[k].grad, p.grad), k


# ---- the mesh and the refusals ------------------------------------------------------------


def test_mesh_coordinates_are_row_major_over_data_pipe_lat_lon():
    """A data=2 x pipe=4 mesh: the rank's (data, pipe, lat, lon) as the JAX
    ``make_mesh`` reshapes its devices; the data coordinate (drop path's
    rows, the loaders' shard) is the replica, not the stage."""
    coords = []
    for rank in range(8):
        mesh = Mesh(None, 2, rank, pipe=4)
        coords.append(mesh.coords)
        assert mesh.global_rank(*mesh.coords) == rank and mesh.size == 8
        assert mesh.data_rank == rank // 4
    assert coords == [(d, p, 0, 0) for d in range(2) for p in range(4)]


@pytest.mark.parametrize("case", ["pipe_with_plane", "pipe_not_stages", "batch"])
def test_the_pipeline_refuses_what_the_jax_pipeline_refuses(case):
    """A pipe axis with lat or lon > 1 (in ``make_mesh``, before it looks for
    a process group, and in the pipeline), a pipe axis that is not the
    stage count, and a global batch that microbatches x data does not
    divide: ValueError, before any collective."""
    cfg = worker.config()
    if case == "pipe_with_plane":
        with pytest.raises(ValueError, match="does not compose with spatial"):
            make_mesh(ParallelConfig(pipe=2, lat=2), model=cfg.model)
        with pytest.raises(ValueError, match="does not compose with spatial"):
            pp.PanguPipeline(cfg, Mesh(None, 1, 0, lat=2, pipe=2), "cpu")
    elif case == "pipe_not_stages":
        with pytest.raises(ValueError, match="'pipe' mesh axis of size 4"):
            pp.PanguPipeline(cfg, Mesh(None, 1, 0, pipe=2), "cpu", stages=pp.DEFAULT_STAGES)
    else:
        pipe = pp.PanguPipeline(cfg, Mesh(None, 2, 0, pipe=2), "cpu")
        step = pipe.make_train_step(make_optimizer(pipe.stage, cfg), 2)
        batch = Batch(*(torch.zeros((6, 1)) for _ in range(4)))
        with pytest.raises(ValueError, match="batch 6 not divisible by microbatches 2 x data"):
            step(batch, pp_aux(cfg))


def test_resolve_mesh_counts_the_pipe_axis_and_its_groups(jig):
    """One process: any pipe axis raises the "one process per card" error,
    with lat too. A world of 4 at data=2 x pipe=2: the pipe group of a rank
    is its replica's consecutive ranks, its data group the same stage of
    each replica; ``resolve_mesh`` expands data 1 to world / pipe."""
    for cfg in (ParallelConfig(pipe=2), ParallelConfig(pipe=2, lat=2)):
        with pytest.raises(ValueError, match="one process per card"):
            resolve_mesh(cfg)
    for rank, r in enumerate(_rank_results(jig, 4, "groups", DATA2_PIPE2)):
        d, p = divmod(rank, 2)
        assert r["coords"] == (d, p, 0, 0)
        assert r["pipe_group"] == [2 * d, 2 * d + 1] and r["data_group"] == [p, 2 + p]
        assert r["resolved"] == (2, 2, (d, p, 0, 0))


# ---- the gloo worlds ----------------------------------------------------------------------


@pytest.mark.parametrize("world,mesh", MESHES)
def test_pipelined_forward_matches_the_whole_model(jig, world, mesh):
    """Every rank returns the whole batch's f32 outputs, the port model's."""
    for r in _rank_results(jig, world, "forward", mesh):
        for got, ref in zip((r["upper"], r["surface"]), jig["ref"]["port_forward"]):
            assert got.dtype == torch.float32
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


def test_pipelined_forward_matches_the_jax_pipeline(jig):
    for r in _rank_results(jig, 4, "forward", PIPE4):
        for got, ref in zip((r["upper"], r["surface"]), jig["ref"]["forward"]):
            np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_bf16_transport_matches_the_jax_bf16_transport(jig):
    """Payloads in bf16 between stages (inputs and outputs stay f32): within
    2e-2 of max|ref| of the JAX pipeline's bf16 transport, and not the f32
    transport's bits."""
    for r in _rank_results(jig, 4, "forward", dict(PIPE4, transport="bfloat16")):
        for got, ref, f32 in zip((r["upper"], r["surface"]), jig["ref"]["bf16"],
                                 jig["ref"]["port_forward"]):
            assert got.dtype == torch.float32 and not torch.equal(got, f32)
            assert np.abs(got.numpy() - ref).max() / (np.abs(ref).max() + 1e-9) < 2e-2


@pytest.mark.parametrize("world,mesh", MESHES)
def test_pipeline_step_matches_the_one_process_accumulation_step(jig, world, mesh):
    """One train step: every rank the same loss, and the loss and the
    gathered parameters the port's one-process step's with
    ``accumulation_steps`` = microbatches x data."""
    res = _rank_results(jig, world, "step", mesh)
    loss, params = jig["ref"]["one_process"][worker.key("step", mesh)]
    assert len({r["loss"] for r in res}) == 1
    assert res[0]["loss"] == pytest.approx(loss, rel=1e-5)
    _close(res[0]["params"], params)
    stages = mesh["pipe"]
    for rank, r in enumerate(res):  # the whole model on each replica's first stage
        assert (r["params"] is None) == bool(rank % stages)


def test_pipeline_step_matches_the_jax_pipeline_step(jig):
    """pipe=4 against the JAX pipeline step: the loss (rtol 1e-5) and every
    updated parameter within 5e-5 of its max|ref| (the JAX test's bounds)."""
    res = _rank_results(jig, 4, "step", PIPE4)
    ref = jig["ref"]["step"]
    assert res[0]["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    got = res[0]["params"]
    assert sorted(got) == sorted(k for k in ref["params"] if k in got)
    assert len(got) == len(dict(PanguModel(worker.config().model).named_parameters()))
    for k, v in got.items():
        r = ref["params"][k]
        assert float((v - r).abs().max()) <= 5e-5 * float(r.abs().max()), k


def test_drop_path_streams_repeat_without_a_generator_and_differ_by_seed(jig):
    """At drop path 0.2: two steps without a generator give the same bits
    (drop path off, as the JAX step without an rng), seeds 1 and 2 give
    different parameters, and both differ from the generator-free step."""
    for r in _rank_results(jig, 2, "droppath", PIPE2):

        def same(a, b):
            return all(torch.equal(r[a]["params"][k], r[b]["params"][k]) for k in r[a]["params"])

        assert same("free", "free_again") and r["free"]["loss"] == r["free_again"]["loss"]
        assert not same("seed1", "seed2") and not same("free", "seed1")
        assert not same("free", "seed2")
        assert len({r[k]["loss"] for k in ("free", "seed1", "seed2")}) == 3


def test_pipeline_train_script_at_world_2(jig):
    """``pipeline_train`` over two processes: the same finite losses on both
    ranks, the JAX script's log lines on rank 0, stage 0 and the last stage
    loading the same samples each step (inputs and targets); the finetune
    script refuses the pipe axis in a world, naming ``pipeline_train``."""
    first, last = _rank_results(jig, 2, "script", PIPE2)
    assert first["losses"] == last["losses"] and len(first["losses"]) == 3
    assert all(np.isfinite(first["losses"]))
    assert first["seen"] == last["seen"] and len(set(first["seen"])) == 3
    for r in (first, last):
        assert "pangu_tpu_torch.scripts.pipeline_train" in r["refused"]
    with open(os.path.join(first["out"], "pipeline_train", "24", "pipeline.log")) as f:
        log = f.read()
    assert all(f"step {i}: loss {first['losses'][i]:.6f}" in log for i in range(3))
    assert "done: 3 steps, 1,209,984 params, mesh {'data': 1, 'pipe': 2" in log


def test_bench_pipeline_prints_the_jax_scripts_keys(jig):
    out = _rank_results(jig, 4, "bench", PIPE4)[0]
    assert sorted(out) == ["global_batch", "gpipe_bubble_fraction", "note",
                           "relative_to_dp4", "seconds_per_step", "steps"]
    assert sorted(out["seconds_per_step"]) == ["dp1_sp4", "dp4", "pp4_dp1_m2"]
    assert out["relative_to_dp4"]["dp4"] == 1.0 and out["gpipe_bubble_fraction"] == 0.6
    assert "gloo" in out["note"]
