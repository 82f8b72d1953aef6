"""The port's data parallelism (``pangu_tpu_torch.parallel``) on the CPU
(the lat x lon axes: ``tests/test_torch_spatial.py``).

Ranks are real processes (``tests/torch_parallel_worker.py``, which imports
nothing of jax or the JAX package) joined over gloo through a ``file://``
store in the test's temporary directory; each spawn is bounded at 120 s and
a failed rank's stderr fails the test. The module fixture runs a world of 2
and a world of 4 once, from one set of seeded weights and one global batch
of 4 samples (2 rows a rank, then 1).

Tolerances:

* a mesh step (ZeRO-2, ZeRO-1, plain DP; drop path on) against the port's
  one-process step on the same global batch: loss rtol 1e-5, updated
  parameters rtol 2e-5 / atol 1e-7, the bounds of
  ``tests/test_sharding.py:227-266``; the three modes against each other
  the same; every rank of a world the same bits;
* the world-2 ZeRO-2 step against the JAX package's ``make_mesh(data=2)``
  step on its virtual CPU devices (same weights via ``load_jax_params``,
  drop path off): loss and every parameter within 1e-4 relative, the golden
  bound;
* ``sharded_val_stats(count=2)``: the same value on both ranks, and rtol
  1e-6 against the JAX lockstep value (the eval step over each global
  batch);
* a world of one (in this process) and a resume: the same bits.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from pangu_tpu.aux import synthetic_aux_constants as jax_aux
from pangu_tpu.config import ParallelConfig as JaxParallelConfig
from pangu_tpu.config import pangu_pretrain as jax_pretrain
from pangu_tpu.config import pangu_tiny as jax_tiny
from pangu_tpu.interop import torch_import as jax_torch_import
from pangu_tpu.interop.torch_import import state_dict_from_params
from pangu_tpu.model import PanguModel as JaxPanguModel
from pangu_tpu.parallel import activate_mesh as jax_activate_mesh
from pangu_tpu.parallel import make_mesh as jax_make_mesh
from pangu_tpu.parallel import sharding as jax_sharding
from pangu_tpu.train import step as jax_step
from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.config import DataConfig, ParallelConfig, pangu_pretrain, pangu_tiny
from pangu_tpu_torch.data import make_loader
from pangu_tpu_torch.interop.from_jax import init_params, load_jax_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.model.attention import ATTENTION_SITES, train_seeds
from pangu_tpu_torch.model.blocks import drop_path_scale
from pangu_tpu_torch.parallel import (activate_mesh, distributed_init, make_mesh, resolve_mesh,
                                      zero_bytes_per_device, zero_shard_opt_state)
from pangu_tpu_torch.parallel.mesh import Mesh
from pangu_tpu_torch.parallel.sharding import ShardedOptimizer, _zero_spec
from pangu_tpu_torch.train import Batch, make_optimizer, make_train_step
from pangu_tpu_torch.train import checkpoint as ckpt
from pangu_tpu_torch.train.step import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_card as card  # noqa: E402
import torch_parallel_worker as worker  # noqa: E402

TIMEOUT_S = 120
ROWS = 4  # the global batch: 2 rows a rank at world 2, 1 at world 4
MODES = list(worker.MODES)


def _spawn(world: int, spec: dict, out: str, worker: str = WORKER) -> list:
    """Run ``world`` ranks of ``worker``; return each rank's saved results.
    The ranks get 120 s together; on a failure or a timeout every rank is
    killed and the test fails with the failed rank's stderr."""
    return card.spawn(world, spec, out, worker, TIMEOUT_S)


def _fields(rng, m, rows):
    return [rng.standard_normal((rows,) + shape).astype(np.float32) for shape in (
        (m.upper_vars, m.levels, m.lat, m.lon), (m.surface_vars, m.lat, m.lon),
        (m.upper_vars, m.levels, m.lat, m.lon), (m.surface_vars, m.lat, m.lon))]


def _one_process_step(w0, batch, aux, seed, cfg=None):
    """The port's one-process step (no mesh): (loss, parameters, model, state)."""
    cfg = cfg or worker.config()
    model = PanguModel(cfg.model)
    model.load_state_dict(w0)
    opt = make_optimizer(model, cfg)
    loss = make_train_step(model, cfg, opt)(batch, aux, torch.Generator().manual_seed(seed))
    return float(loss), worker.params_of(model), model, TrainState(
        dict(model.named_parameters()), opt)


@pytest.fixture(scope="module")
def jig(tmp_path_factory):
    """Writes the weights (the port's seeded init, and the JAX init through
    ``load_jax_params``), a global batch and a world-1 checkpoint; runs the
    world-2 and world-4 ranks; computes the one-process references."""
    d = str(tmp_path_factory.mktemp("parallel"))
    cfg = worker.config()
    m = cfg.model
    model = PanguModel(m)
    init_params(model, seed=0)
    w0 = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save(w0, os.path.join(d, "w0.pt"))
    jcfg = jax_tiny(drop_path_max=0.0)
    arrays = _fields(np.random.default_rng(23), m, ROWS)
    jaux = jax_aux(jcfg.model, jcfg.train)
    jmodel = JaxPanguModel(jcfg.model)
    jparams = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), arrays[0][:1], arrays[1][:1], jaux))
    load_jax_params(model, m, jparams)
    w_jax = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save(w_jax, os.path.join(d, "w_jax.pt"))
    batch = Batch(*(torch.from_numpy(a) for a in arrays))
    torch.save(tuple(batch), os.path.join(d, "batch.pt"))
    aux = synthetic_aux_constants(m, cfg.train, device="cpu")

    # the world-1 run of the checkpoint case: step 1, save, step 2
    _, _, model1, state1 = _one_process_step(w0, batch, aux, 11)
    ckpt.save_train_state(os.path.join(d, "ckpt_w1"), 1, state1)
    step = make_train_step(model1, cfg, state1.opt_state)
    loss2 = float(step(batch, aux, torch.Generator().manual_seed(12)))

    res = {2: _spawn(2, dict(dir=d, cases=["modes", "jax", "val", "ckpt", "refusals",
                                           "scripts"]), os.path.join(d, "world2")),
           4: _spawn(4, dict(dir=d, cases=["modes"]), os.path.join(d, "world4"))}
    one = {mode: _one_process_step(w0, batch, aux, 5, worker.config(mode))[:2] for mode in MODES}
    return dict(dir=d, res=res, one=one, w0=w0, w_jax=w_jax, arrays=arrays, batch=batch,
                aux=aux, jparams=jparams, jcfg=jcfg, jaux=jaux, jmodel=jmodel,
                world1_step2=(loss2, worker.params_of(model1)))


def _close(got: dict, ref: dict, rtol=2e-5, atol=1e-7):
    assert sorted(got) == sorted(ref)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=rtol, atol=atol, msg=k)


def _same_bits(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---- the rule and its bytes ------------------------------------------------------------


#: the JAX param tree's layout of each reference key's transform: the JAX dim of
#: each torch dim (None: a dim the transform drops)
_DIM_MAPS = {jax_torch_import._t_linear: lambda nd: [1, 0],
             jax_torch_import._t_conv1d: lambda nd: [1, 0, None],
             jax_torch_import._t_copy: lambda nd: list(range(nd)),
             jax_torch_import._t_bias_squeeze: lambda nd: [None] + list(range(nd - 1))}


@pytest.mark.parametrize("data", [2, 4, 8])
@pytest.mark.parametrize("preset", ["tiny", "flagship"])
def test_zero_spec_picks_the_jax_dim_and_bytes(preset, data):
    """For every leaf the port's ``_zero_spec`` (torch layout, meta tensors
    at flagship) shards the extent the JAX rule shards on the JAX tree's
    shape (``jax.eval_shape`` of the init), and the same dim where that
    extent is unique; ties between equal extents fall to the first dim of
    each layout (the other axis of a transposed square weight, the same
    bytes). ``zero_bytes_per_device`` equals the JAX function's to the
    byte, sharded and replicated."""
    jcfg = jax_tiny() if preset == "tiny" else jax_pretrain(24)
    cfg = pangu_tiny() if preset == "tiny" else pangu_pretrain(24)
    m = jcfg.model
    jaux = jax_aux(m, jcfg.train)
    u = jax.ShapeDtypeStruct((1, m.upper_vars, m.levels, m.lat, m.lon), jnp.float32)
    s = jax.ShapeDtypeStruct((1, m.surface_vars, m.lat, m.lon), jnp.float32)
    shapes = jax.eval_shape(JaxPanguModel(m).init, jax.random.PRNGKey(0), u, s, jaux)
    with torch.device("meta"):
        named = dict(PanguModel(cfg.model).named_parameters())
    keys = jax_torch_import.reference_key_map(m)
    assert sorted(k for k, _, _ in keys) == sorted(named)
    for key, path, tr in keys:
        node = shapes["params"]
        for p in path:
            node = node[p]
        jshape, tshape = tuple(node.shape), tuple(named[key].shape)
        jspec = jax_sharding._zero_spec(jshape, data)
        jdim = list(jspec).index("data") if "data" in tuple(jspec) else None
        dim = _zero_spec(tshape, data)
        assert (dim is None) == (jdim is None), key
        if dim is not None:
            assert tshape[dim] == jshape[jdim], key
            if jshape.count(jshape[jdim]) == 1:
                assert _DIM_MAPS[tr](len(tshape))[dim] == jdim, key
    mesh = jax_make_mesh(JaxParallelConfig(data=data))
    for enable in (True, False):
        assert zero_bytes_per_device(named, Mesh(None, data, 0), enable) == \
            jax_sharding.zero_bytes_per_device(shapes, mesh, enable)


# ---- the mesh step against one process, and the modes ------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", [2, 4])
def test_mesh_step_matches_the_one_process_step(jig, world, mode):
    """One step of each mode in a world of 2 and of 4 (drop path on: the
    ranks keep their rows of the global draw) against the one-process step
    on the same global batch and generator; every rank the same bits."""
    ranks = jig["res"][world]
    loss, params = jig["one"][mode]
    for r in ranks[1:]:
        assert r[mode]["loss"] == ranks[0][mode]["loss"]
        _same_bits(r[mode]["params"], ranks[0][mode]["params"])
    assert ranks[0][mode]["loss"] == pytest.approx(loss, rel=1e-5)
    _close(ranks[0][mode]["params"], params)
    assert any(not torch.equal(params[k], jig["w0"][k]) for k in params)


@pytest.mark.parametrize("world", [2, 4])
def test_the_three_modes_agree(jig, world):
    r = jig["res"][world][0]
    for mode in ("zero1", "dp"):
        assert r[mode]["loss"] == pytest.approx(r["zero2"]["loss"], rel=1e-5)
        _close(r[mode]["params"], r["zero2"]["params"])


def test_world2_step_matches_the_jax_mesh_step(jig):
    """The JAX package's ZeRO-2 step on ``make_mesh(ParallelConfig(data=2))``
    over its virtual CPU devices, the same weights and global batch, drop
    path off, against the port's world-2 step."""
    cfg, jmodel = jig["jcfg"], jig["jmodel"]
    opt = jax_step.make_optimizer(cfg)
    mesh = jax_make_mesh(JaxParallelConfig(data=2))
    params = jig["jparams"]
    with jax_activate_mesh(mesh):
        state = jax_step.TrainState(jax_sharding.shard_params(params, mesh),
                                    jax_sharding.zero_shard_opt_state(opt.init(params), mesh),
                                    jnp.zeros((), jnp.int32))
        batch = jax_sharding.shard_batch(jax_step.Batch(*jig["arrays"]), mesh)
        state, loss = jax.jit(jax_step.make_train_step(jmodel, cfg, opt))(
            state, batch, jig["jaux"], jax.random.PRNGKey(3))
    ref = state_dict_from_params(cfg.model, jax.tree_util.tree_map(np.asarray, state.params))
    got = jig["res"][2][0]["jax"]
    assert abs(got["loss"] - float(loss)) / abs(float(loss)) < 1e-4
    assert sorted(got["params"]) == sorted(ref)
    for k, v in ref.items():
        assert _rel(got["params"][k].numpy(), v) < 1e-4, k


def test_sharded_val_stats_match_on_ranks_and_the_jax_lockstep_value(jig):
    """Each rank scores its wrap-padded shard of 3 samples (2 batches a
    rank) and averages each batch's loss over the ranks: both ranks hold the
    same sums, equal to the JAX eval step over each global batch (the two
    ranks' samples in rank order), as the JAX lockstep launch scores them."""
    (s0, n0), (s1, n1) = (r["val"] for r in jig["res"][2])
    assert (s0, n0) == (s1, n1) and n0 == 2
    cfg = worker.config(drop_path=0.0).replace(data=DataConfig(**worker.DATES))
    shards = [list(make_loader(cfg.data, cfg.model, "val", cfg.horizon, 1, num_shards=2,
                               shard=r)) for r in range(2)]
    evaluate = jax.jit(jax_step.make_eval_step(jig["jmodel"], jig["jcfg"]))
    ref = 0.0
    for (b0, _), (b1, _) in zip(*shards):
        glob = jax_step.Batch(*(np.concatenate([x, y]) for x, y in zip(b0, b1)))
        ref += float(evaluate(jig["jparams"], glob, jig["jaux"]))
    assert s0 == pytest.approx(ref, rel=1e-6)


# ---- checkpoints across world sizes ----------------------------------------------------


def test_world2_checkpoint_resumes_to_the_same_bits(jig):
    for r in jig["res"][2]:
        assert (r["resumed"]["epoch"], r["resumed"]["updates"]) == (1, 2)
        assert r["resumed"]["loss"] == r["uninterrupted"]["loss"]
        _same_bits(r["resumed"]["params"], r["uninterrupted"]["params"])


def test_world2_checkpoint_loads_at_world1_in_the_one_device_layout(jig):
    """The world-2 ``train_1`` (moments gathered, written by rank 0) holds
    what one process holds: every parameter and moment at its full shape;
    it loads into a plain Adam tensor for tensor, and step 2 there agrees
    with the world-2 step 2 and the world-1 checkpoint's step 2."""
    path = os.path.join(jig["dir"], "ckpt", "train_1", ckpt.STATE_FILE)
    saved = torch.load(path, weights_only=True)
    own = torch.load(os.path.join(jig["dir"], "ckpt_w1", "train_1", ckpt.STATE_FILE),
                     weights_only=True)
    assert sorted(saved) == sorted(own) and saved["step"] == own["step"] == 1
    assert saved["optimizer"]["param_groups"] == own["optimizer"]["param_groups"]
    for i, st in own["optimizer"]["state"].items():
        for k, v in st.items():
            assert saved["optimizer"]["state"][i][k].shape == v.shape, (i, k)
    cfg = worker.config()
    model = PanguModel(cfg.model)
    model.load_state_dict(jig["w0"])
    state = TrainState(dict(model.named_parameters()), make_optimizer(model, cfg))
    state, epoch = ckpt.restore_train_state(os.path.join(jig["dir"], "ckpt"), 1, state)
    assert epoch == 1
    loaded = state.opt_state.state_dict()
    for i, st in saved["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(loaded["state"][i][k], v), (i, k)
    _same_bits({k: p.detach() for k, p in model.named_parameters()}, saved["model"])
    loss = make_train_step(model, cfg, state.opt_state)(
        jig["batch"], jig["aux"], torch.Generator().manual_seed(12))
    world2 = jig["res"][2][0]["uninterrupted"]
    assert float(loss) == pytest.approx(world2["loss"], rel=1e-5)
    _close(worker.params_of(model), world2["params"])
    _close(worker.params_of(model), jig["world1_step2"][1])


def test_world1_checkpoint_resumes_at_world2(jig):
    loss2, params2 = jig["world1_step2"]
    for r in jig["res"][2]:
        got = r["from_world1"]
        assert (got["epoch"], got["updates"]) == (1, 2)
        assert got["loss"] == pytest.approx(loss2, rel=1e-5)
        _close(got["params"], params2)


# ---- the scripts and the mesh policy ---------------------------------------------------


@pytest.mark.parametrize("script", ["finetune", "lora"])
def test_scripts_at_world2(jig, script):
    """``finetune.main`` / ``lora_tune.main`` in a world of 2 on the CPU: the
    same step losses on both ranks; rank 0 alone scores the test range
    (rank 1 returns None) and writes one set of checkpoints, CSVs and log
    lines."""
    r0, r1 = (r[script] for r in jig["res"][2])
    assert len(r0["losses"]) == 2 and r0["losses"] == r1["losses"]
    assert np.isfinite(r0["result"]) and r1["result"] is None
    out = os.path.join(jig["dir"], "scripts", "finetune_fully" if script == "finetune"
                       else "lora", "24")
    assert sorted(os.listdir(os.path.join(out, "models"))) == ["best", "train_1", "train_2"]
    assert len(os.listdir(os.path.join(out, "csv"))) == 14
    with open(os.path.join(out, f"{script}.log")) as f:
        log = f.read()
    assert log.count("Epoch 1:") == 1 and log.count("Epoch 2:") == 1
    if script == "lora":
        assert os.path.isfile(os.path.join(out, "lora_best.npz"))


@pytest.mark.parametrize("override,error,match", [
    (dict(lat=2), ValueError, "one process per card"),
    (dict(lon=2), ValueError, "one process per card"),
    (dict(pipe=2), ValueError, "one process per card")])
def test_resolve_mesh_refuses_what_is_not_ported(override, error, match):
    """In one process: a spatial or pipe axis asks for more processes than
    there are; ``make_mesh`` wants a process group for each (given the
    model, which a spatial mesh needs)."""
    with pytest.raises(error, match=match):
        resolve_mesh(ParallelConfig(**override))
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh(ParallelConfig(**override), model=pangu_tiny(lon=192).model)


def test_resolve_mesh_policy(jig):
    """One process: None, and a ``parallel.data`` > 1 raises; a world of 2:
    the default expands over both ranks, another ``data`` raises."""
    assert resolve_mesh(ParallelConfig()) is None
    with pytest.raises(ValueError, match="single process"):
        resolve_mesh(ParallelConfig(data=2))
    for rank, r in enumerate(jig["res"][2]):
        assert r["resolved"] == (2, rank)
        assert "WORLD_SIZE is 2" in r["refused"]


# ---- the random draws under a mesh ------------------------------------------------------


def test_dropout_seeds_differ_by_rank():
    """The same generator on every rank: rank 0 keeps the drawn seeds, the
    other ranks fold their rank in, so no two ranks drop the same elements."""
    attn = torch.nn.Identity().train()
    seeds = []
    for rank in (None, 0, 1, 2):
        with activate_mesh(None if rank is None else Mesh(None, 3, rank)):
            seeds.append(train_seeds(attn, torch.Generator().manual_seed(7), ATTENTION_SITES,
                                     0.1))
    assert seeds[0] == seeds[1]
    assert all(seeds[i][k] != seeds[j][k] for k in ATTENTION_SITES
               for i, j in ((1, 2), (1, 3), (2, 3)))


def test_drop_path_keeps_the_ranks_rows_of_the_global_draw():
    full = drop_path_scale(6, 0.5, torch.Generator().manual_seed(3), "cpu")
    for rank in range(3):
        with activate_mesh(Mesh(None, 3, rank)):
            got = drop_path_scale(2, 0.5, torch.Generator().manual_seed(3), "cpu")
        assert torch.equal(got, full[2 * rank:2 * rank + 2])


# ---- a world of one in this process ---------------------------------------------------


@pytest.fixture
def world_of_one(tmp_path):
    distributed_init("file://" + str(tmp_path / "store"), 1, 0, device="cpu")
    try:
        yield make_mesh(ParallelConfig(data=1))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", MODES)
def test_world_of_one_gives_the_one_process_bits(world_of_one, mode):
    """At world 1 the collectives run and are copies, and Adam is
    elementwise: each mode's step and a second one give the one-process
    bits, and the sharded optimizer's state dict is the plain one's."""
    cfg = worker.config(mode)
    m = cfg.model
    arrays = _fields(np.random.default_rng(5), m, 2)
    batch = Batch(*(torch.from_numpy(a) for a in arrays))
    aux = synthetic_aux_constants(m, cfg.train, device="cpu")
    model = PanguModel(m)
    init_params(model, seed=1)
    w0 = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    for mesh in (None, world_of_one):
        model.load_state_dict(w0)
        opt = make_optimizer(model, cfg)
        with activate_mesh(mesh):
            if mesh is not None:
                opt = zero_shard_opt_state(opt, mesh, cfg.parallel.zero_opt_state)
                assert isinstance(opt, ShardedOptimizer) == cfg.parallel.zero_opt_state
            step = make_train_step(model, cfg, opt)
            losses = [float(step(batch, aux, torch.Generator().manual_seed(s))) for s in (1, 2)]
            sd = opt.state_dict()
        runs.append((losses, worker.params_of(model), sd))
    (l0, p0, s0), (l1, p1, s1) = runs
    assert l0 == l1
    _same_bits(p0, p1)
    assert s0["param_groups"] == s1["param_groups"]
    for i, st in s0["state"].items():
        for k, v in st.items():
            assert torch.equal(s1["state"][i][k], v), (i, k)
