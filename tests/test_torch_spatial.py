"""The port's spatial sharding (``pangu_tpu_torch.parallel.spatial``) on the CPU.

Ranks are real processes (``tests/torch_spatial_worker.py``, which imports
nothing of jax or the JAX package) joined over gloo, spawned by
``test_torch_parallel._spawn`` (120 s a world). The module fixture runs a
world of 2 (meshes lat=2 and lon=2) and a world of 4 (lat=2 x lon=2, with
remat, and data=2 x lat=2) once, from one set of seeded weights and one
global batch of 2 samples, at ``pangu_tiny(lon=192, depths=(2, 2, 2, 2))``:
outer 3 x 4 windows, inner 2 x 2, depth 2 so that the shifted blocks run.

Tolerances:

* a mesh step (ZeRO-2, drop path 0.2) against the port's one-process step
  on the same global batch: loss rtol 1e-5, updated parameters rtol 2e-5 /
  atol 1e-7 (``tests/test_torch_parallel.py``'s bounds); every rank of a
  world the same bits;
* the lat=2 x lon=2 step against the JAX package's step on
  ``make_mesh(ParallelConfig(lat=2, lon=2))`` over its virtual CPU devices
  (same weights via ``load_jax_params``, drop path off): loss and every
  parameter within 1e-4 relative, the golden bound;
* the halo shift against ``torch.roll`` of the whole grid, forward and
  backward: the same bits; validation: the same value on every rank, and
  rtol 1e-5 against the one-process eval step; checkpoints: the same bits
  in the file and after a resume, the one-process bounds across worlds.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pangu_tpu.aux import synthetic_aux_constants as jax_aux
from pangu_tpu.config import ParallelConfig as JaxParallelConfig
from pangu_tpu.config import pangu_tiny as jax_tiny
from pangu_tpu.interop.torch_import import state_dict_from_params
from pangu_tpu.model import PanguModel as JaxPanguModel
from pangu_tpu.parallel import activate_mesh as jax_activate_mesh
from pangu_tpu.parallel import make_mesh as jax_make_mesh
from pangu_tpu.parallel import sharding as jax_sharding
from pangu_tpu.train import step as jax_step
from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.config import ParallelConfig, pangu_pretrain, pangu_tiny
from pangu_tpu_torch.geometry import compute_geometry
from pangu_tpu_torch.interop.from_jax import init_params, load_jax_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.model.attention import ATTENTION_SITES, train_seeds
from pangu_tpu_torch.model.blocks import drop_path_scale
from pangu_tpu_torch.parallel import activate_mesh, make_mesh, resolve_mesh
from pangu_tpu_torch.parallel.mesh import Mesh, check_partition
from pangu_tpu_torch.parallel.spatial import on_slab, partition, slab_of
from pangu_tpu_torch.train import Batch, make_eval_step, make_optimizer, make_train_step
from pangu_tpu_torch.train import checkpoint as ckpt
from pangu_tpu_torch.train.step import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_card as card  # noqa: E402
import torch_spatial_worker as worker  # noqa: E402
from test_torch_parallel import _close, _rel, _same_bits, _spawn  # noqa: E402

WORKER = os.path.join(REPO, "tests", "torch_spatial_worker.py")
ROWS = 2  # the global batch: 1 row a data replica at data=2
LAT2, LON2, LAT2_LON2, DATA2_LAT2 = (dict(lat=2), dict(lon=2), dict(lat=2, lon=2),
                                     dict(data=2, lat=2))
#: world -> the [case, mesh] pairs its ranks run, in order
CASES = {
    2: [["step", LAT2], ["step", LON2], ["halo", LAT2], ["halo", LON2], ["val", LAT2],
        ["ckpt", LAT2], ["scripts", LAT2], ["k1", LAT2]],
    4: [["step", dict(LAT2_LON2, remat=True)], ["halo", LAT2_LON2], ["jax", LAT2_LON2],
        ["val", LAT2_LON2], ["lora", LAT2_LON2], ["step", DATA2_LAT2]],
}
#: the step cases: (world, result key)
STEPS = [(2, "step:lat=2"), (2, "step:lon=2"), (4, "step:lat=2,lon=2,remat"),
         (4, "step:data=2,lat=2")]


def _key(name: str, mesh: dict) -> str:
    return name + ":" + ",".join(f"{k}={v}" for k, v in sorted(mesh.items()))


@pytest.fixture(scope="module")
def jig(tmp_path_factory):
    """Writes the weights (the port's seeded init, and the JAX init through
    ``load_jax_params``), a global batch and a world-1 checkpoint; runs the
    world-2 and world-4 ranks; computes the one-process references."""
    d = str(tmp_path_factory.mktemp("spatial"))
    cfg = worker.config()
    m = cfg.model
    model = PanguModel(m)
    init_params(model, seed=0)
    w0 = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save(w0, os.path.join(d, "w0.pt"))
    rng = np.random.default_rng(23)
    arrays = [rng.standard_normal((ROWS,) + shape).astype(np.float32) for shape in (
        (m.upper_vars, m.levels, m.lat, m.lon), (m.surface_vars, m.lat, m.lon),
        (m.upper_vars, m.levels, m.lat, m.lon), (m.surface_vars, m.lat, m.lon))]
    jcfg = jax_tiny(lon=192, depths=(2, 2, 2, 2), drop_path_max=0.0)
    jaux = jax_aux(jcfg.model, jcfg.train)
    jmodel = JaxPanguModel(jcfg.model)
    jparams = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), arrays[0][:1], arrays[1][:1], jaux))
    load_jax_params(model, m, jparams)
    torch.save({k: v.clone() for k, v in model.state_dict().items()}, os.path.join(d, "w_jax.pt"))
    batch = Batch(*(torch.from_numpy(a) for a in arrays))
    torch.save(tuple(batch), os.path.join(d, "batch.pt"))
    aux = synthetic_aux_constants(m, cfg.train, device="cpu")

    def one_process(seed, model=None, opt=None):
        if model is None:
            model = PanguModel(m)
            model.load_state_dict(w0)
            opt = make_optimizer(model, cfg)
        loss = make_train_step(model, cfg, opt)(batch, aux, torch.Generator().manual_seed(seed))
        return float(loss), worker.params_of(model), model, opt

    # the world-1 run of the checkpoint cases: step 1, save, step 2
    _, step1, model1, opt1 = one_process(11)
    ckpt.save_train_state(os.path.join(d, "ckpt_w1"), 1,
                          TrainState(dict(model1.named_parameters()), opt1))
    step2 = one_process(12, model1, opt1)[:2]
    res = {world: _spawn(world, dict(dir=d, cases=cases), os.path.join(d, f"world{world}"),
                         WORKER)
           for world, cases in CASES.items()}
    val_model = PanguModel(m)
    val_model.load_state_dict(w0)
    lora_model = PanguModel(m)
    lora_model.load_state_dict(w0)
    return dict(dir=d, res=res, one=one_process(5)[:2], w0=w0, arrays=arrays, batch=batch,
                lora=worker.lora_steps(lora_model, cfg, aux, batch),
                aux=aux, jparams=jparams, jcfg=jcfg, jaux=jaux, jmodel=jmodel,
                world1_step1=step1, world1_step2=step2,
                eval_loss=float(make_eval_step(val_model, worker.config(drop_path=0.0))(
                    batch, aux)))


# ---- the partition, without the model ------------------------------------------------------

#: flagship windows per stage (lat, lon) and the window runs each rank gets
FLAGSHIP_WINDOWS = {"outer": (31, 30), "inner": (16, 15)}
TABLE = {("outer", "lat", 2): [16, 15], ("outer", "lat", 4): [8, 8, 8, 7],
         ("outer", "lon", 2): [15, 15], ("outer", "lon", 4): [8, 8, 7, 7],
         ("inner", "lat", 2): [8, 8], ("inner", "lat", 4): [4, 4, 4, 4],
         ("inner", "lon", 2): [8, 7], ("inner", "lon", 4): [4, 4, 4, 3]}


@pytest.mark.parametrize("lon", [1, 2, 4])
@pytest.mark.parametrize("lat", [1, 2, 4])
def test_flagship_partition_covers_the_grid_on_window_edges(lat, lon):
    """At flagship, every (lat, lon) in {1, 2, 4}^2: the slabs tile the padded
    grid without gap or overlap, on window edges, differ by at most one window
    along each axis, and give the window runs of the table (the pad rows in
    the last lat slab)."""
    g = compute_geometry(pangu_pretrain(24).model)
    check_partition(g, lat, lon)
    for name, stage in (("outer", g.outer), ("inner", g.inner)):
        wz, wh, ww = stage.window
        assert (stage.h_pad // wh, stage.n_lon_windows) == FLAGSHIP_WINDOWS[name]
        cover = np.zeros((stage.h_pad, stage.w), np.int32)
        for axis, ranks, n, size in (("lat", lat, stage.h_pad // wh, wh),
                                     ("lon", lon, stage.n_lon_windows, ww)):
            runs = partition(n, ranks)
            sizes = [b - a for a, b in runs]
            assert runs[0][0] == 0 and runs[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
            assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
            if ranks > 1:
                assert sizes == TABLE[(name, axis, ranks)]
        for la, lb in partition(stage.h_pad // wh, lat):
            for wa, wb in partition(stage.n_lon_windows, lon):
                cover[la * wh:lb * wh, wa * ww:wb * ww] += 1
        assert (cover == 1).all()
        last = partition(stage.h_pad // wh, lat)[-1]
        assert last[0] * wh <= stage.h < stage.h_pad == last[1] * wh


@pytest.mark.parametrize("preset,axes,stage", [
    ("tiny", dict(lon=2), "inner"),  # pangu_tiny: outer 3 x 2 windows, inner 2 x 1
    ("tiny", dict(lat=4), "outer"),
    ("flagship", dict(lat=32), "outer"),  # 31 lat windows
    ("flagship", dict(lat=17), "inner"),  # 16 lat windows
    ("flagship", dict(lon=16), "inner"),  # 15 lon windows
])
def test_an_axis_that_outnumbers_a_stage_is_refused_naming_it(preset, axes, stage):
    """Where the JAX ``valid_spec`` would drop the axis, the port refuses,
    in ``check_partition`` and in ``make_mesh`` (before it looks for a
    process group)."""
    model = (pangu_tiny() if preset == "tiny" else pangu_pretrain(24)).model
    with pytest.raises(ValueError, match=f"the {stage} stage"):
        check_partition(compute_geometry(model), axes.get("lat", 1), axes.get("lon", 1))
    with pytest.raises(ValueError, match=f"the {stage} stage"):
        make_mesh(ParallelConfig(data=1, **axes), model=model)


@pytest.mark.parametrize("axes", [LAT2, LON2])
def test_a_spatial_mesh_needs_the_model_to_check_its_partition(axes):
    """``make_mesh`` is the one place the partition is checked, so it does not
    build a spatial mesh it cannot check."""
    with pytest.raises(ValueError, match="needs the model config"):
        make_mesh(ParallelConfig(data=1, **axes))


@pytest.mark.parametrize("axes", [LAT2, LON2, LAT2_LON2])
def test_a_single_process_refuses_a_spatial_mesh(axes):
    with pytest.raises(ValueError, match="one process per card"):
        resolve_mesh(ParallelConfig(**axes), model=worker.config().model)


def test_mesh_coordinates_are_row_major_over_data_lat_lon():
    """The rank's (data, pipe, lat, lon) as the JAX ``make_mesh`` reshapes
    its devices (pipe 1 here); drop path keeps the rows of the data coordinate (the spatial
    peers of a sample draw the same scales); outside a layer's slab the dropout
    seeds fold the data coordinate, inside it (``on_slab``) the rank."""
    full = drop_path_scale(4, 0.5, torch.Generator().manual_seed(3), "cpu")
    down = torch.nn.Identity().train()
    stage = compute_geometry(pangu_tiny().model).outer
    coords, scales, whole, slab = [], [], [], []
    for rank in range(8):
        mesh = Mesh(None, 2, rank, 2, 2)
        coords.append(mesh.coords)
        assert mesh.global_rank(*mesh.coords) == rank
        with activate_mesh(mesh):
            scales.append(drop_path_scale(2, 0.5, torch.Generator().manual_seed(3), "cpu"))
            whole.append(train_seeds(down, torch.Generator().manual_seed(7), ATTENTION_SITES,
                                     0.1))
            with on_slab(slab_of(stage, mesh)):
                slab.append(train_seeds(down, torch.Generator().manual_seed(7),
                                        ATTENTION_SITES, 0.1))
    assert coords == [(d, 0, la, lo) for d in range(2) for la in range(2) for lo in range(2)]
    for rank, (d, _, _, _) in enumerate(coords):
        assert torch.equal(scales[rank], full[2 * d:2 * d + 2])
        assert whole[rank] == whole[4 * d]
    assert whole[0] != whole[4] and len({tuple(s.values()) for s in slab}) == 8


# ---- the mesh steps --------------------------------------------------------------------


@pytest.mark.parametrize("world,key", STEPS)
def test_mesh_step_matches_the_one_process_step(jig, world, key):
    """One ZeRO-2 step (drop path 0.2) of each mesh against the one-process
    step on the same global batch and generator; every rank the same bits."""
    ranks = [r[key] for r in jig["res"][world]]
    loss, params = jig["one"]
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"]
        _same_bits(r["params"], ranks[0]["params"])
    assert ranks[0]["loss"] == pytest.approx(loss, rel=1e-5)
    _close(ranks[0]["params"], params)
    assert any(not torch.equal(params[k], jig["w0"][k]) for k in params)


def test_lat2_lon2_step_matches_the_jax_mesh_step(jig):
    """The JAX package's ZeRO-2 step on ``make_mesh(ParallelConfig(lat=2,
    lon=2))`` over its virtual CPU devices (GSPMD shards the token grid and
    inserts the halos), the same weights and global batch, drop path off,
    against the port's lat=2 x lon=2 world."""
    cfg, jmodel = jig["jcfg"], jig["jmodel"]
    opt = jax_step.make_optimizer(cfg)
    mesh = jax_make_mesh(JaxParallelConfig(lat=2, lon=2))
    params = jig["jparams"]
    with jax_activate_mesh(mesh):
        state = jax_step.TrainState(jax_sharding.shard_params(params, mesh),
                                    jax_sharding.zero_shard_opt_state(opt.init(params), mesh),
                                    jnp.zeros((), jnp.int32))
        batch = jax_sharding.shard_batch(jax_step.Batch(*jig["arrays"]), mesh)
        state, loss = jax.jit(jax_step.make_train_step(jmodel, cfg, opt))(
            state, batch, jig["jaux"], jax.random.PRNGKey(3))
    ref = state_dict_from_params(cfg.model, jax.tree_util.tree_map(np.asarray, state.params))
    got = jig["res"][4][0][_key("jax", LAT2_LON2)]
    assert abs(got["loss"] - float(loss)) / abs(float(loss)) < 1e-4
    assert sorted(got["params"]) == sorted(ref)
    for k, v in ref.items():
        assert _rel(got["params"][k].numpy(), v) < 1e-4, k


@pytest.mark.parametrize("world,key", STEPS)
def test_every_block_input_is_the_ranks_slab(jig, world, key):
    """The recorder: each of the 8 blocks' residual stream, on every rank,
    is smaller than the whole padded grid on each sharded axis and whole on
    the others (the JAX ``record_shardings`` assertion)."""
    axes = dict(kv.split("=") for kv in key.split(":")[1].split(",") if "=" in kv)
    lat, lon = int(axes.get("lat", 1)), int(axes.get("lon", 1))
    for r in jig["res"][world]:
        log = r[key]["log"]
        assert [t for t, _, _ in log] == [f"block:EarthSpecificBlock{i % 2}" for i in range(8)]
        for _, whole, local in log:
            assert (local[2] < whole[2]) == (lat > 1) and (local[3] < whole[3]) == (lon > 1)
            assert local[:2] == whole[:2] and local[4] == whole[4]


@pytest.mark.parametrize("world,axes", [(2, LAT2), (2, LON2), (4, LAT2_LON2)])
def test_halo_shift_is_torch_roll_of_the_whole_grid(jig, world, axes):
    """The shifted block's roll and its roll back on uneven slabs (3 x 3
    windows over 2 ranks an axis), gathered, against ``torch.roll`` of the
    whole grid, and the backward against the roll of the upstream gradient:
    the same bits on every rank."""
    for r in jig["res"][world]:
        for sign, got in r[_key("halo", axes)].items():
            assert got["forward"] and got["backward"], (sign, got["slab"])


@pytest.mark.parametrize("world,axes", [(2, LAT2), (4, LAT2_LON2)])
def test_lockstep_validation_is_the_same_on_every_rank(jig, world, axes):
    """``sharded_val_stats`` (data 1: every rank scores all 3 samples on its
    slabs) gives the same sums on every rank; the eval step on the fixture's
    batch equals the one-process eval step."""
    got = [r[_key("val", axes)] for r in jig["res"][world]]
    assert all(g["stats"] == got[0]["stats"] for g in got) and got[0]["stats"][1] == 3
    assert all(g["loss"] == got[0]["loss"] for g in got)
    assert got[0]["loss"] == pytest.approx(jig["eval_loss"], rel=1e-5)


def test_k1_on_a_slab_keeps_the_halo_shifts_and_folds_nothing(jig):
    """On K1's route (bf16, ``use_pallas_attention``) a block on a slab
    re-zeroes and halo-shifts before the operator and rolls back after it:
    every call is given no shift and all its rows as real, and no launch folds.
    On the whole grid the same model gives each block its shift and real
    rows; the two forecasts agree within bf16 rounding."""
    m = worker.config().model
    geo = compute_geometry(m)
    stages = [geo.outer] * 2 + [geo.inner] * 4 + [geo.outer] * 2
    for r in jig["res"][2]:
        got = r[_key("k1", LAT2)]
        assert got["folded"] == 0
        assert len(got["slab"]["calls"]) == len(stages)
        assert all(shift == [0, 0, 0] and h == rows for shift, h, rows in got["slab"]["calls"])
        assert got["whole"]["calls"] == [([w // 2 if i % 2 else 0 for w in st.window], st.h,
                                          st.h_pad) for i, st in enumerate(stages)]
        for slab, whole in zip(got["slab"]["out"], got["whole"]["out"]):
            assert _rel(slab, whole) < 0.01


def test_unmerged_lora_steps_at_lat2_lon2_match_one_process(jig):
    """Two unmerged LoRA steps (adapter dropout 0) at lat=2 x lon=2: the
    adapters riding the layers' linears are summed over the plane, those of
    the joints and the full-train heads are whole; the tree against the
    one-process steps, every rank the same bits."""
    ranks = [r[_key("lora", LAT2_LON2)] for r in jig["res"][4]]
    ref = jig["lora"]
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        _same_bits(r["tree"], ranks[0]["tree"])
    assert ranks[0]["losses"] == pytest.approx(ref["losses"], rel=1e-5)
    _close(ranks[0]["tree"], ref["tree"])
    assert any(k.startswith("lora/layers.") for k in ref["tree"])
    assert any(k.startswith("lora/downsample.") for k in ref["tree"])


# ---- checkpoints across worlds -----------------------------------------------------------


def test_lat2_checkpoint_loads_at_world1_with_the_same_bits(jig):
    """The lat=2 ``train_1`` (rank 0 writes, every rank joins) holds the
    lat=2 step-1 parameters, bit for bit, at the one-process layout; loaded
    into a plain Adam at world 1 the model and the moments have those bits,
    and its step 2 agrees with the lat=2 step 2 and the world-1 run."""
    r0 = jig["res"][2][0][_key("ckpt", LAT2)]
    path = os.path.join(jig["dir"], "ckpt", "train_1", ckpt.STATE_FILE)
    saved = torch.load(path, weights_only=True)
    _same_bits(saved["model"], r0["step1"])
    cfg = worker.config()
    model = PanguModel(cfg.model)
    model.load_state_dict(jig["w0"])
    state = TrainState(dict(model.named_parameters()), make_optimizer(model, cfg))
    state, epoch = ckpt.restore_train_state(os.path.join(jig["dir"], "ckpt"), 1, state)
    assert epoch == 1 and state.step == 1
    _same_bits(worker.params_of(model), r0["step1"])
    loaded = state.opt_state.state_dict()["state"]
    for i, st in saved["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(loaded[i][k], v), (i, k)
    loss = make_train_step(model, cfg, state.opt_state)(
        jig["batch"], jig["aux"], torch.Generator().manual_seed(12))
    assert float(loss) == pytest.approx(r0["uninterrupted"]["loss"], rel=1e-5)
    _close(worker.params_of(model), r0["uninterrupted"]["params"])
    _close(worker.params_of(model), jig["world1_step2"][1])


def test_lat2_resume_gives_the_uninterrupted_bits_and_world1_resumes_at_lat2(jig):
    """The lat=2 world restored from its own ``train_1`` takes step 2 to the
    uninterrupted bits; restored from the world-1 ``train_1`` it agrees with
    the world-1 step 2."""
    loss2, params2 = jig["world1_step2"]
    for r in jig["res"][2]:
        got = r[_key("ckpt", LAT2)]
        assert (got["resumed"]["epoch"], got["resumed"]["updates"]) == (1, 2)
        assert got["resumed"]["loss"] == got["uninterrupted"]["loss"]
        _same_bits(got["resumed"]["params"], got["uninterrupted"]["params"])
        assert got["from_world1"]["loss"] == pytest.approx(loss2, rel=1e-5)
        _close(got["from_world1"]["params"], params2)


# ---- the scripts ------------------------------------------------------------------------


@pytest.mark.parametrize("script", ["finetune", "lora"])
def test_scripts_at_lat2(jig, script):
    """``finetune.main`` / ``lora_tune.main --dropout 0`` with ``--set
    parallel.lat=2`` in a world of 2 on the CPU (the default tiny preset):
    the same step losses on both ranks (one data replica, two steps an epoch
    at batch 1); rank 0 alone scores the test range and writes the files."""
    r0, r1 = (r[_key("scripts", LAT2)][script] for r in jig["res"][2])
    assert len(r0["losses"]) == 4 and r0["losses"] == r1["losses"]
    assert np.isfinite(r0["result"]) and r1["result"] is None
    out = os.path.join(jig["dir"], "scripts", "finetune_fully" if script == "finetune"
                       else "lora", "24")
    assert sorted(os.listdir(os.path.join(out, "models"))) == ["best", "train_1", "train_2"]
    assert len(os.listdir(os.path.join(out, "csv"))) == 14


# ---- the block functions on the slabs of a lat=2 x lon=2 plane ------------------------------

#: the stages of ``worker.config()`` at the tiny widths: (stage, C, heads)
SLAB_STAGES = {"outer": (16, 2), "inner": (32, 4)}
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("stage_name", ["outer", "inner"])
@pytest.mark.parametrize("route", ["attention", "block"])
def test_block_functions_on_the_slabs_of_a_plane_give_the_whole_grid(route, stage_name,
                                                                     shifted):
    """What the deleted on-card smoke script's slab phase held, on CPU
    tensors at the tiny widths (the wrappers run their plain versions
    there): the block functions of a route on each slab of a lat=2 x lon=2
    plane (``spatial.slab_of``: whole windows, the earth bias and shift
    mask cut by ``Slab.cut_types``) against the same windows of the
    whole-grid call. Forward outputs and dx per token: the whole grid's
    bits, or within 1e-5 (the products' f32 sums over other row counts);
    the weight and bias gradients summed over the four slabs, and the earth
    bias gradient placed at each slab's window types and summed: within
    1e-5 relative of the whole grid's."""
    from pangu_tpu_torch.model.attention import shift_attention_mask

    stage = getattr(compute_geometry(worker.config().model), stage_name)
    c, heads = SLAB_STAGES[stage_name]
    gen = torch.Generator().manual_seed(90 + 2 * c + shifted)

    def rn(*shape, std=1.0, mean=0.0):
        return mean + std * torch.randn(shape, generator=gen)

    mask = torch.from_numpy(shift_attention_mask(stage)) if shifted else None
    args = (rn(1, stage.z, stage.h_pad, stage.w, c),
            rn(3 * c, c, std=c ** -0.5), rn(3 * c, std=0.02), rn(c, c, std=c ** -0.5),
            rn(c, std=0.02), rn(stage.n_type_windows, heads, 144, 144), mask,
            rn(c, mean=1.0, std=0.1), rn(c, std=0.1), rn(4 * c, c, std=c ** -0.5),
            rn(4 * c, std=0.02), rn(c, 4 * c, std=(4 * c) ** -0.5), rn(c, std=0.02),
            rn(c, mean=1.0, std=0.1), rn(c, std=0.1))
    statics = (stage.window, heads, (c // heads) ** -0.5)
    gy = rn(*args[0].shape)
    slabs = [slab_of(stage, Mesh(None, 1, r, 2, 2)) for r in range(4)]
    assert sorted({s.rows for s in slabs}) != [(0, stage.h_pad)]  # the lat axis is cut
    assert sorted({s.cols for s in slabs}) != [(0, stage.w)]  # and the lon axis
    whole = card.block_calls(route, args, statics, gy)
    sums = {k: [None] * len(grads) for k, (_, grads, _) in whole.items()}
    for slab in slabs:
        (r0, r1), (c0, c1) = slab.rows, slab.cols
        for k, (outs, grads, names) in card.block_calls(route, args, statics, gy, slab).items():
            per_token = [*outs, *grads[:1]]
            ref = [*whole[k][0], *whole[k][1][:1]]
            for got, want in zip(per_token, ref):
                torch.testing.assert_close(got, want[:, :, r0:r1, c0:c1], rtol=1e-5,
                                           atol=1e-5, msg=f"{k} slab {slab.rows}x{slab.cols}")
            for i in range(1, len(grads)):
                t = grads[i]
                if names[i] == "dbias":
                    t = card.place_types(t, slab, whole[k][1][i])
                sums[k][i] = t if sums[k][i] is None else sums[k][i] + t
    for k, (_, grads, names) in whole.items():
        for i in range(1, len(grads)):
            scale = grads[i].abs().max().item()
            torch.testing.assert_close(sums[k][i], grads[i], rtol=1e-5, atol=1e-5 * scale,
                                       msg=f"{k} {names[i]} summed over the slabs")
