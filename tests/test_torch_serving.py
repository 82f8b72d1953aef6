"""The port's serving artifacts against the JAX package's, on the CPU.

* f32 round trip: ``export_forecast_step`` -> ``load_forecast_step`` against
  the JAX ``jax.jit(make_serving_fn(...))`` on the same weights, max|d| /
  max|ref| < 1e-4 (the golden guard's bound; both sides true f32), then one
  fed-back step.
* bf16 kernel route: the exported graph holds exactly ``sum(depths)`` calls
  of K1's operator and no other op outside aten; the loaded step gives the
  bits of the eager ``make_forecast_step`` (the same operations in the same
  order; on the CPU the operator runs K1's plain version) and stays within
  the bounds of ``test_torch_rollout.py::test_bf16_step_against_jax_f32_step``
  of the JAX f32 step (max 0.026, RMS 0.005 in normalized units).
* a batch-2 artifact, a load in a fresh process that imports no model code,
  the export script end to end, and the platform argument. The flagship
  step served on the card is tests/test_torch_gpu.py's.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

from pangu_tpu.aux import synthetic_aux_constants as jax_synthetic_aux
from pangu_tpu.config import pangu_tiny
from pangu_tpu.interop.npz_io import save_params_npz as jax_save_params_npz
from pangu_tpu.model import PanguModel as JaxPanguModel
from pangu_tpu.serving import make_serving_fn as jax_make_serving_fn
from pangu_tpu_torch import config as port_config
from pangu_tpu_torch import serving
from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.interop.from_jax import init_params, load_jax_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.ops import fused_block_attention as tfba
from pangu_tpu_torch.rollout import make_forecast_step
from pangu_tpu_torch.scripts import export_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_ROUTE = dict(compute_dtype="bfloat16", use_pallas_attention=True)


@pytest.fixture(scope="module")
def setup():
    cfg = pangu_tiny()
    m = cfg.model
    jaux = jax_synthetic_aux(m, cfg.train)
    rng = np.random.default_rng(0)
    upper = rng.standard_normal((1, m.upper_vars, m.levels, m.lat, m.lon)).astype(np.float32)
    surface = rng.standard_normal((1, m.surface_vars, m.lat, m.lon)).astype(np.float32)
    jmodel = JaxPanguModel(m)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), upper, surface, jaux)
    params = jax.tree_util.tree_map(np.asarray, params)
    ref = jax.jit(jax_make_serving_fn(jmodel, params, jaux))(upper, surface)
    tcfg = port_config.pangu_tiny()
    return dict(m=m, tm=tcfg.model, jaux=jaux, params=params, ref=[np.asarray(r) for r in ref],
                aux=synthetic_aux_constants(tcfg.model, tcfg.train, device="cpu"),
                upper=upper, surface=surface)


def _port(setup, **model_kw):
    m = dataclasses.replace(setup["tm"], **model_kw)
    model = PanguModel(m)
    load_jax_params(model, m, setup["params"])
    return model


def _fields(setup, batch=1):
    return (torch.from_numpy(np.repeat(setup["upper"], batch, 0)),
            torch.from_numpy(np.repeat(setup["surface"], batch, 0)))


def _rel(got, ref) -> float:
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_export_roundtrip_matches_jax_serving_fn(setup, tmp_path):
    path = str(tmp_path / "tiny.pt2")
    serving.export_forecast_step(_port(setup), setup["aux"], path)
    step = serving.load_forecast_step(path)
    got_u, got_s = step(*_fields(setup))
    assert got_u.dtype == torch.float32
    assert _rel(got_u, setup["ref"][0]) < 1e-4
    assert _rel(got_s, setup["ref"][1]) < 1e-4
    # physical-unit outputs feed back as inputs (autoregressive serving)
    again_u, again_s = step(got_u, got_s)
    assert bool(torch.isfinite(again_u).all()) and bool(torch.isfinite(again_s).all())


def test_bf16_kernel_route_exports_k1_calls_and_keeps_the_eager_bits(setup, tmp_path):
    model = _port(setup, **KERNEL_ROUTE)
    path = str(tmp_path / "tiny_bf16.pt2")
    program = serving.export_forecast_step(model, setup["aux"], path)
    ops = serving.graph_ops(program)
    assert ops[serving.K1_OP] == sum(setup["m"].depths)
    assert all(k.startswith("aten::") for k in ops if k != serving.K1_OP), sorted(ops)

    upper, surface = _fields(setup)
    before = tfba.LAUNCHES
    got = serving.load_forecast_step(path)(upper, surface)
    eager = make_forecast_step(model, setup["aux"])(upper, surface)
    assert tfba.LAUNCHES == before  # CPU tensors: the plain version, never the kernel
    for g, e in zip(got, eager):
        assert torch.equal(g, e)
    for g, r, std in zip(got, setup["ref"], (setup["jaux"].upper_std, setup["jaux"].surface_std)):
        d = (g.numpy() - r) / std  # normalized output units
        assert np.abs(d).max() < 0.026
        assert np.sqrt(np.mean(d ** 2)) < 0.005


def test_shifted_blocks_export_their_masks_on_the_export_device(tmp_path):
    """Depth 2: every second block is shifted, and its mask (a non-persistent
    buffer built from numpy) is a constant of the program on the export
    device; the loaded step keeps the eager bits."""
    cfg = port_config.pangu_tiny(depths=(2, 2, 2, 2), **KERNEL_ROUTE)
    model = PanguModel(cfg.model)
    init_params(model, seed=3)
    aux = synthetic_aux_constants(cfg.model, cfg.train, device="cpu")
    path = str(tmp_path / "tiny_shifted.pt2")
    program = serving.export_forecast_step(model, aux, path)
    assert serving.graph_ops(program)[serving.K1_OP] == 8
    masks = {k: v for k, v in program.constants.items() if k.endswith("attn_mask")}
    assert len(masks) == 4 and all(v.device.type == "cpu" for v in masks.values())
    m = cfg.model
    rng = np.random.default_rng(4)
    upper = torch.from_numpy(rng.standard_normal(
        (1, m.upper_vars, m.levels, m.lat, m.lon)).astype(np.float32))
    surface = torch.from_numpy(rng.standard_normal(
        (1, m.surface_vars, m.lat, m.lon)).astype(np.float32))
    got = serving.load_forecast_step(path)(upper, surface)
    eager = make_forecast_step(model, aux)(upper, surface)
    assert all(torch.equal(g, e) for g, e in zip(got, eager))


def test_batch_two_artifact(setup, tmp_path):
    model = _port(setup)
    path = str(tmp_path / "tiny_b2.pt2")
    serving.export_forecast_step(model, setup["aux"], path, batch=2)
    step = serving.load_forecast_step(path)
    upper, surface = _fields(setup, batch=2)
    upper[1] += 0.5
    got = step(upper, surface)
    eager = make_forecast_step(model, setup["aux"])(upper, surface)
    assert got[0].shape[0] == 2 and got[1].shape[0] == 2
    for g, e in zip(got, eager):
        torch.testing.assert_close(g, e, rtol=1e-5, atol=1e-5)
    assert _rel(got[0][:1], setup["ref"][0]) < 1e-4
    with pytest.raises(Exception):
        step(*_fields(setup, batch=1))  # the batch is static


def test_serving_module_holds_the_aux_constants_as_buffers(setup):
    fn = serving.make_serving_fn(_port(setup), setup["aux"])
    assert not fn.training and not fn.model.training
    state = fn.state_dict()
    for name in ("upper_mean", "upper_std", "surface_mean", "surface_std", "surface_mask",
                 "const_h"):
        assert torch.equal(state[name], getattr(setup["aux"], name))
    assert fn.aux().surface_loss_weight == setup["aux"].surface_loss_weight


def test_load_in_a_fresh_process_imports_no_model_code(setup, tmp_path):
    model = _port(setup, **KERNEL_ROUTE)
    path = str(tmp_path / "tiny_bf16.pt2")
    serving.export_forecast_step(model, setup["aux"], path)
    upper, surface = _fields(setup)
    torch.save({"upper": upper, "surface": surface}, tmp_path / "in.pt")
    code = (
        "import sys, torch\n"
        "from pangu_tpu_torch.serving import load_forecast_step\n"
        f"step = load_forecast_step({path!r})\n"
        f"fields = torch.load({str(tmp_path / 'in.pt')!r})\n"
        "u, s = step(fields['upper'], fields['surface'])\n"
        f"torch.save({{'upper': u, 'surface': s}}, {str(tmp_path / 'out.pt')!r})\n"
        "bad = sorted(m for m in sys.modules if m.startswith('pangu_tpu_torch.model')\n"
        "             or m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pangu_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env, check=True,
                   timeout=300)
    out = torch.load(tmp_path / "out.pt")
    eager = make_forecast_step(model, setup["aux"])(upper, surface)
    assert torch.equal(out["upper"], eager[0]) and torch.equal(out["surface"], eager[1])


def test_export_model_script(setup, tmp_path):
    """The export script on a JAX-written ``.npz``: the artifact, its
    load-back check, then a fresh load on the zero fields against the eager
    step of the same weights."""
    ckpt = str(tmp_path / "tiny.npz")
    jax_save_params_npz(ckpt, setup["params"])
    out = str(tmp_path / "tiny_serving.pt2")
    assert export_model.main(["--preset", "tiny", "--weights", ckpt, "--out-file", out],
                             device="cpu") == out
    assert os.path.getsize(out) > 0
    m = setup["tm"]
    u = torch.zeros((1, m.upper_vars, m.levels, m.lat, m.lon))
    s = torch.zeros((1, m.surface_vars, m.lat, m.lon))
    got = serving.load_forecast_step(out)(u, s)
    eager = make_forecast_step(_port(setup), setup["aux"])(u, s)
    for g, e in zip(got, eager):
        torch.testing.assert_close(g, e, rtol=0, atol=0)


def test_platforms_name_one_device(setup, tmp_path):
    model = _port(setup)
    path = str(tmp_path / "x.pt2")
    for platforms in (["cpu", "cuda"], ["tpu"]):
        with pytest.raises(ValueError, match="platform"):
            serving.export_forecast_step(model, setup["aux"], path, platforms=platforms)
    with pytest.raises(ValueError, match="one device"):
        export_model.main(["--preset", "tiny", "--platforms", "cpu,cuda", "--out-file", path],
                          device="cpu")
    assert not os.path.exists(path)
    serving.export_forecast_step(model, setup["aux"], path, platforms=["cpu"])
    assert serving.load_forecast_step(path).program.state_dict
