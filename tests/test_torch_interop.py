"""The port's weight import against the JAX package's.

* ``.npz`` both ways, bit for bit: a file the JAX package wrote loads into
  the port's model with the JAX tree's values, and the port's
  ``save_params_npz`` of that model writes the same keys and bits, which the
  JAX package loads back;
* ONNX: the structurally faithful synthetic graph of
  ``tests/test_onnx_import.py::build_synthetic_onnx`` through the port's
  ``convert_onnx_checkpoint`` gives the JAX converter's ``.npz`` and aux
  files bit for bit, and the port's f32 forward on those weights and aux
  constants matches the JAX forward at 1e-4 (max|d| / max|ref|, the golden
  guard's bound);
* ``scripts/convert_weights.py``: the port's script writes the files the
  JAX script writes, for each of its three conversions;
* ``cli.load_model_and_params``: ``.pth``, ``.npz``, seeded weights, and
  the clear refusal of an orbax directory.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax

from pangu_tpu.aux import load_aux_constants as jax_load_aux
from pangu_tpu.config import pangu_tiny as jax_tiny
from pangu_tpu.interop import npz_io as jnpz
from pangu_tpu.interop.onnx_import import convert_onnx_checkpoint as jax_convert_onnx
from pangu_tpu.model import PanguModel as JaxPanguModel
from pangu_tpu_torch.aux import load_aux_constants
from pangu_tpu_torch.cli import load_model_and_params
from pangu_tpu_torch.config import pangu_tiny
from pangu_tpu_torch.interop import npz_io as tnpz
from pangu_tpu_torch.interop.from_jax import init_params, save_params_npz
from pangu_tpu_torch.interop.onnx_import import convert_onnx_checkpoint
from pangu_tpu_torch.interop.torch_import import state_dict_from_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.scripts import convert_weights as port_convert

from test_onnx_import import build_synthetic_onnx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Args:
    def __init__(self, weights=None):
        self.weights = weights


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX tiny model's PRNGKey(0) params, written by the JAX package."""
    jcfg = jax_tiny()
    m = jcfg.model
    from pangu_tpu.aux import synthetic_aux_constants

    jaux = synthetic_aux_constants(m, jcfg.train)
    u = np.zeros((1, m.upper_vars, m.levels, m.lat, m.lon), np.float32)
    s = np.zeros((1, m.surface_vars, m.lat, m.lon), np.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(JaxPanguModel(m).init)(
        jax.random.PRNGKey(0), u, s, jaux))
    root = tmp_path_factory.mktemp("interop")
    path = str(root / "jax.npz")
    jnpz.save_params_npz(path, params)
    return dict(jcfg=jcfg, cfg=pangu_tiny(), params=params, path=path, root=root)


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_npz_both_ways_bit_for_bit(setup, tmp_path):
    cfg = setup["cfg"]
    model = load_model_and_params(cfg, Args(setup["path"]), None, device="cpu")
    expect = state_dict_from_params(cfg.model, setup["params"])
    state = model.state_dict()
    assert sorted(state) == sorted(expect)
    for k, v in expect.items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)

    out = str(tmp_path / "port.npz")
    save_params_npz(out, model)
    written, ref = _npz(out), _npz(setup["path"])
    assert sorted(written) == sorted(ref)
    for k in ref:
        assert written[k].dtype == ref[k].dtype == np.float32
        np.testing.assert_array_equal(written[k], ref[k], err_msg=k)
    back = jnpz.load_params_npz(out)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(setup["params"])):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_npz_io_copy_round_trips_the_tree(setup, tmp_path):
    out = str(tmp_path / "tree.npz")
    tnpz.save_params_npz(out, setup["params"])
    a, b = tnpz.load_params_npz(out), jnpz.load_params_npz(setup["path"])
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_seeded_npz_round_trip_through_a_fresh_model(setup, tmp_path):
    """Seeded weights -> .npz -> another model: the same state, bit for bit."""
    cfg = setup["cfg"]
    a = PanguModel(cfg.model)
    init_params(a, seed=3)
    out = str(tmp_path / "seeded.npz")
    save_params_npz(out, a)
    b = load_model_and_params(cfg, Args(out), None, device="cpu")
    for k, v in a.state_dict().items():
        torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0)


def test_pth_loads_strictly_with_the_reference_names(setup, tmp_path):
    cfg = setup["cfg"]
    state = state_dict_from_params(cfg.model, setup["params"])
    path = str(tmp_path / "ref.pth")
    torch.save({"model": {"module." + k: torch.from_numpy(v) for k, v in state.items()}}, path)
    model = load_model_and_params(cfg, Args(path), None, device="cpu")
    for k, v in state.items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v, err_msg=k)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in list(state.items())[1:]}}, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_model_and_params(cfg, Args(path), None, device="cpu")


def test_no_weights_gives_the_seeded_init(setup):
    cfg = setup["cfg"]
    model = load_model_and_params(cfg, Args(), None, device="cpu")
    ref = PanguModel(cfg.model)
    init_params(ref, cfg.train.seed)
    assert not model.training
    for k, v in ref.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)


def test_orbax_directory_is_refused_with_the_roadmap_item(setup, tmp_path):
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        load_model_and_params(setup["cfg"], Args(str(tmp_path)), None, device="cpu")


@pytest.fixture(scope="module")
def onnx_files(setup):
    """The synthetic graph, converted by both packages."""
    root, m = setup["root"], setup["cfg"].model
    path = str(root / "tiny.onnx")
    build_synthetic_onnx(jax_tiny().model, np.random.default_rng(3), path)
    jax_convert_onnx(jax_tiny().model, path, None, str(root / "jax_onnx.npz"),
                     str(root / "jax_aux"), horizon=24, name_map_out=str(root / "jax_map.csv"))
    convert_onnx_checkpoint(m, path, None, str(root / "port_onnx.npz"), str(root / "port_aux"),
                            horizon=24, name_map_out=str(root / "port_map.csv"))
    return root


def test_onnx_conversion_matches_jax(onnx_files):
    root = onnx_files
    a, b = _npz(root / "port_onnx.npz"), _npz(root / "jax_onnx.npz")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert sorted(os.listdir(root / "port_aux")) == sorted(os.listdir(root / "jax_aux"))
    assert "constantMask24.npy" in os.listdir(root / "port_aux")
    for f in os.listdir(root / "jax_aux"):
        np.testing.assert_array_equal(np.load(root / "port_aux" / f), np.load(root / "jax_aux" / f))
    assert (root / "port_map.csv").read_bytes() == (root / "jax_map.csv").read_bytes()


def test_onnx_weights_forward_matches_jax(setup, onnx_files):
    root = onnx_files
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    m = cfg.model
    jaux = jax_load_aux(jcfg.model, jcfg.train, str(root / "jax_aux"), 24)
    aux = load_aux_constants(m, cfg.train, str(root / "port_aux"), 24, device="cpu")
    model = load_model_and_params(cfg, Args(str(root / "port_onnx.npz")), aux, device="cpu")
    rng = np.random.default_rng(0)
    u = rng.standard_normal((1, m.upper_vars, m.levels, m.lat, m.lon)).astype(np.float32)
    s = rng.standard_normal((1, m.surface_vars, m.lat, m.lon)).astype(np.float32)
    ref = JaxPanguModel(jcfg.model).apply(jnpz.load_params_npz(str(root / "jax_onnx.npz")),
                                          u, s, jaux, True)
    with torch.no_grad():
        got = model(torch.from_numpy(u), torch.from_numpy(s), aux)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.isfinite(r).all()
        assert float(np.abs(g.numpy() - r).max() / np.abs(r).max()) < 1e-4


def _jax_convert(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_convert_weights_script", os.path.join(REPO, "scripts", "convert_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["convert_weights.py", *argv])
    mod.main()


def test_convert_weights_script_matches_jax(setup, onnx_files, tmp_path, monkeypatch):
    root = onnx_files
    for side, run in (("jax", lambda a: _jax_convert(a, monkeypatch)), ("port", port_convert.main)):
        d = tmp_path / side
        d.mkdir()
        run(["--preset", "tiny", "--onnx", str(root / "tiny.onnx"), "--out", str(d / "o.npz"),
             "--aux-out", str(d / "aux")])
        run(["--preset", "tiny", "--npz", str(d / "o.npz"), "--out-pth", str(d / "o.pth")])
        run(["--preset", "tiny", "--pth", str(d / "o.pth"), "--out", str(d / "p.npz")])
    for name in ("o.npz", "p.npz"):
        a, b = _npz(tmp_path / "port" / name), _npz(tmp_path / "jax" / name)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=(name, k))
    pa = torch.load(tmp_path / "port" / "o.pth", weights_only=True)["model"]
    pb = torch.load(tmp_path / "jax" / "o.pth", weights_only=True)["model"]
    assert list(pa) == list(pb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert sorted(os.listdir(tmp_path / "port" / "aux")) == sorted(
        os.listdir(tmp_path / "jax" / "aux"))


@pytest.mark.parametrize("argv, message", [
    (["--onnx", "x.onnx"], "--onnx needs --out"),
    (["--pth", "x.pth"], "--pth needs --out"),
    (["--npz", "x.npz"], "--npz needs --out-pth"),
    ([], "nothing to do"),
])
def test_convert_weights_script_refuses_incomplete_requests(argv, message):
    with pytest.raises(SystemExit, match=message):
        port_convert.main(argv)
