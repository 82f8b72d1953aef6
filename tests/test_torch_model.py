"""The port's model, layer by layer, against the JAX package (f32, CPU).

One JAX init of ``pangu_tiny()`` -- the PRNGKey(0) init behind
tests/golden/tiny_forward.npz -- is converted through ``load_jax_params`` and
shared by every test. Each flax module is applied to its own param subtree
and compared with the port's module holding the converted weights.

Tolerance: max|d| / max|ref| < 1e-4, the golden guard's bound
(tests/test_golden_guard.py): both sides are true f32 (HIGHEST on the JAX
side, TF32 off on the torch side), so only summation order differs.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pangu_tpu.aux import load_aux_constants as jax_load_aux
from pangu_tpu.aux import norm_back_data as jax_norm_back
from pangu_tpu.aux import norm_data as jax_norm
from pangu_tpu.aux import synthetic_aux_constants as jax_synthetic_aux
from pangu_tpu.config import pangu_pretrain, pangu_tiny
from pangu_tpu.geometry import compute_geometry
from pangu_tpu.interop.torch_import import reference_key_map, state_dict_from_params
from pangu_tpu.model import PanguModel as JaxPanguModel
from pangu_tpu.model.attention import EarthAttention3D as JaxAttention
from pangu_tpu.model.blocks import DownSample as JaxDownSample
from pangu_tpu.model.blocks import EarthSpecificBlock as JaxBlock
from pangu_tpu.model.blocks import UpSample as JaxUpSample
from pangu_tpu.model.embeddings import PatchEmbedding as JaxPatchEmbedding
from pangu_tpu.model.embeddings import PatchRecovery as JaxPatchRecovery
from pangu_tpu_torch import config as port_config
from pangu_tpu_torch.aux import (
    load_aux_constants,
    norm_back_data,
    norm_data,
    synthetic_aux_constants,
)
from pangu_tpu_torch.interop.from_jax import load_jax_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.model.attention import shift_attention_mask
from pangu_tpu_torch.model.blocks import EarthSpecificBlock
from pangu_tpu_torch.geometry import compute_geometry as port_geometry

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_forward.npz")
HIGHEST = jax.lax.Precision.HIGHEST


@pytest.fixture(scope="module")
def tiny():
    cfg = pangu_tiny()
    m = cfg.model
    jaux = jax_synthetic_aux(m, cfg.train)
    rng = np.random.default_rng(20260817)  # the golden guard's inputs
    upper = rng.standard_normal((1, m.upper_vars, m.levels, m.lat, m.lon)).astype(np.float32)
    surface = rng.standard_normal((1, m.surface_vars, m.lat, m.lon)).astype(np.float32)
    params = jax.jit(JaxPanguModel(m).init)(jax.random.PRNGKey(0), upper, surface, jaux)
    params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = port_config.pangu_tiny()  # the port's own config, same preset
    model = PanguModel(tcfg.model)
    load_jax_params(model, tcfg.model, params)
    model.eval()
    return SimpleNamespace(cfg=cfg, m=m, g=compute_geometry(m), jaux=jaux, tcfg=tcfg,
                           tg=port_geometry(tcfg.model),
                           aux=synthetic_aux_constants(tcfg.model, tcfg.train, device="cpu"),
                           params=params["params"], model=model, upper=upper, surface=surface)


def _rel(got, ref) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_tiny_forward_matches_golden(tiny):
    with torch.inference_mode():
        ou, os_ = tiny.model(torch.from_numpy(tiny.upper), torch.from_numpy(tiny.surface),
                             tiny.aux)
    g = np.load(GOLDEN)
    assert _rel(ou, g["upper"]) < 1e-4
    assert _rel(os_, g["surface"]) < 1e-4


def test_state_dict_is_the_reference_state_dict(tiny):
    ref = state_dict_from_params(tiny.m, {"params": tiny.params})
    got = tiny.model.state_dict()
    assert sorted(got) == sorted(k for k, _, _ in reference_key_map(tiny.m))
    for k, v in ref.items():
        assert tuple(got[k].shape) == v.shape, k


@pytest.mark.parametrize("masked", [False, True])
def test_attention_matches_flax(tiny, masked):
    st, (c, heads) = tiny.g.outer, (tiny.m.dims[0], tiny.m.heads[0])
    x = _randn(1, 2, st.z, st.h_pad, st.w, c)
    mask = shift_attention_mask(st) if masked else None
    ref = JaxAttention(dim=c, heads=heads, n_type_windows=st.n_type_windows,
                       tokens_per_window=st.tokens_per_window, window=st.window,
                       precision=HIGHEST).apply(
        {"params": tiny.params["layer0"]["block0"]["attn"]}, jnp.asarray(x),
        None if mask is None else jnp.asarray(mask))
    attn = tiny.model.layers.EarthSpecificLayer0.blocks.EarthSpecificBlock0.attention
    with torch.inference_mode():
        got = attn(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    assert _rel(got, ref) < 1e-4


@pytest.mark.parametrize("layer,stage,shifted", [
    (0, "outer", False), (0, "outer", True), (1, "inner", True)])
def test_block_matches_flax(tiny, layer, stage, shifted):
    """The tiny config has one (unshifted) block per layer; a shifted block
    takes the same weights (the shift mask is not a parameter)."""
    st = getattr(tiny.g, stage)
    c, heads = tiny.m.dims[layer], tiny.m.heads[layer]
    x = _randn(2, 1, st.z, st.h_pad, st.w, c)  # pad rows too: the block re-zeroes them
    ref = JaxBlock(stage=st, dim=c, heads=heads, drop_path_rate=0.0, shifted=shifted,
                   precision=HIGHEST).apply(
        {"params": tiny.params[f"layer{layer}"]["block0"]}, jnp.asarray(x), True)
    src = tiny.model.layers[f"EarthSpecificLayer{layer}"].blocks.EarthSpecificBlock0
    block = EarthSpecificBlock(getattr(tiny.tg, stage), c, heads, shifted=shifted).eval()
    block.load_state_dict(src.state_dict())
    with torch.inference_mode():
        got = block(torch.from_numpy(x))
    assert _rel(got, ref) < 1e-4


def test_downsample_matches_flax(tiny):
    g = tiny.g
    x = _randn(3, 1, g.z, g.h, g.w, tiny.m.dims[0])
    ref = JaxDownSample(tiny.m.dims[0], g.h_down_pad, precision=HIGHEST).apply(
        {"params": tiny.params["downsample"]}, jnp.asarray(x))
    with torch.inference_mode():
        got = tiny.model.downsample(torch.from_numpy(x))
    assert _rel(got, ref) < 1e-4


def test_upsample_matches_flax(tiny):
    g, dims = tiny.g, tiny.m.dims
    x = _randn(4, 1, g.z, g.h2, g.w2, dims[2])
    ref = JaxUpSample(dims[2], dims[3], g.h, precision=HIGHEST).apply(
        {"params": tiny.params["upsample"]}, jnp.asarray(x))
    with torch.inference_mode():
        got = tiny.model.upsample(torch.from_numpy(x))
    assert _rel(got, ref) < 1e-4


def test_patch_embedding_matches_flax(tiny):
    ref = JaxPatchEmbedding(tiny.m, tiny.g, precision=HIGHEST).apply(
        {"params": tiny.params["patch_embed"]}, jnp.asarray(tiny.upper),
        jnp.asarray(tiny.surface), tiny.jaux)
    with torch.inference_mode():
        got = tiny.model._input_layer(torch.from_numpy(tiny.upper),
                                      torch.from_numpy(tiny.surface), tiny.aux, torch.float32)
    assert _rel(got, ref) < 1e-4


def test_patch_recovery_matches_flax(tiny):
    g = tiny.g
    x = _randn(5, 1, g.z, g.h, g.w, tiny.m.dims[0] + tiny.m.dims[3])
    ref_u, ref_s = JaxPatchRecovery(tiny.m, g, precision=HIGHEST).apply(
        {"params": tiny.params["patch_recovery"]}, jnp.asarray(x))
    with torch.inference_mode():
        got_u, got_s = tiny.model._output_layer(torch.from_numpy(x))
    assert _rel(got_u, ref_u) < 1e-4
    assert _rel(got_s, ref_s) < 1e-4


@pytest.mark.parametrize("config,seed", [("tiny", 0), ("tiny", 5), ("pretrain", 0)])
def test_synthetic_aux_equals_jax(config, seed):
    cfg = pangu_tiny() if config == "tiny" else pangu_pretrain()
    tcfg = port_config.pangu_tiny() if config == "tiny" else port_config.pangu_pretrain()
    ref = jax_synthetic_aux(cfg.model, cfg.train, seed=seed)
    got = synthetic_aux_constants(tcfg.model, tcfg.train, seed=seed, device="cpu")
    for name, value in vars(ref).items():
        mine = getattr(got, name)
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(mine.numpy(), value, err_msg=name)
        else:
            assert mine == value, name


def test_norm_data_and_back_match_jax(tiny):
    m = tiny.m
    u = _randn(6, 2, m.upper_vars, m.levels, m.lat, m.lon)
    s = _randn(7, 2, m.surface_vars, m.lat, m.lon)
    for port_fn, jax_fn in ((norm_data, jax_norm), (norm_back_data, jax_norm_back)):
        got = port_fn(torch.from_numpy(u), torch.from_numpy(s), tiny.aux)
        ref = jax_fn(u, s, tiny.jaux)
        for a, b in zip(got, ref):
            assert _rel(a, b) < 1e-6


def test_load_aux_constants_from_dir_matches_jax(tiny, tmp_path):
    """The ONNX-extracted file layout, including the level flip of the upper
    statistics."""
    m = tiny.m
    rng = np.random.default_rng(8)
    files = {
        "surface_mean.npy": (m.surface_vars,), "surface_std.npy": (m.surface_vars,),
        "upper_mean.npy": (m.levels, 1, 1, m.upper_vars),
        "upper_std.npy": (m.levels, 1, 1, m.upper_vars),
        "constantMask24.npy": (m.surface_const_channels, m.lat + tiny.g.lat_pad, m.lon),
        "Constant_17_output_0.npy": (m.upper_const_channels, m.levels, m.lat, m.lon),
        "custom_mask.npy": (m.lat, m.lon),
    }
    for name, shape in files.items():
        np.save(tmp_path / name, rng.standard_normal(shape).astype(np.float32))
    ref = jax_load_aux(m, tiny.cfg.train, str(tmp_path), horizon=24)
    got = load_aux_constants(tiny.tcfg.model, tiny.tcfg.train, str(tmp_path), horizon=24,
                             device="cpu")
    for name, value in vars(ref).items():
        mine = getattr(got, name)
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(mine.numpy(), value, err_msg=name)
        else:
            assert mine == value, name
