"""The port's remat flags ``remat_save_attention`` / ``remat_save_mlp`` (CPU,
tiny geometry): the mirror of tests/test_train.py::test_remat_policy_identity.

With remat on, the flags choose which stage outputs of a training block the
backward keeps (the attention output, the MLP output) and so which stages it
recomputes; they never change the math:

* the loss and every gradient are the same bits under the four settings and
  with remat off (f32, and bf16 on the kernel route, where K2-K7 run their
  plain versions on the CPU), with drop path 0.2 from one seeded generator;
* under each setting the port matches the JAX package's ``loss_fn``
  gradients with the same flags, within the train-parity bounds of
  tests/test_torch_train.py (f32: max|d| / max|ref| < 1e-4 per tensor; bf16:
  loss within 0.04, each gradient within 0.05 after scaling by max(1,
  max|ref|), global relative L2 < 5%);
* counted through their plain versions, K2's and K6's forwards (and K8's on
  the ``unfused_tail`` route) run once per block per step when their flag
  keeps them and twice when the checkpoint recomputes them; K4 always twice.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import torch

from pangu_tpu.aux import synthetic_aux_constants as jax_synthetic_aux
from pangu_tpu.config import pangu_tiny
from pangu_tpu.interop.torch_import import state_dict_from_params
from pangu_tpu.model import PanguModel as JaxPanguModel
from pangu_tpu.train import step as jax_step
from pangu_tpu_torch import config as port_config
from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.interop.from_jax import load_jax_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.ops import fused_block_attention as tfba
from pangu_tpu_torch.ops import fused_epilogue as tfep
from pangu_tpu_torch.ops import fused_mlp as tfm
from pangu_tpu_torch.scripts.bench_train_ab import variant_flags
from pangu_tpu_torch.train import Batch, make_optimizer, make_train_step
from pangu_tpu_torch.train.step import loss_fn

SETTINGS = [(False, False), (True, False), (False, True), (True, True)]
DTYPES = {"f32": {}, "bf16": dict(compute_dtype="bfloat16", use_pallas_attention=True)}


@pytest.fixture(scope="module")
def setup():
    cfg = pangu_tiny(drop_path_max=0.0)
    m = cfg.model
    jaux = jax_synthetic_aux(m, cfg.train)
    rng = np.random.default_rng(53)
    arrays = [rng.standard_normal((1,) + shape).astype(np.float32) for shape in (
        (m.upper_vars, m.levels, m.lat, m.lon), (m.surface_vars, m.lat, m.lon),
        (m.upper_vars, m.levels, m.lat, m.lon), (m.surface_vars, m.lat, m.lon))]
    params = jax.jit(JaxPanguModel(m).init)(jax.random.PRNGKey(0), arrays[0], arrays[1], jaux)
    tcfg = port_config.pangu_tiny(drop_path_max=0.0)
    return SimpleNamespace(cfg=cfg, jaux=jaux, arrays=arrays, tcfg=tcfg, jax_grads={},
                           params=jax.tree_util.tree_map(np.asarray, params),
                           aux=synthetic_aux_constants(tcfg.model, tcfg.train, device="cpu"))


def _jax_loss_grads(setup, dtype, save_attn, save_mlp):
    """JAX's training loss and gradients (torch layout) with remat on and
    the flags; cached per setting."""
    key = (dtype, save_attn, save_mlp)
    if key not in setup.jax_grads:
        cfg = setup.cfg.replace(model=dataclasses.replace(
            setup.cfg.model, remat=True, remat_save_attention=save_attn,
            remat_save_mlp=save_mlp, **DTYPES[dtype]))
        jmodel = JaxPanguModel(cfg.model)
        rngs = {"droppath": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_step.loss_fn(
            jmodel, p, jax_step.Batch(*setup.arrays), setup.jaux, cfg, rngs,
            deterministic=False)))(setup.params)
        setup.jax_grads[key] = float(loss), state_dict_from_params(
            cfg.model, jax.tree_util.tree_map(np.asarray, grads))
    return setup.jax_grads[key]


def _port_loss_grads(setup, dtype, remat, save_attn, save_mlp, drop_path=0.0):
    """The port's training loss and gradients (one backward, no update)."""
    m = dataclasses.replace(setup.tcfg.model, remat=remat, remat_save_attention=save_attn,
                            remat_save_mlp=save_mlp, drop_path_max=drop_path, **DTYPES[dtype])
    cfg = dataclasses.replace(setup.tcfg, model=m)
    model = PanguModel(m)
    load_jax_params(model, m, setup.params)
    model.train()
    loss = loss_fn(model, Batch(*(torch.from_numpy(a) for a in setup.arrays)), setup.aux, cfg,
                   torch.Generator().manual_seed(9))
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_remat_flags_give_the_same_bits(setup, dtype):
    ref_loss, ref_grads = _port_loss_grads(setup, dtype, False, False, False, drop_path=0.2)
    for save_attn, save_mlp in SETTINGS:
        loss, grads = _port_loss_grads(setup, dtype, True, save_attn, save_mlp, drop_path=0.2)
        assert torch.equal(loss, ref_loss), (save_attn, save_mlp)
        for k, g in grads.items():
            assert torch.equal(g, ref_grads[k]), (save_attn, save_mlp, k)


@pytest.mark.parametrize("save_attn,save_mlp", SETTINGS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_remat_flags_match_jax(setup, dtype, save_attn, save_mlp):
    ref_loss, ref_grads = _jax_loss_grads(setup, dtype, save_attn, save_mlp)
    loss, grads = _port_loss_grads(setup, dtype, True, save_attn, save_mlp)
    assert sorted(grads) == sorted(ref_grads)
    if dtype == "f32":
        assert abs(float(loss) - ref_loss) / abs(ref_loss) < 1e-4
        for k, ref in ref_grads.items():
            got = grads[k].numpy()
            assert np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30) < 1e-4, k
        return
    assert abs(float(loss) - ref_loss) / max(1.0, abs(ref_loss)) < 0.04
    num = den = 0.0
    for k, ref in ref_grads.items():
        got = grads[k].numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=0.05, err_msg=k)
        num += float(((got - ref) ** 2).sum())
        den += float((ref ** 2).sum())
    assert np.sqrt(num / den) < 0.05


@pytest.mark.parametrize("route", ["default", "unfused_tail"])
@pytest.mark.parametrize("save_attn,save_mlp", SETTINGS)
def test_remat_flags_skip_the_kept_kernel_forwards(setup, monkeypatch, save_attn, save_mlp,
                                                   route):
    """One bf16 kernel-route train step on 4 blocks with no launch: each
    forward counted through its plain version runs once per block when its
    output is kept and twice when the checkpoint recomputes it; each backward
    once."""
    calls = {}
    for mod, fn in ((tfba, "fused_block_attention_reference"),
                    (tfba, "fused_block_attention_bwd_reference"),
                    (tfep, "fused_residual_postnorm_reference"),
                    (tfep, "fused_residual_postnorm_bwd_reference"),
                    (tfm, "fused_mlp_postnorm_reference"), (tfm, "fused_mlp_postnorm_bwd_reference"),
                    (tfm, "fused_mlp_reference"), (tfm, "fused_mlp_bwd_reference")):
        calls[fn] = 0

        def counted(*a, _real=getattr(mod, fn), _key=fn, **kw):
            calls[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, fn, counted)
    m = dataclasses.replace(setup.tcfg.model, remat=True, remat_save_attention=save_attn,
                            remat_save_mlp=save_mlp, **DTYPES["bf16"])
    cfg = dataclasses.replace(setup.tcfg, model=m)
    launches = (tfba.ATTN_FWD_LAUNCHES, tfep.FWD_LAUNCHES, tfm.FWD_LAUNCHES, tfm.RAW_FWD_LAUNCHES)
    with variant_flags("base" if route == "default" else route):
        model = PanguModel(m)
        load_jax_params(model, m, setup.params)
        loss = make_train_step(model, cfg, make_optimizer(model, cfg))(
            Batch(*(torch.from_numpy(a) for a in setup.arrays)), setup.aux)
    assert bool(torch.isfinite(loss))
    assert launches == (tfba.ATTN_FWD_LAUNCHES, tfep.FWD_LAUNCHES, tfm.FWD_LAUNCHES,
                        tfm.RAW_FWD_LAUNCHES)
    blocks = sum(m.depths)
    mlp = blocks * (1 if save_mlp else 2)
    want = {"fused_block_attention_reference": blocks * (1 if save_attn else 2),
            "fused_block_attention_bwd_reference": blocks,
            "fused_residual_postnorm_reference": 2 * blocks,
            "fused_residual_postnorm_bwd_reference": blocks,
            "fused_mlp_postnorm_reference": mlp if route == "default" else 0,
            "fused_mlp_postnorm_bwd_reference": blocks if route == "default" else 0,
            "fused_mlp_reference": mlp if route == "unfused_tail" else 0,
            "fused_mlp_bwd_reference": blocks if route == "unfused_tail" else 0}
    assert calls == want
