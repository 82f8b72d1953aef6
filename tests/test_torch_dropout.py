"""Model dropout in the port (CPU, tiny geometry).

The four sites of the JAX modules, ``attn_drop``/``proj_drop``
(pangu_tpu/model/attention.py:262,280) and ``drop1``/``drop2``
(pangu_tpu/model/blocks.py:153,162), and the unmerged LoRA adapters'
dropout (``lora_tap``). The masks' bits cannot match JAX's draws, so the
checks are:

* eval ignores the rate: the port's eval forward at rate 0.5 equals its
  forward at rate 0 bit for bit, and the JAX package's deterministic
  forward at rate 0.5 within 1e-4 relative (the golden guard's f32 bound);
* a fixed generator gives the same bits, another seed other bits;
* remat off, remat keeping the attention and MLP outputs, and remat of
  whole blocks give the same bits (loss and every gradient) with dropout
  > 0 and with unmerged adapter dropout: the masks come from per-site
  seeds drawn before the checkpointed stages;
* the keep-scaling: kept elements are x / keep (keep rounded to x's dtype,
  as flax's weakly typed keep is) and the rest 0, the values flax's
  ``nn.Dropout`` gives where both keep an element, in f32 and bf16; the
  kept share within 5 standard errors of keep;
* the routes of JAX: in training, active dropout sends the attention and
  the MLP off their kernels while the first residual keeps K4 and K11 is
  not taken; eval keeps K1.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from pangu_tpu.aux import synthetic_aux_constants as jax_aux
from pangu_tpu.config import pangu_tiny as jax_tiny
from pangu_tpu.model import PanguModel as JaxPanguModel
from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.config import pangu_tiny
from pangu_tpu_torch.interop.from_jax import init_params, load_jax_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.model import attention as tattn
from pangu_tpu_torch.model import blocks as tblocks
from pangu_tpu_torch.model.attention import dropout
from pangu_tpu_torch.ops import fused_block_train as tfbt
from pangu_tpu_torch.ops import fused_mlp as tfm
from pangu_tpu_torch.train import Batch
from pangu_tpu_torch.train.lora import LoraConfig, attach_lora, init_lora_params
from pangu_tpu_torch.train.step import loss_fn

RATE = 0.3


@pytest.fixture(scope="module")
def inputs():
    cfg = pangu_tiny()
    m = cfg.model
    rng = np.random.default_rng(21)
    arrays = [rng.standard_normal((1,) + s).astype(np.float32) for s in (
        (m.upper_vars, m.levels, m.lat, m.lon), (m.surface_vars, m.lat, m.lon),
        (m.upper_vars, m.levels, m.lat, m.lon), (m.surface_vars, m.lat, m.lon))]
    return cfg, arrays, synthetic_aux_constants(m, cfg.train, device="cpu")


def _model(cfg, **kw):
    model = PanguModel(dataclasses.replace(cfg.model, **kw))
    init_params(model, 0)
    return model


def _batch(arrays):
    return Batch(*(torch.from_numpy(a) for a in arrays))


def _loss_and_grads(model, cfg, arrays, aux, seed):
    model.train()
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, _batch(arrays), aux, cfg, torch.Generator().manual_seed(seed))
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()
                           if p.grad is not None}


def test_eval_ignores_dropout(inputs):
    cfg, arrays, aux = inputs
    m = cfg.model
    jcfg = jax_tiny(dropout_rate=0.5)
    jmodel = JaxPanguModel(jcfg.model)
    jaux = jax_aux(jcfg.model, jcfg.train)
    params = jmodel.init(jax.random.PRNGKey(0), arrays[0], arrays[1], jaux)
    ref_u, ref_s = jmodel.apply(params, arrays[0], arrays[1], jaux, True)
    outs = []
    for rate in (0.5, 0.0):
        model = PanguModel(dataclasses.replace(m, dropout_rate=rate)).eval()
        load_jax_params(model, m, jax.tree_util.tree_map(np.asarray, params))
        with torch.no_grad():
            outs.append(model(*_batch(arrays)[:2], aux))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    for got, ref in zip(outs[0], (ref_u, ref_s)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < 1e-4


def test_a_fixed_generator_gives_the_same_bits(inputs):
    cfg, arrays, aux = inputs
    model = _model(cfg, dropout_rate=RATE)
    first = _loss_and_grads(model, cfg, arrays, aux, 7)
    again = _loss_and_grads(model, cfg, arrays, aux, 7)
    other = _loss_and_grads(model, cfg, arrays, aux, 8)
    assert torch.equal(first[0], again[0])
    assert all(torch.equal(g, again[1][k]) for k, g in first[1].items())
    assert not torch.equal(first[0], other[0])
    plain = _loss_and_grads(_model(cfg), cfg, arrays, aux, 7)
    assert not torch.equal(first[0], plain[0])


def test_training_with_dropout_needs_a_generator(inputs):
    cfg, arrays, aux = inputs
    model = _model(cfg, dropout_rate=RATE, drop_path_max=0.0).train()
    with pytest.raises(ValueError, match="torch.Generator"):
        loss_fn(model, _batch(arrays), aux, cfg)


REMAT = {"off": dict(remat=False),
         "keep": dict(remat=True, remat_save_attention=True, remat_save_mlp=True),
         "whole": dict(remat=True, remat_save_attention=False, remat_save_mlp=False)}


@pytest.mark.parametrize("adapters", [False, True])
def test_remat_gives_the_same_bits_with_dropout(inputs, adapters):
    """With dropout > 0 (or, unmerged, adapter dropout 0.2 at model dropout
    0): the loss and every gradient of remat off, kept and whole."""
    cfg, arrays, aux = inputs
    results = {}
    for name, kw in REMAT.items():
        model = _model(cfg, dropout_rate=0.0 if adapters else RATE, **kw)
        if adapters:
            lcfg = LoraConfig(rank=4, alpha=8.0, dropout=0.2)
            tree = init_lora_params(model, lcfg, torch.Generator().manual_seed(1))
            with torch.no_grad():
                for ab in tree["lora"].values():
                    ab["b"].normal_(0.0, 0.02, generator=torch.Generator().manual_seed(2))
            attach_lora(model, tree, lcfg, unmerged=True)
        results[name] = _loss_and_grads(model, cfg, arrays, aux, 5)
        if adapters:
            results[name][1].update({f"a.{k}": ab["a"].grad.clone()
                                     for k, ab in tree["lora"].items()})
    ref = results.pop("off")
    for name, (loss, grads) in results.items():
        assert torch.equal(loss, ref[0]), name
        assert sorted(grads) == sorted(ref[1])
        for k, g in grads.items():
            assert torch.equal(g, ref[1][k]), (name, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_keep_scaling_is_flax_dropout(dtype):
    x = torch.linspace(-2.0, 2.0, 200_000).to(dtype)
    keep = 1.0 - RATE
    y = dropout(x, RATE, seed=3)
    kept = y != 0
    assert torch.equal(y[kept], (x / torch.tensor(keep, dtype=dtype))[kept])
    share = kept.float().mean().item()
    assert abs(share - keep) < 5 * (keep * RATE / x.numel()) ** 0.5
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x.float().numpy()).astype(jdt)
    yj = fnn.Dropout(RATE).apply({}, xj, deterministic=False,
                                 rngs={"dropout": jax.random.PRNGKey(0)})
    kept_j = np.asarray(yj.astype(jnp.float32)) != 0
    # where both keep an element they give the same value
    both = kept.numpy() & kept_j
    assert both.sum() > 0.4 * x.numel()
    assert np.array_equal(y.float().numpy()[both], np.asarray(yj.astype(jnp.float32))[both])
    assert torch.equal(dropout(x, RATE, None), x) and torch.equal(dropout(x, 0.0, 3), x)


def _counting(monkeypatch):
    calls = dict.fromkeys(("attention", "residual", "mlp_tail", "block", "block_train"), 0)

    def wrap(module, name, key):
        real = getattr(module, name)

        def counted(*a, **k):
            calls[key] += 1
            return real(*a, **k)

        monkeypatch.setattr(module, name, counted)

    wrap(tattn, "fused_block_attention", "attention")
    wrap(tblocks, "fused_residual_postnorm", "residual")
    wrap(tfm, "fused_mlp_postnorm", "mlp_tail")
    wrap(tblocks, "fused_earth_block", "block")
    wrap(tfbt, "fused_earth_block_train", "block_train")
    return calls


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_dropout_routes_as_jax(inputs, monkeypatch, rate):
    """bf16 kernel route (the kernels' plain versions on the CPU), no remat:
    training at rate > 0 calls K4 per block and neither K2 nor K6; at rate
    0 all three; with ``_TRAIN_FUSION`` K11 only at rate 0; eval calls K1
    per block either way."""
    cfg, arrays, aux = inputs
    calls = _counting(monkeypatch)
    blocks = sum(cfg.model.depths)
    model = _model(cfg, dropout_rate=rate, compute_dtype="bfloat16",
                   use_pallas_attention=True, remat=False)
    _loss_and_grads(model, cfg, arrays, aux, 1)
    k = 0 if rate else blocks
    assert calls == dict(attention=k, residual=blocks, mlp_tail=k, block=0, block_train=0)
    calls.update(dict.fromkeys(calls, 0))
    monkeypatch.setattr(tfbt, "_TRAIN_FUSION", True)
    _loss_and_grads(model, cfg, arrays, aux, 1)
    assert calls["block_train"] == k and calls["residual"] == blocks - k
    calls.update(dict.fromkeys(calls, 0))
    with torch.no_grad():
        model.eval()(*_batch(arrays)[:2], aux)
    assert calls["block"] == blocks and calls["attention"] == 0
