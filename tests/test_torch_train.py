"""The port's train step against the JAX package's (CPU, tiny geometry).

One JAX init of ``pangu_tiny(drop_path_max=0)`` (PRNGKey(0)) is converted
through ``load_jax_params``; a seeded numpy batch feeds both sides. The
module fixture holds the jitted JAX train step (``make_train_step`` with
``make_optimizer``) run for two updates, and the jitted JAX gradient of the
training loss.

Tolerances:

* f32: max|d| / max|ref| < 1e-4 per tensor, the golden guard's bound (both
  sides true f32, only summation order differs), on the loss, every gradient
  key by key (JAX grads converted with ``state_dict_from_params``), the Adam
  moments and the updated parameters;
* bf16 (the port's kernel routing, its plain versions on the CPU, against
  the JAX bf16 XLA step): loss and every gradient within 0.04 / 0.05 after
  scaling by max(1, max|ref|), the bounds of tests/test_kernel_interpret.py,
  and the global relative L2 of the gradient below 5% (tests/test_torch_gpu.py
  holds the flagship kernel step to 1% of the plain bf16 step);
* the two A/B routes (``fused_block``: K11/K12; ``unfused_tail``: K8/K9 and
  the plain residual), bf16, against the default bf16 route and against the
  JAX f32 gradient, under the same bf16 bounds;
* ``grads_dtype="bfloat16"`` (gradients with respect to a bf16 copy of the
  parameters, cast up once) on the bf16 kernel routing against the JAX
  gradients of that setting, under the same bf16 bounds; and the JAX
  self-test's checks (f32 masters, within bf16 tolerance of the f32 tree,
  the loss falls).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pangu_tpu.aux import synthetic_aux_constants as jax_synthetic_aux
from pangu_tpu.config import pangu_tiny
from pangu_tpu.interop.torch_import import state_dict_from_params
from pangu_tpu.model import PanguModel as JaxPanguModel
from pangu_tpu.train import loss as jax_loss
from pangu_tpu.train import step as jax_step
from pangu_tpu.train.schedule import multistep_lr as jax_multistep_lr
from pangu_tpu_torch import config as port_config
from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.interop.from_jax import load_jax_opt_state, load_jax_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.ops import fused_block_attention as tfba
from pangu_tpu_torch.ops import fused_block_train as tfbt
from pangu_tpu_torch.ops import fused_epilogue as tfep
from pangu_tpu_torch.ops import fused_mlp as tfm
from pangu_tpu_torch.scripts.bench_train_ab import variant_flags
from pangu_tpu_torch.train import Batch, make_eval_step, make_optimizer, make_train_step
from pangu_tpu_torch.train.loss import weighted_l1_loss
from pangu_tpu_torch.train.schedule import multistep_lr
from pangu_tpu_torch.train.step import loss_fn, optimizer_step_count


def _fields(rng, m, lead=(1,)):
    return [rng.standard_normal(lead + shape).astype(np.float32) for shape in (
        (m.upper_vars, m.levels, m.lat, m.lon), (m.surface_vars, m.lat, m.lon),
        (m.upper_vars, m.levels, m.lat, m.lon), (m.surface_vars, m.lat, m.lon))]


def _jax_grads_fn(jmodel, cfg):
    def f(params, batch, aux):
        rngs = {"droppath": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
        return jax_step.loss_fn(jmodel, params, batch, aux, cfg, rngs, deterministic=False)

    return jax.jit(jax.value_and_grad(f))


@pytest.fixture(scope="module")
def run():
    cfg = pangu_tiny(drop_path_max=0.0)
    m = cfg.model
    jaux = jax_synthetic_aux(m, cfg.train)
    rng = np.random.default_rng(31)
    arrays = _fields(rng, m)
    micro = _fields(rng, m, lead=(2, 1))
    jmodel = JaxPanguModel(m)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), arrays[0], arrays[1], jaux)
    opt = jax_step.make_optimizer(cfg)
    step = jax.jit(jax_step.make_train_step(jmodel, cfg, opt))
    key = jax.random.PRNGKey(3)
    state0 = jax_step.TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    batch = jax_step.Batch(*arrays)
    state1, loss1 = step(state0, batch, jaux, key)
    state2, _ = step(state1, batch, jaux, key)
    cfg_acc = cfg.replace(train=dataclasses.replace(cfg.train, accumulation_steps=2))
    state_acc, loss_acc = jax.jit(jax_step.make_train_step(jmodel, cfg_acc, opt))(
        state0, jax_step.Batch(*micro), jaux, key)
    grads_fn = _jax_grads_fn(jmodel, cfg)
    _, grads = grads_fn(params, batch, jaux)
    micro_grads = [grads_fn(params, jax_step.Batch(*(a[i] for a in micro)), jaux)
                   for i in range(2)]
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tcfg = port_config.pangu_tiny(drop_path_max=0.0)  # the port's own config, same preset
    return SimpleNamespace(
        cfg=cfg, m=m, tcfg=tcfg, jaux=jaux,
        aux=synthetic_aux_constants(tcfg.model, tcfg.train, device="cpu"), arrays=arrays,
        micro=micro, jmodel=jmodel, params=tree(params), loss1=float(loss1),
        grads=state_dict_from_params(m, tree(grads)),
        micro_grads=[state_dict_from_params(m, tree(g)) for _, g in micro_grads],
        loss_acc=float(loss_acc), params_acc=state_dict_from_params(m, tree(state_acc.params)),
        state1=tree(state1), state2=tree(state2))


def _rel(got, ref) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _port(run, params, **model_kw):
    m = dataclasses.replace(run.tcfg.model, **model_kw)
    cfg = dataclasses.replace(run.tcfg, model=m)
    model = PanguModel(m)
    load_jax_params(model, m, params)
    return cfg, model


def _batch(arrays):
    return Batch(*(torch.from_numpy(a) for a in arrays))


@pytest.mark.parametrize("remat", [False, True])
def test_f32_train_step_matches_jax(run, remat):
    cfg, model = _port(run, run.params, remat=remat)
    opt = make_optimizer(model, cfg)
    loss = make_train_step(model, cfg, opt)(_batch(run.arrays), run.aux)
    assert abs(float(loss) - run.loss1) / abs(run.loss1) < 1e-4
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(run.grads)
    for k, ref in run.grads.items():
        assert _rel(named[k].grad, ref) < 1e-4, k
    new = state_dict_from_params(run.m, run.state1.params)
    for k, ref in new.items():
        assert _rel(named[k], ref) < 1e-4, k
    assert optimizer_step_count(opt) == 1


def test_accumulation_over_two_microbatches_matches_jax(run):
    """accumulation_steps=2 against the JAX step with the same setting: the
    loss, the gradients (the mean of the two microbatches' JAX gradients)
    and the updated parameters."""
    cfg, model = _port(run, run.params)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, accumulation_steps=2))
    loss = make_train_step(model, cfg, make_optimizer(model, cfg))(_batch(run.micro), run.aux)
    assert abs(float(loss) - run.loss_acc) / abs(run.loss_acc) < 1e-4
    named = dict(model.named_parameters())
    for k in run.grads:
        ref = (run.micro_grads[0][k] + run.micro_grads[1][k]) / 2
        assert _rel(named[k].grad, ref) < 1e-4, k
        assert _rel(named[k], run.params_acc[k]) < 1e-4, k


def test_resumed_optimizer_state_takes_the_jax_second_step(run):
    """After one JAX step, the port loads its params and Adam state and takes
    the second step: parameters and moments agree with JAX's second step."""
    cfg, model = _port(run, run.state1.params)
    opt = make_optimizer(model, cfg)
    load_jax_opt_state(opt, model, run.tcfg.model, run.state1.opt_state)
    assert optimizer_step_count(opt) == 1
    make_train_step(model, cfg, opt)(_batch(run.arrays), run.aux)
    named = dict(model.named_parameters())
    params1 = state_dict_from_params(run.m, run.state1.params)
    params2 = state_dict_from_params(run.m, run.state2.params)
    adam2 = run.state2.opt_state[1]
    mu2, nu2 = state_dict_from_params(run.m, adam2.mu), state_dict_from_params(run.m, adam2.nu)
    for k, p in named.items():
        assert _rel(p, params2[k]) < 1e-4, k
        assert _rel(opt.state[p]["exp_avg"], mu2[k]) < 1e-4, k
        assert _rel(opt.state[p]["exp_avg_sq"], nu2[k]) < 1e-4, k
        # the update itself (~lr), to a looser bound: Adam divides by sqrt(nu)
        assert _rel(p - torch.tensor(params1[k]), params2[k] - params1[k]) < 1e-2, k
    assert optimizer_step_count(opt) == 2 == int(adam2.count)


def test_drop_path_gradients_equal_with_and_without_remat(run):
    """With drop_path_max 0.2 and one generator seed, remat on and off draw
    the same scales (drawn outside the checkpoint) and give the same f32
    gradients."""
    grads = []
    for remat in (False, True):
        cfg, model = _port(run, run.params, remat=remat, drop_path_max=0.2)
        model.train()
        loss = loss_fn(model, _batch(run.arrays), run.aux, cfg, torch.Generator().manual_seed(5))
        loss.backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    with_dp = grads[0]
    for k, g in grads[1].items():
        assert torch.equal(g, with_dp[k]), k
    _, model = _port(run, run.params)
    model.train()
    loss_fn(model, _batch(run.arrays), run.aux, run.tcfg).backward()
    assert any(not torch.equal(p.grad, with_dp[k]) for k, p in model.named_parameters())


def test_drop_path_in_training_needs_a_generator(run):
    cfg, model = _port(run, run.params, drop_path_max=0.2)
    model.train()
    with pytest.raises(ValueError):
        loss_fn(model, _batch(run.arrays), run.aux, cfg)


def test_eval_step_matches_jax_eval_loss(run):
    _, model = _port(run, run.params)
    ref = jax_step.make_eval_step(run.jmodel, run.cfg)(run.params, jax_step.Batch(*run.arrays),
                                                       run.jaux)
    got = make_eval_step(model, run.tcfg)(_batch(run.arrays), run.aux)
    assert abs(float(got) - float(ref)) / abs(float(ref)) < 1e-4


@pytest.mark.parametrize("variant", ["wind_speed", "masked", "wind_speed_masked"])
def test_loss_variants_match_jax(run, variant):
    rng = np.random.default_rng(41)
    m = run.m
    out = _fields(rng, m, lead=(2,))
    mask = (rng.uniform(size=(m.lat, m.lon)) > 0.3).astype(np.float32)
    kw = dict(only_wind_speed="wind" in variant)
    ref = jax_loss.weighted_l1_loss(*(jnp.asarray(a) for a in out), run.jaux,
                                    mask=jnp.asarray(mask) if "masked" in variant else None, **kw)
    got = weighted_l1_loss(*(torch.from_numpy(a) for a in out), run.aux,
                           mask=torch.from_numpy(mask) if "masked" in variant else None, **kw)
    assert abs(float(got) - float(ref)) / abs(float(ref)) < 1e-5


def test_multistep_lr_matches_optax_schedule():
    """A repeated milestone multiplies once per occurrence."""
    ref = jax_multistep_lr(2e-5, (2, 5, 5, 9), 0.5, 3)
    got = multistep_lr(2e-5, (2, 5, 5, 9), 0.5, 3)
    for step in range(0, 35):
        assert abs(got(step) - float(ref(step))) <= 1e-6 * 2e-5, step
    assert got(0) == 2e-5 and got(15) == 2e-5 * 0.125


@pytest.fixture(scope="module")
def bf16_run(run):
    cfg = pangu_tiny(drop_path_max=0.0, compute_dtype="bfloat16", use_pallas_attention=True)
    jmodel = JaxPanguModel(cfg.model)
    loss, grads = _jax_grads_fn(jmodel, cfg)(run.params, jax_step.Batch(*run.arrays), run.jaux)
    return float(loss), state_dict_from_params(cfg.model, jax.tree_util.tree_map(np.asarray, grads))


def test_bf16_kernel_route_train_step_matches_jax_bf16(run, bf16_run):
    """The port's bf16 kernel routing (K2-K7 run their plain versions on the
    CPU; no launch) against the JAX bf16 training loss and gradients."""
    ref_loss, ref_grads = bf16_run
    cfg, model = _port(run, run.params, compute_dtype="bfloat16", use_pallas_attention=True)

    def counts():
        return (tfba.ATTN_FWD_LAUNCHES, tfba.ATTN_BWD_LAUNCHES, tfep.FWD_LAUNCHES,
                tfep.BWD_LAUNCHES, tfm.FWD_LAUNCHES, tfm.BWD_LAUNCHES)

    before = counts()
    loss = make_train_step(model, cfg, make_optimizer(model, cfg))(_batch(run.arrays), run.aux)
    assert before == counts()
    assert abs(float(loss) - ref_loss) / max(1.0, abs(ref_loss)) < 0.04
    _assert_bf16_grads_close({k: p.grad.numpy() for k, p in model.named_parameters()}, ref_grads)


def _assert_bf16_grads_close(got_grads, ref_grads):
    """Every gradient within 0.05 after scaling by max(1, max|ref|), the
    global relative L2 below 5%."""
    num = den = 0.0
    for k, ref in ref_grads.items():
        got = got_grads[k]
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=0.05, err_msg=k)
        num += float(((got - ref) ** 2).sum())
        den += float((ref ** 2).sum())
    assert np.sqrt(num / den) < 0.05


def _bf16_port_grads(run, **model_kw):
    """Loss and gradients of one bf16 kernel-route step of the port (remat
    on: the checkpoint recomputes each block but its kept attention and MLP
    outputs, unless K11 runs it)."""
    cfg, model = _port(run, run.params, compute_dtype="bfloat16", use_pallas_attention=True,
                       remat=True, **model_kw)
    loss = make_train_step(model, cfg, make_optimizer(model, cfg))(_batch(run.arrays), run.aux)
    return float(loss), {k: p.grad.numpy() for k, p in model.named_parameters()}


@pytest.mark.parametrize("variant", ["fused_block", "unfused_tail"])
def test_ab_route_train_step_matches_default_route_and_jax_f32(run, monkeypatch, variant):
    """A tiny bf16 train step on each A/B route (plain versions on the CPU,
    no launch) against the default bf16 route and against JAX's f32
    ``jax.grad``. The route's kernels are counted through their plain
    versions: 4 blocks, remat on with the config's default flags, which keep
    the attention and MLP outputs -- K11 runs once per block (no checkpoint
    around it), K6 and K8 once (the recompute does not run them again)."""
    calls = dict.fromkeys(("k11", "k12", "k8", "k9", "k6"), 0)
    for mod, fn, key in ((tfbt, "fused_earth_block_train_reference", "k11"),
                         (tfbt, "fused_earth_block_train_bwd_reference", "k12"),
                         (tfm, "fused_mlp_reference", "k8"), (tfm, "fused_mlp_bwd_reference", "k9"),
                         (tfm, "fused_mlp_postnorm_reference", "k6")):
        def counted(*a, _real=getattr(mod, fn), _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, fn, counted)
    launches = (tfbt.FWD_LAUNCHES, tfbt.BWD_LAUNCHES, tfm.RAW_FWD_LAUNCHES, tfm.RAW_BWD_LAUNCHES)
    default_loss, default_grads = _bf16_port_grads(run)
    assert calls["k6"] == 4 and calls["k11"] == calls["k8"] == 0
    calls.update(dict.fromkeys(calls, 0))
    with variant_flags(variant):
        loss, grads = _bf16_port_grads(run)
    want = ({"k11": 4, "k12": 4, "k8": 0, "k9": 0, "k6": 0} if variant == "fused_block"
            else {"k11": 0, "k12": 0, "k8": 4, "k9": 4, "k6": 0})
    assert calls == want
    assert launches == (tfbt.FWD_LAUNCHES, tfbt.BWD_LAUNCHES, tfm.RAW_FWD_LAUNCHES,
                        tfm.RAW_BWD_LAUNCHES)
    assert abs(loss - default_loss) / max(1.0, abs(default_loss)) < 0.04
    assert abs(loss - run.loss1) / max(1.0, abs(run.loss1)) < 0.04
    _assert_bf16_grads_close(grads, default_grads)
    _assert_bf16_grads_close(grads, run.grads)


# ---- grads_dtype="bfloat16" ------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_grads_run(run):
    """The JAX bf16 gradients with ``grads_dtype="bfloat16"``: the training
    loss differentiated with respect to a bf16 copy of the f32 params, the
    gradients cast up once (``pangu_tpu/train/step.py:99-108``)."""
    cfg = pangu_tiny(drop_path_max=0.0, compute_dtype="bfloat16", use_pallas_attention=True,
                     grads_dtype="bfloat16")
    jmodel = JaxPanguModel(cfg.model)
    params = run.params
    half = jax.tree_util.tree_map(
        lambda p: p.astype(jnp.bfloat16) if p.dtype == np.float32 else p, params)
    loss, grads = _jax_grads_fn(jmodel, cfg)(half, jax_step.Batch(*run.arrays), run.jaux)
    grads = jax.tree_util.tree_map(lambda g, p: np.asarray(g.astype(p.dtype)), grads, params)
    return float(loss), state_dict_from_params(cfg.model, grads)


@pytest.mark.parametrize("remat", [False, True])
def test_bf16_grads_step_matches_jax_bf16_grads(run, bf16_grads_run, remat):
    """The port's ``grads_dtype="bfloat16"`` step on the bf16 kernel routing
    (plain versions on the CPU) against the JAX gradients of the same
    setting, under the bf16 bounds; the gradients the update read are f32."""
    ref_loss, ref_grads = bf16_grads_run
    cfg, model = _port(run, run.params, compute_dtype="bfloat16", use_pallas_attention=True,
                       remat=remat, grads_dtype="bfloat16")
    loss = make_train_step(model, cfg, make_optimizer(model, cfg))(_batch(run.arrays), run.aux)
    assert abs(float(loss) - ref_loss) / max(1.0, abs(ref_loss)) < 0.04
    assert {p.grad.dtype for p in model.parameters()} == {torch.float32}
    _assert_bf16_grads_close({k: p.grad.numpy() for k, p in model.named_parameters()},
                             ref_grads)


def test_bf16_grads_keep_f32_masters_and_still_train(run):
    """The JAX self-test's checks (tests/test_train.py:316-368) on the port,
    bf16 compute, lr 1e-3: the step keeps every parameter, gradient and Adam
    moment in f32; its loss agrees with the f32-tree step to bf16 tolerance,
    and so do its gradients (the bf16 bounds; the updated parameters are no
    measure here: Adam's first step moves each element by about lr, so an
    element of a zero-initialized bias whose gradient rounds across zero
    moves the other way); five more steps lower the loss."""
    results = []
    for grads_dtype in ("float32", "bfloat16"):
        cfg, model = _port(run, run.params, compute_dtype="bfloat16", grads_dtype=grads_dtype)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, lr=1e-3))
        opt = make_optimizer(model, cfg)
        step = make_train_step(model, cfg, opt)
        loss = float(step(_batch(run.arrays), run.aux))
        results.append((loss, {k: p.grad.numpy().copy() for k, p in model.named_parameters()}))
    (loss_f, grads_f), (loss_h, grads_h) = results
    assert abs(loss_f - loss_h) <= 2e-2 * max(1.0, abs(loss_f))
    for p in model.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
        assert opt.state[p]["exp_avg"].dtype == opt.state[p]["exp_avg_sq"].dtype == torch.float32
    _assert_bf16_grads_close(grads_h, grads_f)
    losses = [loss_h] + [float(step(_batch(run.arrays), run.aux)) for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
