"""The port's LoRA against the JAX package's (CPU, tiny geometry).

One JAX init of ``pangu_tiny(drop_path_max=0)`` (PRNGKey(0)) and one JAX
LoRA tree (``init_lora_params``, PRNGKey(1), rank 4, alpha 8, adapter
dropout 0) whose B is redrawn nonzero from a numpy seed (at B = 0 the
gradient of A is zero); the biases too are redrawn nonzero, as a pretrained
model's are (a zero bias is, after one Adam step, lr * g / (|g| + eps)
alone, which turns a gradient that is round-off into a difference of the
order of the LR); the tree crosses to the port through
``interop.from_jax.lora_tree_from_jax``; a seeded numpy batch feeds both.

Tolerances, f32 (both sides true f32; only the order of the sums differs):
max|d| / max|ref| < 1e-4 per tensor, the golden guard's bound
(tests/test_golden_guard.py:67), on the loss, A, B and the head overrides
after one and two merged updates and after one unmerged update; 1e-6 for
``merge_params`` (one product and one sum). The bf16 kernel route (the
kernels' plain versions on the CPU) against the plain bf16 route: loss
within 1%, the adapter gradient's relative L2 < 1% (the bounds of the
flagship kernel step in tests/test_torch_gpu.py). Exact: the targets, the
counts, the tree conversions, the report.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pangu_tpu.aux import synthetic_aux_constants as jax_aux
from pangu_tpu.config import pangu_tiny as jax_tiny
from pangu_tpu.interop.npz_io import save_params_npz as jax_save_npz
from pangu_tpu.interop.torch_import import state_dict_from_params
from pangu_tpu.model import PanguModel as JaxPanguModel
from pangu_tpu.train import lora as jlora
from pangu_tpu.train import step as jax_step
from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.config import pangu_tiny
from pangu_tpu_torch.interop.from_jax import (load_jax_lora_opt_state, load_jax_params,
                                              load_lora_npz, lora_tree_from_jax,
                                              lora_tree_to_jax, save_lora_npz)
from pangu_tpu_torch.interop.torch_import import reference_key_map
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.model import attention as tattn
from pangu_tpu_torch.model import blocks as tblocks
from pangu_tpu_torch.ops import fused_mlp as tfm
from pangu_tpu_torch.scripts import lora_tune
from pangu_tpu_torch.scripts import test as port_test_script
from pangu_tpu_torch.train import Batch, make_optimizer
from pangu_tpu_torch.train.lora import (LoraConfig, changed_param_report, count_trainable,
                                        detach_lora, flatten_trainable, init_lora_params,
                                        lora_target_paths, make_lora_eval_step,
                                        make_lora_train_step, merge_params,
                                        unflatten_trainable)
from pangu_tpu_torch.utils.summary import param_count

RTOL = 1e-4
RANK, ALPHA = 4, 8.0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def run():
    cfg = jax_tiny(drop_path_max=0.0)
    m = cfg.model
    jaux = jax_aux(m, cfg.train)
    rng = np.random.default_rng(11)
    arrays = [rng.standard_normal((1,) + s).astype(np.float32) for s in (
        (m.upper_vars, m.levels, m.lat, m.lon), (m.surface_vars, m.lat, m.lon),
        (m.upper_vars, m.levels, m.lat, m.lon), (m.surface_vars, m.lat, m.lon))]
    jmodel = JaxPanguModel(m)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), arrays[0], arrays[1], jaux)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (jnp.asarray(0.02 * rng.standard_normal(x.shape).astype(np.float32))
                         if path[-1].key == "bias" else x), params)
    lcfg = jlora.LoraConfig(rank=RANK, alpha=ALPHA, dropout=0.0)
    trainable = jlora.init_lora_params(params, lcfg, jax.random.PRNGKey(1))
    for ab in trainable["lora"].values():
        ab["b"] = jnp.asarray(0.02 * rng.standard_normal(ab["b"].shape).astype(np.float32))
    opt = jax_step.make_optimizer(cfg)
    batch = jax_step.Batch(*arrays)
    key = jax.random.PRNGKey(3)
    out = {}
    for unmerged in (False, True):
        step = jax.jit(jlora.make_lora_train_step(jmodel, cfg, opt, params, lcfg,
                                                  unmerged=unmerged))
        state = jax_step.TrainState(trainable, opt.init(trainable), jnp.zeros((), jnp.int32))
        s1, loss1 = step(state, batch, jaux, key)
        out[unmerged] = [(float(loss1), _np(s1))]
        if not unmerged:
            s2, loss2 = step(s1, batch, jaux, key)
            out[unmerged].append((float(loss2), _np(s2)))
    tcfg = pangu_tiny(drop_path_max=0.0)
    return SimpleNamespace(
        cfg=cfg, m=m, tcfg=tcfg, arrays=arrays, params=_np(params), trainable=_np(trainable),
        merged=state_dict_from_params(m, _np(jlora.merge_params(params, trainable, lcfg))),
        targets=jlora.lora_target_paths(params, jlora.LoraConfig()),
        count=jlora.count_trainable(trainable), out=out,
        aux=synthetic_aux_constants(tcfg.model, tcfg.train, device="cpu"),
        lcfg=LoraConfig(rank=RANK, alpha=ALPHA, dropout=0.0))


def _rel(got, ref) -> float:
    got, ref = (x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                for x in (got, ref))
    ref = ref.astype(np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _port(run, **model_kw):
    cfg = run.tcfg.replace(model=dataclasses.replace(run.tcfg.model, **model_kw))
    model = PanguModel(cfg.model)
    load_jax_params(model, cfg.model, run.params)
    return cfg, model, model.state_dict(), lora_tree_from_jax(run.m, run.trainable)


def _batch(run):
    return Batch(*(torch.from_numpy(a) for a in run.arrays))


def _assert_tree_matches(tree, jax_state_params, m):
    want = lora_tree_from_jax(m, jax_state_params)
    for key, ab in want["lora"].items():
        for k in ("a", "b"):
            assert _rel(tree["lora"][key][k], ab[k]) < RTOL, (key, k)
    assert sorted(tree["full"]) == sorted(want["full"])
    for key, t in want["full"].items():
        assert _rel(tree["full"][key], t) < RTOL, key


@pytest.mark.parametrize("remat", [False, True])
def test_merged_steps_match_jax(run, remat):
    """One and two merged updates: loss, A, B and the heads."""
    cfg, model, base, tree = _port(run, remat=remat)
    opt = make_optimizer(flatten_trainable(tree).values(), cfg)
    step = make_lora_train_step(model, cfg, opt, base, run.lcfg, tree)
    for loss_ref, state_ref in run.out[False]:
        loss = step(_batch(run), run.aux)
        assert abs(float(loss) - loss_ref) / abs(loss_ref) < RTOL
        _assert_tree_matches(tree, state_ref.params, run.m)


def test_unmerged_step_at_dropout_0_matches_jax(run):
    cfg, model, base, tree = _port(run)
    opt = make_optimizer(flatten_trainable(tree).values(), cfg)
    step = make_lora_train_step(model, cfg, opt, base, run.lcfg, tree, unmerged=True)
    loss = step(_batch(run), run.aux, torch.Generator().manual_seed(0))
    loss_ref, state_ref = run.out[True][0]
    assert abs(float(loss) - loss_ref) / abs(loss_ref) < RTOL
    _assert_tree_matches(tree, state_ref.params, run.m)


def test_only_adapters_and_heads_train(run):
    """The base stays as it was; the report names the targets and the heads."""
    cfg, model, base, tree = _port(run)
    before = {k: v.clone() for k, v in base.items()}
    opt = make_optimizer(flatten_trainable(tree).values(), cfg)
    make_lora_train_step(model, cfg, opt, base, run.lcfg, tree)(_batch(run), run.aux)
    assert all(torch.equal(before[k], base[k]) for k in before)
    assert all(p.grad is None for p in model.parameters() if not p.requires_grad)
    changed = changed_param_report(before, merge_params(before, tree, run.lcfg))
    assert sorted(changed) == sorted(lora_target_paths(before, run.lcfg) + list(tree["full"]))


def test_targets_map_one_to_one_onto_the_jax_targets(run):
    by_path = {path: ref for ref, path, _ in reference_key_map(run.m)}
    jax_keys = [by_path[p[1:]] for p in run.targets]
    model = PanguModel(run.tcfg.model)
    port = lora_target_paths(model, LoraConfig())
    assert len(set(jax_keys)) == len(jax_keys) and sorted(jax_keys) == sorted(port)
    assert any(k.startswith("downsample.") for k in port)
    assert {"upsample.linear1.weight", "upsample.linear2.weight"} <= set(port)
    assert not any(k.startswith(("_input_layer", "_output_layer")) for k in port)


def test_counts_match_jax(run):
    cfg, model, base, tree = _port(run)
    assert count_trainable(tree) == run.count
    fresh = init_lora_params(base, run.lcfg, torch.Generator().manual_seed(1))
    assert count_trainable(fresh) == run.count
    assert param_count(base) == param_count(model)
    assert all(float(ab["b"].detach().abs().max()) == 0 for ab in fresh["lora"].values())
    a = torch.cat([ab["a"].detach().flatten() for ab in fresh["lora"].values()])
    assert abs(float(a.std()) * RANK ** 0.5 - 1.0) < 0.05  # A ~ N(0, 1/r)


def test_merge_params_matches_jax(run):
    _, _, base, tree = _port(run)
    merged = merge_params(base, tree, run.lcfg)
    assert sorted(merged) == sorted(run.merged)
    for k, ref in run.merged.items():
        assert _rel(merged[k], ref) < 1e-6, k


def test_tree_conversion_round_trips(run, tmp_path):
    tree = lora_tree_from_jax(run.m, run.trainable)
    back = lora_tree_to_jax(run.m, tree)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(run.trainable)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(run.trainable)):
        assert np.array_equal(a, b)
    assert sorted(unflatten_trainable(flatten_trainable(tree))["lora"]) == sorted(tree["lora"])
    # a file written by either package loads (the JAX writer nests the joined paths)
    jax_save_npz(str(tmp_path / "jax.npz"), run.trainable)
    save_lora_npz(str(tmp_path / "port.npz"), run.m, tree)
    for name in ("jax.npz", "port.npz"):
        got = flatten_trainable(load_lora_npz(str(tmp_path / name), run.m, device="cpu"))
        for k, t in flatten_trainable(tree).items():
            assert torch.equal(got[k], t.detach()), (name, k)


def test_load_lora_npz_defaults_to_the_card(run, tmp_path):
    """Without a device the tree goes to the card, as the aux constants do:
    on a host without one the load raises instead of quietly returning host
    tensors."""
    path = str(tmp_path / "port.npz")
    save_lora_npz(path, run.m, lora_tree_from_jax(run.m, run.trainable))
    if torch.cuda.is_available():
        got = flatten_trainable(load_lora_npz(path, run.m))
        assert all(t.is_cuda for t in got.values())
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            load_lora_npz(path, run.m)


def test_jax_adam_state_resumes_in_the_port(run):
    """Step 2 from JAX's step-1 tree and Adam state equals JAX's step 2."""
    cfg = jax_tiny(drop_path_max=0.0)
    jmodel = JaxPanguModel(cfg.model)
    opt = jax_step.make_optimizer(cfg)
    lcfg = jlora.LoraConfig(rank=RANK, alpha=ALPHA, dropout=0.0)
    state = jax_step.TrainState(run.trainable, opt.init(run.trainable),
                                jnp.zeros((), jnp.int32))
    params = jax.tree_util.tree_map(jnp.asarray, run.params)
    step = jax.jit(jlora.make_lora_train_step(jmodel, cfg, opt, params, lcfg))
    s1, _ = step(state, jax_step.Batch(*run.arrays), jax_aux(cfg.model, cfg.train),
                 jax.random.PRNGKey(3))
    s1 = _np(s1)
    tcfg, model, base, _ = _port(run)
    tree = lora_tree_from_jax(run.m, s1.params)
    topt = make_optimizer(flatten_trainable(tree).values(), tcfg)
    load_jax_lora_opt_state(topt, tree, run.m, s1.opt_state)
    loss = make_lora_train_step(model, tcfg, topt, base, run.lcfg, tree)(_batch(run), run.aux)
    loss_ref, s2 = run.out[False][1]
    assert abs(float(loss) - loss_ref) / abs(loss_ref) < RTOL
    _assert_tree_matches(tree, s2.params, run.m)


def _counting(monkeypatch):
    calls = {"attention": 0, "residual": 0, "mlp_tail": 0}

    def wrap(module, name, key):
        real = getattr(module, name)

        def counted(*a, **k):
            calls[key] += 1
            return real(*a, **k)

        monkeypatch.setattr(module, name, counted)

    wrap(tattn, "fused_block_attention", "attention")
    wrap(tblocks, "fused_residual_postnorm", "residual")
    wrap(tfm, "fused_mlp_postnorm", "mlp_tail")
    return calls


def test_merged_form_keeps_the_kernel_route_and_unmerged_leaves_it(run, monkeypatch):
    """On the bf16 kernel route (the kernels' plain versions on the CPU):
    merged adapters run K2, K4 (twice: the remat recompute) and K6 per
    block; unmerged adapters only K4; the merged step's loss and adapter
    gradients are within phase 8's bounds of the plain bf16 step."""
    calls = _counting(monkeypatch)
    blocks = sum(run.tcfg.model.depths)
    grads = {}
    for label, kernel, unmerged in (("merged", True, False), ("unmerged", True, True),
                                    ("plain", False, False)):
        cfg, model, base, tree = _port(run, compute_dtype="bfloat16",
                                       use_pallas_attention=kernel, remat=True)
        opt = make_optimizer(flatten_trainable(tree).values(), cfg)
        calls.update(dict.fromkeys(calls, 0))
        loss = make_lora_train_step(model, cfg, opt, base, run.lcfg, tree, unmerged=unmerged)(
            _batch(run), run.aux, torch.Generator().manual_seed(0))
        grads[label] = (float(loss), {k: t.grad.clone()
                                      for k, t in flatten_trainable(tree).items()})
        want = ({"attention": blocks, "residual": 2 * blocks, "mlp_tail": blocks}
                if not unmerged else {"attention": 0, "residual": 2 * blocks, "mlp_tail": 0})
        if not kernel:
            want = dict.fromkeys(calls, 0)
        assert calls == want, (label, calls)
    (loss_k, g_k), (loss_p, g_p) = grads["merged"], grads["plain"]
    assert abs(loss_k - loss_p) / abs(loss_p) < 0.01
    d2 = sum(float((g_k[k] - g_p[k]).pow(2).sum()) for k in g_p)
    n2 = sum(float(g.pow(2).sum()) for g in g_p.values())
    assert (d2 / n2) ** 0.5 < 0.01


def test_eval_step_merges_and_detach_restores_the_base(run):
    cfg, model, base, tree = _port(run)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss = make_lora_eval_step(model, cfg, base, run.lcfg, tree)(_batch(run), run.aux)
    ref = PanguModel(cfg.model)
    ref.load_state_dict(merge_params(before, tree, run.lcfg))
    from pangu_tpu_torch.train.step import make_eval_step

    assert _rel(loss, make_eval_step(ref, cfg)(_batch(run), run.aux)) < 1e-6
    detach_lora(model)
    assert all(m.__dict__.get("lora") is None for m in model.modules())


def _script_argv(tmp_path):
    return ["--preset", "tiny", "--out", str(tmp_path), "--set", "data.store=synthetic",
            "--set", "data.train_start=20180101", "--set", "data.train_end=20180104",
            "--set", "data.val_start=20180105", "--set", "data.val_end=20180107",
            "--set", "data.test_start=20180108", "--set", "data.test_end=20180110",
            "--set", "data.prefetch=0", "--set", "train.epochs=2",
            "--set", "train.batch_size=1"]


@pytest.mark.parametrize("flags", [[], ["--unmerged"]])
def test_lora_tune_script_runs_end_to_end_on_the_cpu(tmp_path, flags):
    argv = _script_argv(tmp_path) + ["--rank", "4", "--alpha", "8"]
    loss = lora_tune.main(argv + flags, device="cpu")
    out = tmp_path / "lora" / "24"
    assert np.isfinite(loss)
    assert sorted(p.name for p in (out / "models").iterdir()) == ["best", "train_1", "train_2"]
    assert (out / "lora_best.npz").is_file() and len(list((out / "csv").iterdir())) == 14
    again = lora_tune.main(argv + flags + ["--resume", "--set", "train.epochs=3"], device="cpu")
    assert np.isfinite(again) and (out / "models" / "train_3").is_dir()


def test_test_script_merges_lora_weights(run, tmp_path):
    """``test --lora-weights`` scores the merged weights: the same test loss
    as the merged weights written out and scored as plain weights."""
    from pangu_tpu_torch.interop.from_jax import save_params_npz

    cfg, model, base, tree = _port(run)
    weights, lora = str(tmp_path / "w.npz"), str(tmp_path / "lora.npz")
    save_params_npz(weights, model)
    save_lora_npz(lora, run.m, tree)
    argv = ["--preset", "tiny", "--weights", weights, "--set", "data.store=synthetic",
            "--set", "data.test_start=20180101", "--set", "data.test_end=20180103",
            "--set", "data.prefetch=0"]
    got = port_test_script.main(argv + ["--out", str(tmp_path / "a"), "--lora-weights", lora],
                                device="cpu")
    model.load_state_dict(merge_params(base, tree, LoraConfig()))
    save_params_npz(weights, model)
    want = port_test_script.main(argv + ["--out", str(tmp_path / "b")], device="cpu")
    assert got == want
