"""The kernels of the port's train-step A/B routes against the JAX package.

``pangu_tpu_torch.ops.fused_mlp.fused_mlp`` is the raw MLP K8 with its
backward K9 (the ``_POSTNORM_FUSION = False`` route),
``pangu_tpu_torch.ops.fused_block_train.fused_earth_block_train`` the
training block K11 with its flash backward K12 (the ``_TRAIN_FUSION = True``
route). On the CPU the wrappers run the plain versions, which are held here
to

  * the interpreted Pallas kernels (bf16, the kernels' own rounding points):
    ``fused_mlp`` and ``_raw_bwd`` (all five outputs),
    ``fused_earth_block_train`` and ``_backward_pallas`` called directly (all
    sixteen outputs); atol 0.04 for values and 0.05 for gradients after
    scaling by max(1, max|ref|), the bounds of tests/test_kernel_interpret.py
    (bf16 operands, f32 sums taken in another order; the Pallas bodies' A&S
    erf is within 1.5e-7 of the exact erf the plain versions use);
  * in f32, the JAX XLA formulas ``_raw_xla`` and ``_xla_block_train`` at
    Precision.HIGHEST and their ``jax.vjp``: max|d| / max|ref| < 1e-4, the
    golden guard's bound (both sides true f32, only summation order
    differs);
  * torch autograd of the plain forward (f32): the explicit backwards are the
    same gradients, max|d| / max|ref| < 1e-4 -- the wrappers' autograd (the
    CPU route) too, with no kernel launch.

The CUDA kernels are compared with the plain versions on the card by
tests/test_torch_gpu.py. The A/B script's variant handling
is checked at the end.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pangu_tpu.ops import fused_block_train as fbt
from pangu_tpu.ops import fused_mlp as fm
from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.config import pangu_tiny
from pangu_tpu_torch.interop.from_jax import init_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.ops import fused_block_train as tfbt
from pangu_tpu_torch.ops import fused_mlp as tfm
from pangu_tpu_torch.scripts import bench_train_ab
from pangu_tpu_torch.train import Batch, make_optimizer, make_train_step
from test_torch_ops import _assert_scaled_close, _both, _np_inputs, interpret_tpu_route  # noqa: F401
from test_torch_train_ops import _cotangent, _mlp_args, _mlp_both, _np, _rel

HIGHEST = jax.lax.Precision.HIGHEST
RAW_NAMES = ("dx", "dw1", "db1", "dw2", "db2")


# ---- K8 / K9: the raw MLP --------------------------------------------------------


def _raw_to_port_layout(jax_grads):
    dx, dw1, db1, dw2, db2 = (_np(g) for g in jax_grads)
    return dx, dw1.T, db1.reshape(-1), dw2.T, db2.reshape(-1)


def test_raw_mlp_plain_bf16_matches_interpreted_pallas(interpret_tpu_route):
    """K8 and K9's plain versions against the interpreted Pallas kernels; 2,904
    rows run 3 grid steps of 968, so the weight-grad sums carry over steps."""
    jx, tx = _mlp_both(_mlp_args(51, rows=2904), bf16=True)
    ref = fm.fused_mlp(*jx[:5])
    got = tfm.fused_mlp(*tx[:5])  # CPU: the plain version
    assert got.dtype == torch.bfloat16
    _assert_scaled_close(_np(got), _np(ref), atol=0.04)

    jg, tg = _cotangent(52, (2904, 16), bf16=True)
    ref = _raw_to_port_layout(fm._raw_bwd(tuple(jx[:5]), jg))
    got = tfm.fused_mlp_bwd(tx[0], tg, *tx[1:5])
    for name, g, r in zip(RAW_NAMES, got, ref):
        assert g.dtype == torch.bfloat16, name
        _assert_scaled_close(_np(g), r, atol=0.05)


def test_raw_mlp_plain_f32_matches_xla_and_vjp():
    jx, tx = _mlp_both(_mlp_args(53), bf16=False)
    ref, vjp = jax.vjp(lambda *a: fm._raw_xla(*a, precision=HIGHEST), *jx[:5])
    got = tfm.fused_mlp_reference(*tx[:5])
    assert _rel(got, ref) < 1e-4
    jg, tg = _cotangent(54, tuple(got.shape), bf16=False)
    got_grads = tfm.fused_mlp_bwd_reference(tx[0], tg, *tx[1:5])
    for name, g, r in zip(RAW_NAMES, got_grads, _raw_to_port_layout(vjp(jg))):
        assert _rel(g, r) < 1e-4, name


def test_raw_mlp_bwd_plain_is_autograd_of_plain_forward():
    """The explicit K9 formula and the wrapper's autograd (the CPU route, on a
    (..., C) input) both equal torch autograd of the plain forward, f32."""
    _, tx = _mlp_both(_mlp_args(55), bf16=False)
    _, tg = _cotangent(56, (4, 24, 16), bf16=False)
    leaves = [t.clone().requires_grad_(True) for t in tx[:5]]
    tfm.fused_mlp_reference(*leaves).backward(tg.reshape(96, 16))
    explicit = tfm.fused_mlp_bwd_reference(tx[0], tg.reshape(96, 16), *tx[1:5])
    wrapped = [t.clone().requires_grad_(True) for t in [tx[0].reshape(4, 24, 16)] + tx[1:5]]
    before = (tfm.RAW_FWD_LAUNCHES, tfm.RAW_BWD_LAUNCHES)
    tfm.fused_mlp(*wrapped).backward(tg)
    assert (tfm.RAW_FWD_LAUNCHES, tfm.RAW_BWD_LAUNCHES) == before  # CPU: no kernel
    for name, a, e, w in zip(RAW_NAMES, leaves, explicit, wrapped):
        assert _rel(e, a.grad) < 1e-4, name
        assert w.grad.shape == w.shape and _rel(w.grad.reshape(a.shape), a.grad) < 1e-4, name


def test_raw_mlp_wrapper_rejects_bad_arguments():
    _, tx = _mlp_both(_mlp_args(57), bf16=False)
    x, w1, b1, w2, b2 = tx[:5]
    with pytest.raises(ValueError):
        tfm.fused_mlp(x, w1[:, :8], b1, w2, b2)
    with pytest.raises(ValueError):
        tfm.fused_mlp(x, w1, b1, w2, b2[:8])
    with pytest.raises(ValueError):  # weights in x's dtype
        tfm.fused_mlp(x, w1.to(torch.bfloat16), b1, w2, b2)
    with pytest.raises(ValueError):  # g must be x's shape and dtype
        tfm.fused_mlp_bwd(x, x[:, :8], w1, b1, w2, b2)
    with pytest.raises(ValueError):
        tfm.fused_mlp_bwd(x, x.to(torch.bfloat16), w1, b1, w2, b2)


# ---- K11 / K12: the training block -----------------------------------------------


def _block_args(seed, bf16, masked):
    """Block inputs for JAX and the port (z = 4: two window types, w = 24: two
    lon windows each, b = 2), and per-sample branch scales s1 != s2 (one
    sample's MLP branch dropped)."""
    args, statics = _np_inputs(seed, z=4, masked=masked)
    jx, tx = _both(args, dtype_bf16=bf16)
    s1 = np.array([[1.25], [0.8]], np.float32)
    s2 = np.array([[0.0], [1.25]], np.float32)
    return (jx + [jnp.asarray(s1), jnp.asarray(s2)],
            tx + [torch.from_numpy(s1), torch.from_numpy(s2)], statics)


def _block_to_port_layout(jax_grads):
    """JAX's 16 block grads (Dense (in, out) kernels, (1, n) biases) -> the
    port's nn.Linear layout."""
    g = [_np(a) for a in jax_grads]
    for i in (1, 3, 8, 10):  # dwqkv, dwproj, dw1, dw2
        g[i] = g[i].T
    for i in (2, 4, 6, 7, 9, 11, 12, 13):  # the biases and LayerNorm grads
        g[i] = g[i].reshape(-1)
    return g


@pytest.mark.parametrize("masked", [False, True])
def test_block_train_plain_bf16_matches_interpreted_pallas(interpret_tpu_route, masked):
    jx, tx, statics = _block_args(61, True, masked)
    ref = fbt.fused_earth_block_train(*jx, *statics)
    got = tfbt.fused_earth_block_train(*tx, *statics)  # CPU: the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    _assert_scaled_close(_np(got), _np(ref), atol=0.04)


@pytest.mark.parametrize("masked", [False, True])
def test_block_train_bwd_plain_bf16_matches_interpreted_pallas(interpret_tpu_route, masked):
    """All sixteen outputs of the flash backward, ``_backward_pallas`` called
    directly: two samples, two window types and two lon windows each, so the
    dbias, weight-grad and ds sums run over several terms."""
    jx, tx, (window, heads, scale) = _block_args(62, True, masked)
    jg, tg = _cotangent(63, tuple(jx[0].shape), bf16=True)
    ref = _block_to_port_layout(fbt._backward_pallas(*jx, jg, window, heads, scale))
    got = tfbt.fused_earth_block_train_bwd(*tx, tg, window, heads, scale)
    assert len(got) == len(tfbt.GRAD_NAMES) == 16
    for name, g, r, arg in zip(tfbt.GRAD_NAMES, got, ref, [tx[0]] + tx[1:6] + tx[7:]):
        assert g.dtype == arg.dtype and tuple(g.shape) == tuple(arg.shape), name
        _assert_scaled_close(_np(g), r, atol=0.05)


@pytest.mark.parametrize("masked", [False, True])
def test_block_train_plain_f32_matches_xla_and_vjp(masked):
    jx, tx, (window, heads, scale) = _block_args(64, False, masked)
    mask = jx[6]

    def f(x, wqkv, bqkv, wproj, bproj, bias, l1s, l1b, w1, b1, w2, b2, l2s, l2b, s1, s2):
        return fbt._xla_block_train(x, wqkv, bqkv, wproj, bproj, bias, mask, l1s, l1b,
                                    w1, b1, w2, b2, l2s, l2b, s1, s2, window, heads, scale,
                                    precision=HIGHEST)

    ref, vjp = jax.vjp(f, *jx[:6], *jx[7:])
    got = tfbt.fused_earth_block_train_reference(*tx, window, heads, scale)
    assert _rel(got, ref) < 1e-4
    jg, tg = _cotangent(65, tuple(got.shape), bf16=False)
    ref_grads = _block_to_port_layout(vjp(jg))
    got_grads = tfbt.fused_earth_block_train_bwd_reference(*tx, tg, window, heads, scale)
    for name, g, r in zip(tfbt.GRAD_NAMES, got_grads, ref_grads):
        assert _rel(g, r) < 1e-4, name


@pytest.mark.parametrize("masked", [False, True])
def test_block_train_bwd_plain_is_autograd_of_plain_forward(masked):
    """The explicit K12 formula and the wrapper's autograd (the CPU route)
    both equal torch autograd of the plain forward, f32; the mask gets no
    gradient."""
    _, tx, (window, heads, scale) = _block_args(66, False, masked)
    mask = tx[6]
    diff = tx[:6] + tx[7:]

    def leaves():
        return [t.clone().requires_grad_(True) for t in diff]

    def call(fn, ls):
        return fn(*ls[:6], mask, *ls[6:], window, heads, scale)

    auto = leaves()
    y = call(tfbt.fused_earth_block_train_reference, auto)
    _, tg = _cotangent(67, tuple(y.shape), bf16=False)
    y.backward(tg)
    explicit = tfbt.fused_earth_block_train_bwd_reference(*tx, tg, window, heads, scale)
    wrapped = leaves()
    before = (tfbt.FWD_LAUNCHES, tfbt.BWD_LAUNCHES)
    call(tfbt.fused_earth_block_train, wrapped).backward(tg)
    assert (tfbt.FWD_LAUNCHES, tfbt.BWD_LAUNCHES) == before  # CPU: no kernel
    for name, a, e, w in zip(tfbt.GRAD_NAMES, auto, explicit, wrapped):
        assert _rel(e, a.grad) < 1e-4, name
        assert _rel(w.grad, a.grad) < 1e-4, name


def test_block_train_wrapper_rejects_bad_arguments():
    _, tx, statics = _block_args(68, True, True)
    bad = list(tx)
    bad[5] = bad[5].to(torch.bfloat16)  # the earth bias must be f32
    with pytest.raises(ValueError):
        tfbt.fused_earth_block_train(*bad, *statics)
    for s in (torch.ones(3, 1), torch.ones(2, 2), torch.ones(2, 1, dtype=torch.bfloat16)):
        with pytest.raises(ValueError):  # per-sample (B,) or (B, 1) f32
            tfbt.fused_earth_block_train(*tx[:15], s, tx[16], *statics)
    with pytest.raises(ValueError):  # g must be x's shape and dtype
        tfbt.fused_earth_block_train_bwd(*tx, tx[0].float(), *statics)


# ---- the A/B script --------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(bench_train_ab.REFUSED))
def test_ab_script_refuses_what_the_port_does_not_run(name):
    with pytest.raises(ValueError, match="not run by the port"):
        bench_train_ab.main([name])
    with pytest.raises(ValueError):
        bench_train_ab.variant_config(name)


@pytest.mark.parametrize("name,flags", [("save_attn", (True, True)),
                                        ("save_attn_mlp", (True, True))])
def test_ab_script_remat_variants_set_the_flags_as_the_jax_script(name, flags):
    """The JAX script sets remat_save_attention (and remat_save_mlp) True on
    pangu_pretrain's defaults (scripts/bench_train_ab.py:57-61), which keep
    both already; the port's variants do the same, remat on."""
    cfg = bench_train_ab.variant_config(name).model
    assert (cfg.remat_save_attention, cfg.remat_save_mlp) == flags
    assert (cfg.remat, cfg.compute_dtype, cfg.use_pallas_attention) == (True, "bfloat16", True)
    assert name in bench_train_ab.VARIANTS and name not in bench_train_ab.REFUSED


def test_ab_script_bf16_grads_variant_runs_the_base_route_with_bf16_grads(monkeypatch):
    """``bf16_grads`` is ``base``'s config and flags with
    ``grads_dtype="bfloat16"``, as the JAX script sets it
    (scripts/bench_train_ab.py:62-65); a tiny step under its flags keeps f32
    gradients within the bf16 bounds of the f32-gradient step."""
    cfg = bench_train_ab.variant_config("bf16_grads")
    assert cfg.model == dataclasses.replace(bench_train_ab.variant_config("base").model,
                                            grads_dtype="bfloat16")
    assert "bf16_grads" in bench_train_ab.VARIANTS and "bf16_grads" not in bench_train_ab.REFUSED
    grads = {}
    for variant in ("base", "bf16_grads"):
        with bench_train_ab.variant_flags(variant):
            tcfg = pangu_tiny(compute_dtype="bfloat16", use_pallas_attention=True, remat=True,
                              drop_path_max=0.0,
                              grads_dtype=bench_train_ab.variant_config(variant).model.grads_dtype)
            model = PanguModel(tcfg.model)
            init_params(model, seed=0)
            aux = synthetic_aux_constants(tcfg.model, tcfg.train, device="cpu")
            rng = np.random.default_rng(3)
            m = tcfg.model
            fields = [torch.from_numpy(rng.standard_normal((1,) + shape).astype(np.float32))
                      for shape in ((m.upper_vars, m.levels, m.lat, m.lon),
                                    (m.surface_vars, m.lat, m.lon))]
            make_train_step(model, tcfg, make_optimizer(model, tcfg))(Batch(*fields, *fields),
                                                                      aux)
            grads[variant] = {k: p.grad for k, p in model.named_parameters()}
    num = den = 0.0
    for k, ref in grads["base"].items():
        got = grads["bf16_grads"][k]
        assert got.dtype == torch.float32
        scale = max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) / scale < 0.05, k
        num += float(((got - ref) ** 2).sum())
        den += float((ref ** 2).sum())
    assert (num / den) ** 0.5 < 0.05


def test_ab_script_sets_and_restores_every_flag():
    flags = lambda: (tfbt._TRAIN_FUSION, tfm._POSTNORM_FUSION)  # noqa: E731
    assert flags() == (False, True)  # the JAX package's defaults
    want = {"base": (False, True), "noremat": (False, True), "fused_block": (True, True),
            "unfused_block": (False, True), "unfused_tail": (False, False),
            "save_attn": (False, True), "save_attn_mlp": (False, True),
            "bf16_grads": (False, True)}
    for name in bench_train_ab.VARIANTS:
        with bench_train_ab.variant_flags(name):
            assert flags() == want[name], name
        assert flags() == (False, True), name
    with pytest.raises(RuntimeError):
        with bench_train_ab.variant_flags("unfused_tail"):
            raise RuntimeError("a failure inside the variant")
    assert flags() == (False, True)
    with pytest.raises(ValueError):
        bench_train_ab.main(["base", "typo"])
    assert not bench_train_ab.variant_config("noremat").model.remat
    cfg = bench_train_ab.variant_config("fused_block").model
    assert (cfg.remat, cfg.compute_dtype, cfg.use_pallas_attention, cfg.dims) == (
        True, "bfloat16", True, (192, 384, 384, 192))
