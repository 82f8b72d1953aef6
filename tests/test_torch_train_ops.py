"""The port's training kernels' plain versions against the JAX package.

``pangu_tpu_torch.ops.fused_block_attention`` holds K2 (the training
attention) with its flash backward K3, ``pangu_tpu_torch.ops.fused_epilogue``
K4 (the post-norm residual) with its backward K5, ``pangu_tpu_torch.ops.fused_mlp``
K6 (the MLP tail) with its backward K7. On the CPU the wrappers run the plain
versions, which are held here to

  * the interpreted Pallas kernels (bf16, the kernels' own rounding points):
    ``fused_block_attention``, ``_backward_pallas`` called directly (all six
    outputs), ``fused_residual_postnorm`` and ``_res_bwd``,
    ``fused_mlp_postnorm`` and ``_postnorm_bwd`` (all eight outputs); atol 0.04 for
    values and 0.05 for gradients after scaling by max(1, max|ref|), the
    bounds of tests/test_kernel_interpret.py (bf16 operands, f32 sums taken
    in another order);
  * in f32, the JAX XLA formulas at Precision.HIGHEST and their ``jax.vjp``:
    max|d| / max|ref| < 1e-4, the golden guard's bound;
  * torch autograd of the plain forward (f32): the explicit backwards are the
    same gradients, max|d| / max|ref| < 1e-4.

The CUDA kernels are compared with the plain versions on the card by
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pangu_tpu.ops import fused_block_attention as fba
from pangu_tpu.ops import fused_epilogue as fep
from pangu_tpu.ops import fused_mlp as fm
from pangu_tpu_torch.ops import fused_block_attention as tfba
from pangu_tpu_torch.ops import fused_epilogue as tfep
from pangu_tpu_torch.ops import fused_mlp as tfm
from test_torch_ops import _assert_scaled_close, _both, _np_inputs, interpret_tpu_route  # noqa: F401

HIGHEST = jax.lax.Precision.HIGHEST
NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) else t.float().numpy()


def _rel(got, ref) -> float:
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _to_port_layout(jax_grads):
    """JAX (dx, dwqkv (C, 3C), dbqkv, dwproj (C, C), dbproj, dbias) -> the
    port's nn.Linear layout (dwqkv (3C, C), dwproj (C_out, C_in))."""
    dx, dwqkv, dbqkv, dwproj, dbproj, dbias = (_np(g) for g in jax_grads)
    return dx, dwqkv.T, dbqkv.reshape(-1), dwproj.T, dbproj.reshape(-1), dbias


def _attention_args(seed, dtype_bf16, masked, **kw):
    args, statics = _np_inputs(seed, masked=masked, **kw)
    jx, tx = _both(args, dtype_bf16=dtype_bf16)
    return jx[:7], tx[:7], statics


def _cotangent(seed, shape, bf16):
    g = (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)
    if not bf16:
        return jnp.asarray(g), torch.from_numpy(g)
    j = jnp.asarray(g, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


# ---- K2 / K3: the training attention ------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_attention_plain_bf16_matches_interpreted_pallas(interpret_tpu_route, masked):
    jx, tx, statics = _attention_args(11, True, masked, z=4)
    ref = np.asarray(fba.fused_block_attention(*jx, None, None, *statics), np.float32)
    got = tfba.fused_block_attention(*tx, None, None, *statics)  # CPU: the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    _assert_scaled_close(got.float().numpy(), ref, atol=0.04)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_bwd_plain_bf16_matches_interpreted_pallas(interpret_tpu_route, masked):
    """All six outputs of the flash backward, ``_backward_pallas`` called
    directly: z = 4 gives two window types, w = 24 two lon windows each, b = 2
    two samples, so the dbias and weight-grad sums run over several terms."""
    jx, tx, (window, heads, scale) = _attention_args(12, True, masked, z=4)
    x, wqkv, bqkv, wproj, _, bias, mask = jx
    jg, tg = _cotangent(13, x.shape, bf16=True)
    ref = _to_port_layout(fba._backward_pallas(x, wqkv, bqkv, wproj, bias, mask, jg,
                                               window, heads, scale))
    x, wqkv, bqkv, wproj, _, bias, mask = tx
    got = tfba.fused_block_attention_bwd_reference(x, wqkv, bqkv, wproj, bias, mask, tg,
                                                   window, heads, scale)
    for name, g, r in zip(NAMES, got, ref):
        want = torch.float32 if name == "dbias" else torch.bfloat16
        assert g.dtype == want, name
        _assert_scaled_close(_np(g), r, atol=0.05)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_plain_f32_matches_xla_and_vjp(masked):
    jx, tx, (window, heads, scale) = _attention_args(14, False, masked, z=4)
    x, wqkv, bqkv, wproj, bproj, bias, mask = jx

    def f(x, wqkv, bqkv, wproj, bproj, bias):
        return fba._xla_reference(x, wqkv, bqkv, wproj, bproj, bias, mask, window, heads,
                                  scale, precision=HIGHEST)

    ref, vjp = jax.vjp(f, x, wqkv, bqkv, wproj, bproj, bias)
    got = tfba.fused_block_attention_reference(*tx, window, heads, scale)
    assert _rel(got, ref) < 1e-4
    jg, tg = _cotangent(15, x.shape, bf16=False)
    ref_grads = _to_port_layout(vjp(jg))
    x, wqkv, bqkv, wproj, _, bias, mask = tx
    got_grads = tfba.fused_block_attention_bwd_reference(x, wqkv, bqkv, wproj, bias, mask, tg,
                                                         window, heads, scale)
    for name, g, r in zip(NAMES, got_grads, ref_grads):
        assert _rel(g, r) < 1e-4, name


@pytest.mark.parametrize("masked", [False, True])
def test_attention_bwd_plain_is_autograd_of_plain_forward(masked):
    """The explicit flash backward and the autograd Function (the CPU route of
    the wrapper) both equal torch autograd of the plain forward, f32."""
    _, tx, (window, heads, scale) = _attention_args(16, False, masked, z=4)
    mask = tx[6]
    leaves = [t.clone().requires_grad_(True) for t in tx[:6]]
    y = tfba.fused_block_attention_reference(*leaves, mask, window, heads, scale)
    _, tg = _cotangent(17, tuple(y.shape), bf16=False)
    y.backward(tg)
    auto = [leaf.grad for leaf in leaves]
    x, wqkv, bqkv, wproj, _, bias, _ = tx
    explicit = tfba.fused_block_attention_bwd_reference(x, wqkv, bqkv, wproj, bias, mask, tg,
                                                        window, heads, scale)
    leaves2 = [t.clone().requires_grad_(True) for t in tx[:6]]
    before = (tfba.ATTN_FWD_LAUNCHES, tfba.ATTN_BWD_LAUNCHES)
    tfba.fused_block_attention(*leaves2, mask, None, None, window, heads, scale).backward(tg)
    assert (tfba.ATTN_FWD_LAUNCHES, tfba.ATTN_BWD_LAUNCHES) == before  # CPU: no kernel
    for name, a, e, w in zip(NAMES, auto, explicit, leaves2):
        assert _rel(e, a) < 1e-4, name
        assert _rel(w.grad, a) < 1e-4, name


def test_attention_wrapper_rejects_epilogue_mode_and_bad_arguments():
    """The LN-epilogue mode is ported: it rejects LayerNorm parameters of the
    wrong shape or dtype and one parameter without the other."""
    _, tx, statics = _attention_args(18, True, True)
    for ln in ((torch.ones(15), torch.zeros(15)), (torch.ones(16, dtype=torch.bfloat16),
                                                   torch.zeros(16)), (torch.ones(16), None)):
        with pytest.raises(ValueError):
            tfba.fused_block_attention(*tx, *ln, *statics)
    bad = list(tx)
    bad[5] = bad[5].to(torch.bfloat16)  # the earth bias must be f32
    with pytest.raises(ValueError):
        tfba.fused_block_attention(*bad, None, None, *statics)
    x, wqkv, bqkv, wproj, _, bias, mask = tx
    with pytest.raises(ValueError):  # g must be x's shape and dtype
        tfba.fused_block_attention_bwd(x, wqkv, bqkv, wproj, bias, mask, x.float(), *statics)
    with pytest.raises(ValueError):
        tfba.fused_block_attention_bwd(x, wqkv, bqkv, wproj, bias.to(torch.bfloat16), mask, x,
                                       *statics)


# ---- K4 / K5: the post-norm residual ------------------------------------------


def _residual_args(seed, rows=64, c=16):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((rows, c)) * 0.1).astype(np.float32),
            (rng.standard_normal((rows, c)) * 0.1).astype(np.float32),
            (1.0 + rng.standard_normal(c) * 0.1).astype(np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32),
            rng.uniform(0.5, 1.5, (rows, 1)).astype(np.float32))


def test_residual_plain_bf16_matches_interpreted_pallas(interpret_tpu_route):
    short, act, ln_s, ln_b, s = _residual_args(21)
    jshort, jact = jnp.asarray(short, jnp.bfloat16), jnp.asarray(act, jnp.bfloat16)
    tshort = torch.from_numpy(np.array(jshort.astype(jnp.float32))).to(torch.bfloat16)
    tact = torch.from_numpy(np.array(jact.astype(jnp.float32))).to(torch.bfloat16)
    ref = fep.fused_residual_postnorm(jshort, jact, jnp.asarray(ln_s), jnp.asarray(ln_b),
                                      jnp.asarray(s))
    got = tfep.fused_residual_postnorm(tshort, tact, torch.from_numpy(ln_s),
                                       torch.from_numpy(ln_b), torch.from_numpy(s))
    assert got.dtype == torch.bfloat16
    _assert_scaled_close(_np(got), _np(ref), atol=0.04)

    jg, tg = _cotangent(22, short.shape, bf16=True)
    _, jda, jdls, jdlb, jds = fep._res_bwd(
        (jact, jnp.asarray(ln_s), jnp.asarray(ln_b), jnp.asarray(s)), jg)
    da, dls, dlb, ds = tfep.fused_residual_postnorm_bwd_reference(
        tact, tg, torch.from_numpy(ln_s), torch.from_numpy(ln_b), torch.from_numpy(s[:, 0]))
    assert da.dtype == torch.bfloat16
    for name, g, r in (("da", da, jda), ("dgamma", dls, jdls), ("dbeta", dlb, jdlb),
                       ("ds", ds, _np(jds)[:, 0])):
        _assert_scaled_close(_np(g), _np(r), atol=0.05)


def test_residual_plain_f32_matches_xla_and_vjp():
    short, act, ln_s, ln_b, s = _residual_args(23)
    jargs = [jnp.asarray(a) for a in (short, act, ln_s, ln_b, s)]
    ref, vjp = jax.vjp(fep._res_xla, *jargs)
    targs = [torch.from_numpy(a) for a in (short, act, ln_s, ln_b)]
    got = tfep.fused_residual_postnorm_reference(*targs, torch.from_numpy(s[:, 0]))
    assert _rel(got, ref) < 1e-4
    jg, tg = _cotangent(24, short.shape, bf16=False)
    dshort, dact, dls, dlb, ds = vjp(jg)
    got_grads = tfep.fused_residual_postnorm_bwd_reference(
        targs[1], tg, targs[2], targs[3], torch.from_numpy(s[:, 0]))
    for name, g, r in zip(("da", "dgamma", "dbeta", "ds"), got_grads,
                          (dact, dls, dlb, _np(ds)[:, 0])):
        assert _rel(g, r) < 1e-4, name
    np.testing.assert_array_equal(_np(dshort), _np(jg))  # dshortcut is g itself


@pytest.mark.parametrize("scale_shape", [(4, 1, 1), (4, 16, 1), (1,)])
def test_residual_autograd_matches_autograd_of_plain_formula(scale_shape):
    """The wrapper's backward (the CPU route: the explicit K5 formula, ds
    summed back to the branch scale's shape) against torch autograd of the
    formula, f32."""
    short, act, ln_s, ln_b, _ = _residual_args(25)
    s = np.random.default_rng(26).uniform(0.5, 1.5, scale_shape).astype(np.float32)

    def leaves():
        return [torch.from_numpy(a.copy()).requires_grad_(True)
                for a in (short.reshape(4, 16, 16), act.reshape(4, 16, 16), ln_s, ln_b, s)]

    _, tg = _cotangent(27, (4, 16, 16), bf16=False)
    a = leaves()
    before = (tfep.FWD_LAUNCHES, tfep.BWD_LAUNCHES)
    tfep.fused_residual_postnorm(*a).backward(tg)
    assert (tfep.FWD_LAUNCHES, tfep.BWD_LAUNCHES) == before  # CPU: no kernel
    b = leaves()
    from pangu_tpu_torch.ops.fused_block_attention import layer_norm_f32

    (b[0] + b[4] * layer_norm_f32(b[1], b[2], b[3])).backward(tg)
    for name, x, y in zip(("shortcut", "a", "gamma", "beta", "s"), a, b):
        assert x.grad.shape == y.grad.shape and _rel(x.grad, y.grad) < 1e-4, name


def test_residual_wrapper_rejects_bad_arguments():
    short, act, ln_s, ln_b, s = (torch.from_numpy(a) for a in _residual_args(28))
    with pytest.raises(ValueError):
        tfep.fused_residual_postnorm(short, act[:, :8], ln_s, ln_b, s)
    with pytest.raises(ValueError):
        tfep.fused_residual_postnorm(short, act, ln_s[:8], ln_b, s)
    with pytest.raises(ValueError):
        tfep.fused_residual_postnorm(short, act, ln_s, ln_b, torch.ones(3, 1))
    with pytest.raises(ValueError):
        tfep.fused_residual_postnorm_bwd(act, short[:, :8], ln_s, ln_b, s[:, 0])
    with pytest.raises(ValueError):
        tfep.fused_residual_postnorm_bwd(act, short, ln_s, ln_b, s)  # s must be (R,)


# ---- K6 / K7: the MLP tail ----------------------------------------------------

MLP_NAMES = ("dx", "dw1", "db1", "dw2", "db2", "dgamma", "dbeta", "ds")


def _mlp_args(seed, rows=96, c=16):
    """Rows of x, weights in the JAX (in, out) layout, LayerNorm parameters and
    a per-row branch scale (rows, 1), as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    mk = lambda *s, std=0.1, mean=0.0: (mean + rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    return (mk(rows, c, std=1.0), mk(c, 4 * c, std=c ** -0.5), mk(4 * c),
            mk(4 * c, c, std=(4 * c) ** -0.5), mk(c), mk(c, mean=1.0), mk(c),
            rng.uniform(0.5, 1.5, (rows, 1)).astype(np.float32))


def _mlp_both(args, bf16):
    """(JAX arrays, port tensors): weights transposed to nn.Linear's layout,
    activations and weights rounded to bf16 alike when ``bf16``."""
    jx, tx = [], []
    for i, a in enumerate(args):
        j = jnp.asarray(a, jnp.bfloat16 if bf16 and i < 5 else jnp.float32)
        t = torch.from_numpy(np.array(j.astype(jnp.float32)))
        t = t.to(torch.bfloat16) if bf16 and i < 5 else t
        jx.append(j)
        tx.append(t.t().contiguous() if i in (1, 3) else t)
    tx[7] = tx[7][:, 0]
    return jx, tx


def _mlp_to_port_layout(jax_grads):
    dx, dw1, db1, dw2, db2, dls, dlb, ds = (_np(g) for g in jax_grads)
    return dx, dw1.T, db1, dw2.T, db2, dls, dlb, ds.reshape(-1)


def test_mlp_postnorm_plain_bf16_matches_interpreted_pallas(interpret_tpu_route):
    """K6 and K7's plain versions against the interpreted Pallas kernels; 2,904
    rows run 3 grid steps of 968, so the weight-grad sums carry over steps."""
    jx, tx = _mlp_both(_mlp_args(31, rows=2904), bf16=True)
    ref = fm.fused_mlp_postnorm(*jx)
    got = tfm.fused_mlp_postnorm(*tx[:7], tx[7][:, None])  # CPU: the plain version
    assert got.dtype == torch.bfloat16
    _assert_scaled_close(_np(got), _np(ref), atol=0.04)

    jg, tg = _cotangent(32, (2904, 16), bf16=True)
    ref = _mlp_to_port_layout(fm._postnorm_bwd(tuple(jx), jg))
    got = tfm.fused_mlp_postnorm_bwd_reference(tx[0], tg, *tx[1:])
    for name, g, r in zip(MLP_NAMES, got, ref):
        want = torch.bfloat16 if name in MLP_NAMES[:5] else torch.float32
        assert g.dtype == want, name
        _assert_scaled_close(_np(g), r, atol=0.05)


def test_mlp_postnorm_plain_f32_matches_xla_and_vjp():
    jx, tx = _mlp_both(_mlp_args(33), bf16=False)
    ref, vjp = jax.vjp(lambda *a: fm._postnorm_xla(*a, precision=HIGHEST), *jx)
    got = tfm.fused_mlp_postnorm_reference(*tx)
    assert _rel(got, ref) < 1e-4
    jg, tg = _cotangent(34, tuple(got.shape), bf16=False)
    got_grads = tfm.fused_mlp_postnorm_bwd_reference(tx[0], tg, *tx[1:])
    for name, g, r in zip(MLP_NAMES, got_grads, _mlp_to_port_layout(vjp(jg))):
        assert _rel(g, r) < 1e-4, name


@pytest.mark.parametrize("scale_shape", [(4, 1, 1), (4, 24, 1), (1,)])
def test_mlp_postnorm_autograd_matches_autograd_of_plain_forward(scale_shape):
    """The wrapper's backward (the CPU route: the explicit K7 formula, ds
    summed back to the branch scale's shape) against torch autograd of the
    plain forward, f32."""
    _, tx = _mlp_both(_mlp_args(35), bf16=False)
    s = torch.from_numpy(np.random.default_rng(36).uniform(0.5, 1.5, scale_shape)
                         .astype(np.float32))

    def leaves():
        return [t.clone().requires_grad_(True) for t in [tx[0].reshape(4, 24, 16)] + tx[1:7] + [s]]

    _, tg = _cotangent(37, (4, 24, 16), bf16=False)
    a = leaves()
    before = (tfm.FWD_LAUNCHES, tfm.BWD_LAUNCHES)
    tfm.fused_mlp_postnorm(*a).backward(tg)
    assert (tfm.FWD_LAUNCHES, tfm.BWD_LAUNCHES) == before  # CPU: no kernel
    b = leaves()
    s_rows = b[7].expand(4, 24, 1).reshape(96)
    tfm.fused_mlp_postnorm_reference(b[0].reshape(96, 16), *b[1:7], s_rows).backward(
        tg.reshape(96, 16))
    for name, x, y in zip(("x", "w1", "b1", "w2", "b2", "gamma", "beta", "s"), a, b):
        assert x.grad.shape == y.grad.shape and _rel(x.grad, y.grad) < 1e-4, name


def test_mlp_postnorm_wrapper_rejects_bad_arguments():
    _, tx = _mlp_both(_mlp_args(38), bf16=False)
    x, w1, b1, w2, b2, ln_s, ln_b, s = tx
    with pytest.raises(ValueError):
        tfm.fused_mlp_postnorm(x, w1[:, :8], b1, w2, b2, ln_s, ln_b, s[:, None])
    with pytest.raises(ValueError):
        tfm.fused_mlp_postnorm(x, w1, b1, w2, b2, ln_s[:8], ln_b, s[:, None])
    with pytest.raises(ValueError):
        tfm.fused_mlp_postnorm(x, w1, b1, w2, b2, ln_s, ln_b, torch.ones(3, 1))
    with pytest.raises(ValueError):  # g must be x's shape and dtype
        tfm.fused_mlp_postnorm_bwd(x, x[:, :8], w1, b1, w2, b2, ln_s, ln_b, s)
    with pytest.raises(ValueError):  # s must be (R,)
        tfm.fused_mlp_postnorm_bwd(x, x, w1, b1, w2, b2, ln_s, ln_b, s[:, None])
