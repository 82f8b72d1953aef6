"""The port's last kernels' plain versions against the JAX package.

``pangu_tpu_torch.ops.fused_mlp.fused_mlp_block`` (K10, the inference MLP
tail) and the LN-epilogue mode of
``pangu_tpu_torch.ops.fused_block_attention.fused_block_attention``, with their
module entry points ``Mlp(x, ln, fused=True)`` and
``EarthAttention3D(x, mask, epilogue=...)``; and the three kernel A/B scripts
of ``pangu_tpu_torch/scripts`` (S1 ``bench_attn_fwd_ab``, S2
``bench_attn_bwd_ab``, S3 ``bench_mxu_micro``). On the CPU every wrapper runs
its plain version, held here to

  * the interpreted Pallas kernels (bf16, the kernels' own rounding points),
    atol 0.04 for values and 0.05 for gradients after scaling by max(1,
    max|ref|) -- the bounds of tests/test_kernel_interpret.py (bf16 operands,
    f32 sums taken in another order);
  * in f32, the JAX XLA formulas at Precision.HIGHEST and their ``jax.vjp``:
    max|d| / max|ref| < 1e-4, the golden guard's bound;
  * S3's Pallas bodies in interpret mode: max|d| / max|ref| < 1e-4 for bf16
    (only the order of the f32 sums differs) and < 1e-6 for int8 (exact
    products; at two windows every f32 partial sum is an integer below 2^24).

The JAX scripts are loaded from ``scripts/`` with their geometry globals set
to their own ``--smoke`` values, as their ``smoke()`` does. The CUDA kernels
are compared with the plain versions on the card by tests/test_torch_gpu.py.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
import torch

from pangu_tpu.config import pangu_tiny
from pangu_tpu.model import PanguModel as JaxPanguModel
from pangu_tpu.model.attention import EarthAttention3D as JaxAttention
from pangu_tpu.model.attention import shift_attention_mask as jax_shift_mask
from pangu_tpu.model.blocks import Mlp as JaxMlp
from pangu_tpu.ops import fused_block_attention as fba
from pangu_tpu.ops import fused_mlp as fm
from pangu_tpu.aux import synthetic_aux_constants as jax_synthetic_aux
from pangu_tpu.geometry import compute_geometry
from pangu_tpu_torch import config as port_config
from pangu_tpu_torch.interop.from_jax import load_jax_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.ops import fused_block_attention as tfba
from pangu_tpu_torch.ops import fused_mlp as tfm
from pangu_tpu_torch.scripts import bench_attn_bwd_ab as tbwd
from pangu_tpu_torch.scripts import bench_attn_fwd_ab as tfwd
from pangu_tpu_torch.scripts import bench_mxu_micro as tmicro
from test_torch_ops import _assert_scaled_close, _both, _np_inputs, interpret_tpu_route  # noqa: F401

HIGHEST = jax.lax.Precision.HIGHEST
SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
ATTN_NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rel(got, ref) -> float:
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _pair(a, bf16: bool):
    """The same values for JAX and torch (bf16: rounded once in JAX)."""
    if not bf16:
        return jnp.asarray(a), torch.from_numpy(np.array(a, np.float32))
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


# ---- K10: the inference MLP tail ---------------------------------------------------


def _mlp_args(seed, bf16, rows=96, c=16):
    """(x, w1, b1, w2, b2, ln scale, ln bias) for JAX (Dense layout) and the
    port (nn.Linear layout); LN parameters f32."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa: E731
    arrays = [mk(rows, c), mk(c, 4 * c), mk(4 * c), mk(4 * c, c), mk(c)]
    jx, tx = zip(*(_pair(a, bf16) for a in arrays))
    tx = list(tx)
    tx[1], tx[3] = tx[1].t().contiguous(), tx[3].t().contiguous()
    s, t = 1.0 + mk(c), mk(c)
    return list(jx) + [jnp.asarray(s), jnp.asarray(t)], tx + [torch.from_numpy(s),
                                                             torch.from_numpy(t)]


def test_mlp_block_plain_bf16_matches_interpreted_pallas(interpret_tpu_route):
    jx, tx = _mlp_args(21, bf16=True)
    ref = np.asarray(fm.fused_mlp_block(*jx), np.float32)
    before = tfm.BLOCK_LAUNCHES
    got = tfm.fused_mlp_block(*tx)  # CPU tensor: the plain version
    assert tfm.BLOCK_LAUNCHES == before
    assert got.dtype == torch.bfloat16
    _assert_scaled_close(_np(got), ref, atol=0.04)


def test_mlp_block_plain_f32_matches_xla_and_its_vjp():
    jx, tx = _mlp_args(22, bf16=False)

    def f(*a):
        return fm._xla_reference(*a, precision=HIGHEST)

    ref, vjp = jax.vjp(f, *jx)
    assert _rel(tfm.fused_mlp_block_reference(*tx), ref) < 1e-4
    g = np.random.default_rng(23).standard_normal(ref.shape).astype(np.float32)
    ref_grads = vjp(jnp.asarray(g))
    leaves = [t.clone().requires_grad_(True) for t in tx]
    out = tfm.fused_mlp_block(*leaves)
    assert _rel(out, ref) < 1e-4
    out.backward(torch.from_numpy(g))
    for i, (leaf, r) in enumerate(zip(leaves, ref_grads)):
        want = _np(r).T if i in (1, 3) else _np(r)  # Dense -> nn.Linear layout
        assert _rel(leaf.grad, want) < 1e-4, i


# ---- K2's LN-epilogue mode -----------------------------------------------------------


def _ln_attention_args(seed, bf16, masked, z=4):
    args, statics = _np_inputs(seed, masked=masked, z=z)
    jx, tx = _both(args, dtype_bf16=bf16)
    return jx[:9], tx[:9], statics


@pytest.mark.parametrize("masked", [False, True])
def test_ln_attention_plain_bf16_matches_interpreted_pallas(interpret_tpu_route, masked):
    jx, tx, statics = _ln_attention_args(24, True, masked)
    ref = np.asarray(fba.fused_block_attention(*jx, *statics), np.float32)
    before = (tfba.ATTN_FWD_LAUNCHES, tfba.ATTN_LN_LAUNCHES)
    got = tfba.fused_block_attention(*tx, *statics)  # CPU tensor: the plain version
    assert (tfba.ATTN_FWD_LAUNCHES, tfba.ATTN_LN_LAUNCHES) == before
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    _assert_scaled_close(_np(got), ref, atol=0.04)


@pytest.mark.parametrize("masked", [False, True])
def test_ln_attention_plain_f32_matches_xla_and_its_vjp(masked):
    jx, tx, (window, heads, scale) = _ln_attention_args(25, False, masked)
    mask = jx[6]

    def f(x, wqkv, bqkv, wproj, bproj, bias, s, t):
        return fba._xla_reference(x, wqkv, bqkv, wproj, bproj, bias, mask, window, heads, scale,
                                  precision=HIGHEST, ln_scale=s, ln_bias=t)

    ref, vjp = jax.vjp(f, *jx[:6], *jx[7:9])
    assert _rel(tfba.fused_block_attention_reference(*tx[:7], window, heads, scale, *tx[7:9]),
                ref) < 1e-4
    g = np.random.default_rng(26).standard_normal(ref.shape).astype(np.float32)
    ref_grads = vjp(jnp.asarray(g))
    leaves = [t.clone().requires_grad_(True) for t in tx[:6]] + [
        t.clone().requires_grad_(True) for t in tx[7:9]]
    out = tfba.fused_block_attention(*leaves[:6], tx[6], *leaves[6:], window, heads, scale)
    assert _rel(out, ref) < 1e-4
    out.backward(torch.from_numpy(g))
    for i, (leaf, r) in enumerate(zip(leaves, ref_grads)):
        want = _np(r).T if i in (1, 3) else _np(r)  # Dense -> nn.Linear layout
        assert _rel(leaf.grad, want) < 1e-4, i


# ---- the module entry points, params carried over by interop/from_jax.py ----------


@pytest.fixture(scope="module")
def tiny():
    cfg = pangu_tiny()
    m = cfg.model
    rng = np.random.default_rng(20260817)
    upper = rng.standard_normal((1, m.upper_vars, m.levels, m.lat, m.lon)).astype(np.float32)
    surface = rng.standard_normal((1, m.surface_vars, m.lat, m.lon)).astype(np.float32)
    params = jax.jit(JaxPanguModel(m).init)(jax.random.PRNGKey(0), upper, surface,
                                            jax_synthetic_aux(m, cfg.train))
    params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = port_config.pangu_tiny()
    model = PanguModel(tcfg.model)
    load_jax_params(model, tcfg.model, params)
    block = model.layers.EarthSpecificLayer0.blocks.EarthSpecificBlock0
    block.attention.use_kernel = True
    return dict(m=m, st=compute_geometry(m).outer, jparams=params["params"]["layer0"]["block0"],
                block=block.eval())


def _ln_pair(seed, c, bf16):
    rng = np.random.default_rng(seed)
    s, t = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32), \
        (0.1 * rng.standard_normal(c)).astype(np.float32)
    return (jnp.asarray(s), jnp.asarray(t)), (torch.from_numpy(s), torch.from_numpy(t))


def _compare(got, ref, bf16):
    if bf16:
        _assert_scaled_close(_np(got), _np(ref), atol=0.04)
    else:
        assert _rel(got, ref) < 1e-4


@pytest.mark.parametrize("bf16", [False, True])
def test_mlp_module_fused_matches_flax(interpret_tpu_route, tiny, bf16):
    c = tiny["m"].dims[0]
    jx, tx = _pair(np.random.default_rng(27).standard_normal((2, 4, 6, 8, c)) * 0.5, bf16)
    jln, tln = _ln_pair(28, c, bf16)
    cdt = jnp.bfloat16 if bf16 else jnp.float32
    ref = JaxMlp(c, compute_dtype=cdt, precision=HIGHEST).apply(
        {"params": tiny["jparams"]["mlp"]}, jx, ln=jln, fused=True)
    with torch.no_grad():
        got = tiny["block"].linear(tx, ln=tln, fused=True)
    assert got.dtype == tx.dtype
    _compare(got, ref, bf16)


@pytest.mark.parametrize("bf16,masked", [(False, False), (False, True), (True, True)])
def test_attention_module_epilogue_matches_flax(interpret_tpu_route, tiny, bf16, masked):
    st, m = tiny["st"], tiny["m"]
    c, heads = m.dims[0], m.heads[0]
    jx, tx = _pair(np.random.default_rng(29).standard_normal((1, st.z, st.h_pad, st.w, c)),
                   bf16)
    mask = jax_shift_mask(st) if masked else None
    jln, tln = _ln_pair(30, c, bf16)
    cdt = jnp.bfloat16 if bf16 else jnp.float32
    ref = JaxAttention(dim=c, heads=heads, n_type_windows=st.n_type_windows,
                       tokens_per_window=st.tokens_per_window, window=st.window,
                       compute_dtype=cdt, use_pallas=True, precision=HIGHEST).apply(
        {"params": tiny["jparams"]["attn"]}, jx, None if mask is None else jnp.asarray(mask),
        epilogue=jln)
    with torch.no_grad():
        got = tiny["block"].attention(tx, None if mask is None else torch.from_numpy(mask),
                                      epilogue=tln)
    assert got.dtype == tx.dtype
    _compare(got, ref, bf16)


def test_module_entry_points_reject_what_jax_asserts(tiny):
    block = tiny["block"]
    x = torch.zeros(1, tiny["st"].z, tiny["st"].h_pad, tiny["st"].w, tiny["m"].dims[0])
    with pytest.raises(ValueError):  # fused needs ln
        block.linear(x, fused=True)
    block.attention.use_kernel = False
    try:
        with pytest.raises(ValueError):  # the epilogue needs the kernel route
            block.attention(x, None, epilogue=(torch.ones(x.shape[-1]), torch.zeros(x.shape[-1])))
    finally:
        block.attention.use_kernel = True


# ---- the JAX A/B scripts, loaded as their --smoke runs them ---------------------------


def _load_script(name, monkeypatch, **geometry):
    """scripts/<name>.py as a fresh module (its ``ab_common`` import needs
    scripts/ on sys.path), its geometry globals set."""
    monkeypatch.syspath_prepend(SCRIPTS)
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in geometry.items():
        setattr(mod, k, v)
    return mod


def _interpret():
    return sys.modules["ab_common"].interpret_pallas()


def _t(a, transpose=False):
    """A JAX array as a torch tensor of the same dtype (bf16 exactly)."""
    a = jnp.asarray(a)
    out = torch.from_numpy(np.array(a.astype(jnp.float32)))
    out = out.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else out
    out = out.t().contiguous() if transpose else out
    return out


FWD_SMOKE = dict(B=1, Z=2, HP=6, W=96, C=32, HEADS=2)
BWD_SMOKE = dict(B=1, Z=2, HP=6, W=72, C=32, HEADS=2)


@pytest.fixture(scope="module")
def fwd_script():
    mp = pytest.MonkeyPatch()
    mod = _load_script("bench_attn_fwd_ab", mp, **FWD_SMOKE)
    base, biases = mod._make_args(np.random.default_rng(0))
    yield mod, base, biases
    mp.undo()


def test_interleave_bias_equals_jax(fwd_script):
    mod, _, _ = fwd_script
    bias = np.random.default_rng(31).standard_normal((2, 2, 144, 144)).astype(np.float32)
    for nw in (2, 4):
        np.testing.assert_array_equal(
            tfwd.interleave_bias(torch.from_numpy(bias), nw, 12).numpy(),
            mod.interleave_bias(bias, nw, 12))


@pytest.mark.parametrize("variant", ["shipped", "batched", "dbl", "quad"])
def test_attn_fwd_variant_plain_matches_interpreted_pallas(fwd_script, variant):
    mod, base, biases = fwd_script
    args = mod._args_for(variant, base, biases)
    with _interpret():
        ref = np.asarray(mod._variant_call(variant)(*args), np.float32)
    x, wqkv, bqkv, wproj, bproj, bias = args
    targs = (_t(x), _t(wqkv, True), _t(bqkv).reshape(-1), _t(wproj, True), _t(bproj).reshape(-1),
             _t(bias))
    got = tfwd.variant_call(variant, *targs, heads=FWD_SMOKE["HEADS"])  # CPU: plain
    assert got.dtype == torch.bfloat16
    _assert_scaled_close(_np(got), ref, atol=0.04)


def test_attn_fwd_refuses_what_jax_refuses(fwd_script, monkeypatch):
    mod, _, _ = fwd_script
    monkeypatch.setattr(mod, "W", 360)
    with pytest.raises(ValueError):  # 30 lon windows do not divide by 4
        mod._make_kernel("quad")
    x = torch.zeros(1, 2, 6, 360, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfwd.variant_call("quad", x, *([torch.zeros(1)] * 4), torch.zeros(1, 2, 576, 576),
                          heads=2)
    with pytest.raises(ValueError):
        tfwd.check_variant("pair")


@pytest.fixture(scope="module")
def bwd_script():
    mp = pytest.MonkeyPatch()
    mod = _load_script("bench_attn_bwd_ab", mp, **BWD_SMOKE)
    args = mod._make_args(np.random.default_rng(0))
    x, g, wqkv, bqkv, wproj, bias = args
    targs = (_t(x), _t(g), _t(wqkv, True), _t(bqkv).reshape(-1), _t(wproj, True), _t(bias))
    yield mod, args, targs
    mp.undo()


def _bwd_to_port_layout(grads):
    dx, dwqkv, dbqkv, dwproj, dbproj, dbias = (_np(g) for g in grads)
    return dx, dwqkv.T, dbqkv.reshape(-1), dwproj.T, dbproj.reshape(-1), dbias


@pytest.mark.parametrize("variant", ["shipped", "local_accum"])
def test_attn_bwd_variant_plain_matches_interpreted_pallas(bwd_script, variant):
    mod, args, targs = bwd_script
    call = mod._shipped_call() if variant == "shipped" else mod._variant_call(variant)
    with _interpret():
        ref = _bwd_to_port_layout(call(*args))
    got = tbwd.variant_call(variant, *targs, heads=BWD_SMOKE["HEADS"])  # CPU: plain
    for name, a, r in zip(ATTN_NAMES, got, ref):
        want = torch.bfloat16 if name == "dx" or (variant == "shipped" and name != "dbias") \
            else torch.float32
        assert a.dtype == want, name
        _assert_scaled_close(_np(a), r, atol=0.05)
    if variant == "local_accum":
        ship = tbwd.variant_call("shipped", *targs, heads=BWD_SMOKE["HEADS"])
        assert tbwd.parity(got, ship) <= tbwd.PARITY_TOL


@pytest.mark.parametrize("variant", sorted(tbwd.REFUSED))
def test_attn_bwd_refused_variants_raise(bwd_script, variant):
    mod, _, _ = bwd_script
    assert variant in mod.VARIANTS  # a JAX variant the port refuses
    with pytest.raises(ValueError):
        tbwd.check_variant(variant)
    with pytest.raises(ValueError):
        tbwd.run([variant])


# ---- S3: the micro-bench bodies -----------------------------------------------------------


@pytest.fixture(scope="module")
def micro_script():
    mp = pytest.MonkeyPatch()
    mod = _load_script("bench_mxu_micro", mp, REPS=2)
    yield mod
    mp.undo()


def _run_body(body, qkv):
    def kernel(qkv_ref, out_ref):
        out_ref[:] = jnp.zeros_like(out_ref)
        body(qkv_ref, out_ref)

    return pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((144, 144), jnp.float32),
                          interpret=True)(qkv)


@pytest.mark.parametrize("variant", tmicro.VARIANTS)
def test_mxu_micro_plain_matches_pallas_body(micro_script, variant):
    rng = np.random.default_rng(32)
    if variant == "loop_int8":
        jq = jnp.asarray(rng.integers(-127, 127, (2, 144, 576)), jnp.int8)
        tq = torch.from_numpy(np.array(jq))
    else:
        jq = jnp.asarray(rng.standard_normal((2, 144, 576)), jnp.bfloat16)
        tq = _t(jq)
    ref = np.asarray(_run_body(getattr(micro_script, f"_{variant}_kernel"), jq))
    before = tmicro.LAUNCHES[variant]
    got = tmicro.mxu_micro(variant, tq)  # CPU tensor: the plain version
    assert tmicro.LAUNCHES[variant] == before
    assert _rel(got, ref) < tmicro.TOL[variant]
    assert _rel(tmicro.mxu_micro(variant, tq, sweeps=3), 3 * ref) < tmicro.TOL[variant]


def test_mxu_micro_rejects_bad_arguments():
    q = torch.zeros(2, 144, 576, dtype=torch.bfloat16)
    for variant, arg, sweeps in (("loop", q, 0), ("loop_int8", q, 1), ("packed", q, 1),
                                 ("loop", q[:, :, :300], 1)):
        with pytest.raises(ValueError):
            tmicro.mxu_micro(variant, arg, sweeps)


@pytest.mark.parametrize("variant", tmicro.VARIANTS)
def test_mxu_micro_library_call_computes_one_sweep(variant):
    """Each variant's yardstick (``library_call``: the operands it gathers and
    the call's formula) gives the plain version's one sweep. The formula runs
    here in f32 (``torch.einsum``) or int64 (``torch._int_mm``'s operands:
    the int8 product need not run on the CPU), its sums exact or in another
    order; ``_int_mm`` gets q row-major and k column-major, the contraction
    contiguous in both."""
    qkv, qkv8 = tmicro.make_inputs("cpu")
    x = (qkv8 if variant == "loop_int8" else qkv)[:3]
    call = tmicro.library_call(variant, x)
    ref = tmicro.mxu_micro_reference(variant, x)
    if variant == "loop_int8":
        a, b = call.args
        assert call.func is torch._int_mm
        assert a.shape == (144, 3 * 192) and a.is_contiguous() and b.t().is_contiguous()
        got = (a.long() @ b.long()).float()
    else:
        eq, q, k = call.args
        assert call.func is torch.einsum and q.shape == k.shape == (
            3, 144, len(tmicro.HEADS[variant]), 32)
        got = torch.einsum(eq, q.float(), k.float())
    assert _rel(got, ref) < tmicro.TOL[variant]
