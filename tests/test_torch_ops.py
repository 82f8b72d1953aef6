"""The port's kernel module and window layout against the JAX package.

``pangu_tpu_torch.ops.fused_block_attention`` holds the CUDA block kernel's
wrapper and its plain PyTorch version. On the CPU the wrapper runs the plain
version, which is held here to

  * the interpreted Pallas megakernel (bf16, the kernel's own rounding
    points), with the tolerance of tests/test_kernel_interpret.py: atol 0.04
    after scaling by max(1, max|ref|) -- bf16 activations, f32 sums taken in
    another order;
  * the JAX XLA block formula at Precision.HIGHEST (f32): max|d| / max|ref|
    < 1e-4, the golden guard's bound -- only summation order differs.

The CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
import torch

from pangu_tpu.config import pangu_pretrain, pangu_tiny
from pangu_tpu.geometry import compute_geometry
from pangu_tpu.model.attention import shift_attention_mask as jax_mask_np
from pangu_tpu.model.attention import shift_attention_mask_traced
from pangu_tpu.ops import fused_block_attention as fba
from pangu_tpu.ops.windows import window_partition as jax_partition
from pangu_tpu.ops.windows import window_reverse as jax_reverse
from pangu_tpu_torch.model.attention import shift_attention_mask
from pangu_tpu_torch.ops import fused_block_attention as tfba
from pangu_tpu_torch.ops.windows import window_partition, window_reverse

WINDOW = (2, 6, 12)
T = 144
#: wqkv, wproj, w1, w2: Dense (in, out) for JAX, nn.Linear (out, in) for the port
WEIGHTS = (1, 3, 9, 11)


@pytest.fixture
def interpret_tpu_route(monkeypatch):
    """Force the Pallas route of the JAX op with an interpreted kernel (the
    pattern of tests/test_kernel_interpret.py)."""
    real_call = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)  # Mosaic-only
        return real_call(*args, **kw)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(pl, "pallas_call", interp_call)


def _np_inputs(seed, z=2, hp=6, w=24, c=16, heads=2, masked=True, b=2):
    """Block inputs as f32 numpy arrays plus a per-argument 'is bf16' flag
    (the shapes of tests/test_kernel_interpret.py::_inputs)."""
    rng = np.random.default_rng(seed)
    nt = (z // WINDOW[0]) * (hp // WINDOW[1])
    mk = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa: E731
    mask = (np.where(rng.uniform(size=(nt, T, T)) > 0.8, -100.0, 0.0).astype(np.float32)
            if masked else None)
    args = [
        (mk(b, z, hp, w, c), True),
        (mk(c, 3 * c), True), (mk(3 * c), True),
        (mk(c, c), True), (mk(c), True),
        (mk(nt, heads, T, T), False),
        (mask, False),
        (1.0 + mk(c), False), (mk(c), False),
        (mk(c, 4 * c), True), (mk(4 * c), True),
        (mk(4 * c, c), True), (mk(c), True),
        (1.0 + mk(c), False), (mk(c), False),
    ]
    return args, (WINDOW, heads, (c // heads) ** -0.5)


def _both(args, dtype_bf16: bool):
    """The same values for JAX and torch; 'bf16' arguments are rounded once
    (in JAX) and handed over exactly, the weights transposed for the port."""
    jx, tx = [], []
    for a, is_act in args:
        if a is None:
            jx.append(None)
            tx.append(None)
            continue
        if is_act and dtype_bf16:
            j = jnp.asarray(a, jnp.bfloat16)
            jx.append(j)
            tx.append(torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16))
        else:
            jx.append(jnp.asarray(a))
            tx.append(torch.from_numpy(a.copy()))
    for i in WEIGHTS:
        tx[i] = tx[i].t().contiguous()
    return jx, tx


def _assert_scaled_close(got, ref, atol):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=atol)


@pytest.mark.parametrize("masked", [False, True])
def test_block_plain_bf16_matches_interpreted_pallas(interpret_tpu_route, masked):
    args, statics = _np_inputs(1, masked=masked)
    jx, tx = _both(args, dtype_bf16=True)
    ref = np.asarray(fba.fused_earth_block(*jx, *statics), np.float32)
    got = tfba.fused_earth_block(*tx, *statics)  # CPU tensor: the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    _assert_scaled_close(got.float().numpy(), ref, atol=0.04)


@pytest.mark.parametrize("masked", [False, True])
def test_block_plain_f32_matches_xla_highest(masked):
    args, (window, heads, scale) = _np_inputs(2, z=4, masked=masked)
    jx, tx = _both(args, dtype_bf16=False)
    ref = np.asarray(fba._xla_block_reference(
        *jx, window, heads, scale, precision=jax.lax.Precision.HIGHEST))
    got = tfba.fused_earth_block_reference(*tx, window, heads, scale).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def _bad_args(case):
    args, statics = _np_inputs(3)
    _, tx = _both(args, dtype_bf16=True)
    if case == "x_rank":
        tx[0] = tx[0][0]
    elif case == "x_int":
        tx[0] = tx[0].to(torch.int32)
    elif case == "grid_not_window_multiple":
        tx[0] = tx[0][:, :, :, :20]
    elif case == "wqkv_shape":
        tx[1] = tx[1][:, :-1]
    elif case == "wproj_dtype":
        tx[3] = tx[3].float()
    elif case == "bias_dtype":
        tx[5] = tx[5].to(torch.bfloat16)
    elif case == "mask_shape":
        tx[6] = torch.zeros(1, T, T + 1)
    elif case == "ln_shape":
        tx[7] = tx[7][:-1]
    elif case == "w2_shape":
        tx[11] = tx[11].t()
    return tx, statics


@pytest.mark.parametrize("case", [
    "x_rank", "x_int", "grid_not_window_multiple", "wqkv_shape", "wproj_dtype",
    "bias_dtype", "mask_shape", "ln_shape", "w2_shape",
])
def test_wrapper_rejects_bad_arguments_on_cpu(case):
    tx, statics = _bad_args(case)
    before = tfba.LAUNCHES
    with pytest.raises(ValueError):
        tfba.fused_earth_block(*tx, *statics)
    assert tfba.LAUNCHES == before


def test_plain_version_on_cpu_counts_no_launch():
    args, statics = _np_inputs(4)
    _, tx = _both(args, dtype_bf16=True)
    before = tfba.LAUNCHES
    tfba.fused_earth_block(*tx, *statics)
    assert tfba.LAUNCHES == before


@pytest.mark.parametrize("stage", ["outer", "inner"])
def test_window_partition_and_reverse_match_jax(stage):
    g = getattr(compute_geometry(pangu_tiny().model), stage)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, g.z, g.h_pad, g.w, 8)).astype(np.float32)
    ref = np.asarray(jax_partition(jnp.asarray(x), g.window))
    got = window_partition(torch.from_numpy(x), g.window)
    np.testing.assert_array_equal(got.numpy(), ref)
    back = window_reverse(got, g.window, g.z, g.h_pad, g.w)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_reverse(jnp.asarray(ref), g.window, g.z, g.h_pad, g.w)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("config,stage", [
    ("tiny", "outer"), ("tiny", "inner"), ("pretrain", "outer"), ("pretrain", "inner"),
])
def test_shift_mask_equals_jax(config, stage):
    cfg = (pangu_tiny() if config == "tiny" else pangu_pretrain()).model
    st = getattr(compute_geometry(cfg), stage)
    got = shift_attention_mask(st)
    np.testing.assert_array_equal(got, jax_mask_np(st))
    np.testing.assert_array_equal(got, np.asarray(shift_attention_mask_traced(st)))
