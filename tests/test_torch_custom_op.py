"""K1 as the operator ``pangu_tpu_torch::fused_earth_block``, on the CPU.

* ``torch.library.opcheck`` at a tiny shape, masked and unmasked: the schema,
  the autograd registration (K1 has no backward: its outputs never require
  grad), the fake implementation and AOT dispatch.
* The operator on the CPU runs K1's plain version, bit for bit, both called
  directly and through the public wrapper; it is registered for CPU and CUDA
  and has a fake implementation, and the wrapper's argument checks run
  before any dispatch.
* Against the interpreted Pallas K1 of the JAX package (the tolerance of
  tests/test_kernel_interpret.py: atol 0.04 after scaling by max(1,
  max|ref|)).
* The fold (a block's shift and real rows given to the operator): opcheck
  over the schema with them, the CPU implementation against the unfolded
  route written out (re-zero, ``torch.roll``, the operator without them, the
  roll back) on an input whose pad rows hold junk or NaN, the same bits on
  the real rows; against the JAX package's K1 (interpreted Pallas) on the
  re-zeroed input under ``jnp.roll``, the real rows within the tolerance
  above; and a whole bf16 kernel-route forecast step against the same
  blocks driven through the unfolded route: the same bits.

The CUDA implementation, the hand-written kernel, is compared with the plain
version on the card by tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from pangu_tpu.ops import fused_block_attention as fba
from pangu_tpu_torch.ops import fused_block_attention as tfba
from test_torch_ops import _assert_scaled_close, _both, _np_inputs, interpret_tpu_route  # noqa: F401

OP = tfba.FUSED_EARTH_BLOCK_OP


def _no_fold(x):
    """The operator's ``shift`` and ``h`` for a call without a fold."""
    return [0, 0, 0], x.shape[2]


def _torch_inputs(seed, masked, dtype_bf16=True):
    args, statics = _np_inputs(seed, masked=masked)
    return _both(args, dtype_bf16)[1], statics


@pytest.mark.parametrize("masked", [False, True])
def test_opcheck(masked):
    tx, (window, heads, scale) = _torch_inputs(11, masked)
    result = torch.library.opcheck(OP, (*tx, list(window), heads, scale, *_no_fold(tx[0])))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bf16", [True, False])
def test_operator_on_the_cpu_is_the_plain_version_bit_for_bit(masked, bf16):
    tx, statics = _torch_inputs(12, masked, bf16)
    ref = tfba.fused_earth_block_reference(*tx, *statics)
    before = tfba.LAUNCHES
    window, heads, scale = statics
    direct = OP(*tx, list(window), heads, scale, *_no_fold(tx[0]))
    wrapped = tfba.fused_earth_block(*tx, *statics)
    assert tfba.LAUNCHES == before
    assert direct.dtype == tx[0].dtype and torch.equal(direct, ref) and torch.equal(wrapped, ref)


def test_operator_registrations():
    name = OP.name()
    assert name == "pangu_tpu_torch::fused_earth_block"
    for key in ("CPU", "CUDA"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key), key
    tx, (window, heads, scale) = _torch_inputs(13, True)
    with FakeTensorMode() as mode:
        fake = [None if t is None else mode.from_tensor(t) for t in tx]
        out = OP(*fake, list(window), heads, scale, *_no_fold(tx[0]))
    assert out.shape == tx[0].shape and out.dtype == tx[0].dtype


def test_wrapper_checks_before_dispatch(monkeypatch):
    """An argument the kernel does not take raises ValueError in the wrapper,
    before the operator is called."""
    calls = []
    monkeypatch.setattr(tfba, "FUSED_EARTH_BLOCK_OP", lambda *a: calls.append(a))
    tx, statics = _torch_inputs(14, True)
    bad = list(tx)
    bad[5] = bad[5][:, :1]  # earth bias with the wrong head count
    with pytest.raises(ValueError, match="bias"):
        tfba.fused_earth_block(*bad, *statics)
    bad = list(tx)
    bad[6] = bad[6].to(torch.bfloat16)  # mask in the wrong dtype
    with pytest.raises(ValueError, match="mask"):
        tfba.fused_earth_block(*bad, *statics)
    assert not calls
    tfba.fused_earth_block(*tx, *statics)
    assert len(calls) == 1 and calls[0][-5:] == (list(statics[0]), statics[1], statics[2],
                                                 *_no_fold(tx[0]))


@pytest.mark.parametrize("masked", [False, True])
def test_operator_matches_interpreted_pallas(interpret_tpu_route, masked):
    args, (window, heads, scale) = _np_inputs(15, masked=masked)
    jx, tx = _both(args, dtype_bf16=True)
    ref = np.asarray(fba.fused_earth_block(*jx, window, heads, scale), np.float32)
    got = OP(*tx, list(window), heads, scale, *_no_fold(tx[0]))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    _assert_scaled_close(got.float().numpy(), ref, atol=0.04)


# ---- the fold: a block's shift and real rows ------------------------------------------------

#: a grid of 2 x 2 x 2 windows of (2, 6, 12), the shifted block's shift and 9
#: real lat rows of 12
FOLD_GRID = dict(z=4, hp=12, w=24)
SHIFT, H = (1, 3, 6), 9


def _fold_inputs(seed, masked, junk):
    args, statics = _np_inputs(seed, masked=masked, **FOLD_GRID)
    tx = _both(args, dtype_bf16=True)[1]
    x = tx[0].clone()
    x[:, :, H:] = float("nan") if junk == "nan" else 3e4
    return [x, *tx[1:]], statics


def _unfolded(op, tx, statics, shift, h):
    """The unfolded route: re-zero the rows >= h, roll by -shift, the
    operator without a fold, roll back."""
    window, heads, scale = statics
    x = tx[0]
    x = F.pad(x[:, :, :h], (0, 0, 0, 0, 0, x.shape[2] - h))
    x = torch.roll(x, [-s for s in shift], dims=(1, 2, 3))
    out = op(x, *tx[1:], list(window), heads, scale, *_no_fold(x))
    return torch.roll(out, list(shift), dims=(1, 2, 3))


@pytest.mark.parametrize("masked", [False, True])
def test_opcheck_with_a_fold(masked):
    tx, (window, heads, scale) = _fold_inputs(16, masked, "large")
    result = torch.library.opcheck(OP, (*tx, list(window), heads, scale, list(SHIFT), H))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("junk", ["large", "nan"])
@pytest.mark.parametrize("shift,masked", [((0, 0, 0), False), (SHIFT, True)])
def test_operator_with_a_fold_on_the_cpu_is_the_unfolded_route_on_real_rows(shift, masked,
                                                                           junk):
    tx, statics = _fold_inputs(17, masked, junk)
    before = (tfba.LAUNCHES, tfba.FOLDED_LAUNCHES)
    got = tfba.fused_earth_block(*tx, *statics, shift=shift, h=H)
    ref = _unfolded(OP, tx, statics, shift, H)
    assert (tfba.LAUNCHES, tfba.FOLDED_LAUNCHES) == before  # CPU tensors: no launch
    assert torch.equal(got[:, :, :H], ref[:, :, :H])
    assert bool(torch.isfinite(got[:, :, :H].float()).all())


@pytest.mark.parametrize("shift,masked,junk", [((0, 0, 0), False, "large"), (SHIFT, True, "nan")])
def test_operator_with_a_fold_matches_interpreted_pallas_on_real_rows(interpret_tpu_route, shift,
                                                                      masked, junk):
    """The operator given a shift and real rows, on an input whose pad rows
    hold junk, against the JAX package's K1 (interpreted Pallas) on the same
    input with its pad rows zeroed and ``jnp.roll`` by -shift, rolled back."""
    args, (window, heads, scale) = _np_inputs(19, masked=masked, **FOLD_GRID)
    jx, tx = _both(args, dtype_bf16=True)
    x = tx[0].clone()
    x[:, :, H:] = float("nan") if junk == "nan" else 3e4
    axes = (1, 2, 3)
    jx0 = jnp.roll(jx[0].at[:, :, H:].set(0), [-s for s in shift], axis=axes)
    ref = jnp.roll(fba.fused_earth_block(jx0, *jx[1:], window, heads, scale), shift, axis=axes)
    got = OP(x, *tx[1:], list(window), heads, scale, list(shift), H)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    _assert_scaled_close(got[:, :, :H].float().numpy(), np.asarray(ref, np.float32)[:, :, :H],
                         atol=0.04)


@pytest.mark.parametrize("shift,h", [((2, 0, 0), None), ((0, 6, 0), None), ((0, 0, -1), None),
                                     ((0, 0), None), ((0, 0, 0), 0), ((0, 0, 0), 13)])
def test_wrapper_refuses_a_fold_the_kernel_does_not_take(monkeypatch, shift, h):
    calls = []
    monkeypatch.setattr(tfba, "FUSED_EARTH_BLOCK_OP", lambda *a: calls.append(a))
    tx, statics = _fold_inputs(18, True, "large")
    with pytest.raises(ValueError, match="shift" if h is None else "h must"):
        tfba.fused_earth_block(*tx, *statics, shift=shift, h=h)
    assert not calls


def test_a_kernel_route_forecast_step_is_the_unfolded_route_bit_for_bit(monkeypatch):
    """A tiny bf16 ``use_kernel`` forecast step (8 blocks, 4 shifted, pad
    rows at both stages): every block calls the operator on its input as it
    stands with its shift and real rows, and the step's bits are those of the
    same blocks driven through the unfolded route."""
    from pangu_tpu_torch.aux import synthetic_aux_constants
    from pangu_tpu_torch.config import pangu_tiny
    from pangu_tpu_torch.geometry import compute_geometry
    from pangu_tpu_torch.model import PanguModel, blocks
    from pangu_tpu_torch.model.attention import linear_weight
    from pangu_tpu_torch.rollout import make_forecast_step

    torch.manual_seed(0)
    cfg = pangu_tiny(depths=(2, 2, 2, 2), compute_dtype="bfloat16", use_pallas_attention=True)
    m = cfg.model
    aux = synthetic_aux_constants(m, cfg.train, device="cpu")
    net = PanguModel(m)
    upper = torch.randn(1, m.upper_vars, m.levels, m.lat, m.lon)
    surface = torch.randn(1, m.surface_vars, m.lat, m.lon)
    step = make_forecast_step(net, aux)

    calls = []

    def spy(*args):
        calls.append((list(args[-2]), args[-1]))
        return OP(*args)

    monkeypatch.setattr(tfba, "FUSED_EARTH_BLOCK_OP", spy)
    before = (tfba.LAUNCHES, tfba.FOLDED_LAUNCHES)
    folded = step(upper, surface)
    assert tfba.FOLDED_LAUNCHES - before[1] == tfba.LAUNCHES - before[0]
    geo = compute_geometry(m)
    stages = [geo.outer] * 2 + [geo.inner] * 4 + [geo.outer] * 2
    assert all(st.h < st.h_pad for st in stages)
    assert calls == [([w // 2 if i % 2 else 0 for w in st.window], st.h)
                     for i, st in enumerate(stages)]

    def unfolded_forward(self, x):
        st, attn, mlp, cdt = self.stage, self.attention, self.linear, x.dtype
        shift = [w // 2 if self.shifted else 0 for w in st.window]
        tx = [x, linear_weight(attn.linear1).to(cdt), attn.linear1.bias.to(cdt),
              linear_weight(attn.linear2).to(cdt), attn.linear2.bias.to(cdt),
              attn.earth_specific_bias[0].float(), self.attn_mask,
              self.norm1.weight.float(), self.norm1.bias.float(), *mlp.weights(cdt),
              self.norm2.weight.float(), self.norm2.bias.float()]
        return _unfolded(OP, tx, (st.window, self.heads, (self.dim // self.heads) ** -0.5),
                         shift, st.h)

    monkeypatch.setattr(blocks.EarthSpecificBlock, "forward", unfolded_forward)
    reference = step(upper, surface)
    for got, ref in zip(folded, reference):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
