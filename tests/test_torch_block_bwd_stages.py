"""The training-block backward K12 as the chain of stages its CUDA version
launches, composed on the CPU from the plain versions of the kernels that
run each stage, with K12's rounding points between them (a and x1 in x's
dtype, dx1 f32, da in x's dtype):

  1-2. a = K2's plain version (the attention output projected), x1 = K4's
       plain version on (x, a) with s1 per row;
  2-3. K7's plain version on (x1, g) with s2 per row and dx1 = g + dh W1 left
       f32 (``dx_dtype``): dy2's LayerNorm backward, the hidden pass, dW1,
       db1, dW2, db2, dgamma2, dbeta2, ds2;
  4.   K5's plain version on (a, dx1) with s1 per row: da, dgamma1, dbeta1, ds1;
  5-6. K3's plain version from da with dx1 added before dx's one rounding
       (``dx_addend``): dWqkv, dbqkv, dWproj, dbproj, dbias, dx.

The composition is held to ``fused_earth_block_train_bwd_reference`` and to
the interpreted Pallas ``_backward_pallas`` (bf16; atol 0.05 after scaling by
max(1, max|ref|), the bound of tests/test_torch_train_ab.py: bf16 operands and
f32 sums in another order; the chain rounds dbproj's summands, da, to bf16
where the Pallas body sums f32 da), and in f32, where no rounding is left, to
the plain K12 at max|d| / max|ref| < 1e-4 (only the order of f32 sums
differs). The CUDA chain itself is compared with the plain K12 on the card
(tests/test_torch_gpu.py).
"""

import pytest
import torch

from pangu_tpu.ops import fused_block_train as fbt
from pangu_tpu_torch.ops import fused_block_attention as tfba
from pangu_tpu_torch.ops import fused_block_train as tfbt
from pangu_tpu_torch.ops import fused_epilogue as tfep
from pangu_tpu_torch.ops import fused_mlp as tfm
from test_torch_ops import _assert_scaled_close, interpret_tpu_route  # noqa: F401
from test_torch_train_ab import _block_args, _block_to_port_layout
from test_torch_train_ops import _cotangent, _np, _rel


def k12_stages(x, wqkv, bqkv, wproj, bproj, bias, mask, ln1_s, ln1_b, w1, b1, w2, b2,
               ln2_s, ln2_b, s1, s2, g, window, heads, scale):
    """K12's 16 gradients (the order of ``GRAD_NAMES``) from the plain
    versions of the kernels its CUDA chain launches."""
    b, c = x.shape[0], x.shape[-1]
    rows = x.numel() // c

    def per_row(s):
        return s.reshape(b, 1).expand(b, rows // b).reshape(rows).float()

    def per_sample(v, like):
        return v.reshape(b, -1).sum(1).reshape(like.shape).to(like.dtype)

    s1r, s2r = per_row(s1), per_row(s2)
    x2, g2 = x.reshape(rows, c), g.reshape(rows, c)
    a = tfba.fused_block_attention_reference(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                             window, heads, scale).reshape(rows, c)
    x1 = tfep.fused_residual_postnorm_reference(x2, a, ln1_s, ln1_b, s1r)
    dx1, dw1, db1, dw2, db2, dln2_s, dln2_b, ds2 = tfm.fused_mlp_postnorm_bwd_reference(
        x1, g2, w1, b1, w2, b2, ln2_s, ln2_b, s2r, dx_dtype=torch.float32)
    da, dln1_s, dln1_b, ds1 = tfep.fused_residual_postnorm_bwd_reference(a, dx1, ln1_s, ln1_b,
                                                                         s1r)
    dx, dwqkv, dbqkv, dwproj, dbproj, dbias = tfba.fused_block_attention_bwd_reference(
        x, wqkv, bqkv, wproj, bias, mask, da.reshape(x.shape), window, heads, scale,
        dx_addend=dx1.reshape(x.shape))
    return (dx, dwqkv, dbqkv, dwproj, dbproj.to(bproj.dtype), dbias, dln1_s, dln1_b, dw1, db1,
            dw2, db2, dln2_s, dln2_b, per_sample(ds1, s1), per_sample(ds2, s2))


@pytest.mark.parametrize("masked", [False, True])
def test_k12_stages_bf16_match_the_plain_k12(masked):
    _, tx, (window, heads, scale) = _block_args(81, True, masked)
    _, tg = _cotangent(82, tuple(tx[0].shape), bf16=True)
    got = k12_stages(*tx, tg, window, heads, scale)
    ref = tfbt.fused_earth_block_train_bwd_reference(*tx, tg, window, heads, scale)
    assert len(got) == len(ref) == 16
    for name, a, r in zip(tfbt.GRAD_NAMES, got, ref):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        _assert_scaled_close(_np(a), _np(r), atol=0.05)


@pytest.mark.parametrize("masked", [False, True])
def test_k12_stages_bf16_match_interpreted_pallas(interpret_tpu_route, masked):
    """Two samples (s1 != s2, one MLP branch dropped), two window types and
    two lon windows each: the stage sums run over several terms."""
    jx, tx, (window, heads, scale) = _block_args(83, True, masked)
    jg, tg = _cotangent(84, tuple(jx[0].shape), bf16=True)
    ref = _block_to_port_layout(fbt._backward_pallas(*jx, jg, window, heads, scale))
    got = k12_stages(*tx, tg, window, heads, scale)
    for name, a, r in zip(tfbt.GRAD_NAMES, got, ref):
        _assert_scaled_close(_np(a), r, atol=0.05)


@pytest.mark.parametrize("masked", [False, True])
def test_k12_stages_f32_equal_the_plain_k12(masked):
    _, tx, (window, heads, scale) = _block_args(85, False, masked)
    _, tg = _cotangent(86, tuple(tx[0].shape), bf16=False)
    got = k12_stages(*tx, tg, window, heads, scale)
    ref = tfbt.fused_earth_block_train_bwd_reference(*tx, tg, window, heads, scale)
    for name, a, r in zip(tfbt.GRAD_NAMES, got, ref):
        assert _rel(a, r) < 1e-4, name
