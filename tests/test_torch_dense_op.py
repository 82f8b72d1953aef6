"""The Dense product as the operator ``pangu_tpu_torch::dense``, on the CPU.

* ``torch.library.opcheck`` with and without a bias: the schema, the
  autograd registration, the fake implementation and AOT dispatch.
* ``dense`` on CPU tensors, bf16 or f32, is the plain formula
  (``dense_reference``) bit for bit, forward and backward, and launches
  nothing.
* The operator's CPU implementation gives ``dot_f32``'s bits (f32 products
  of the operands, the f32 bias, one rounding), and autograd through it the
  plain formula's dx, dW and db bits, with the f32 weight and bias as the
  model holds them.
* ``torch.export`` traces one call of the operator as one node.
* The CUDA implementation's checks raise ValueError before any launch.
* Against flax's ``nn.Dense(dtype=bfloat16)`` of the JAX package's model,
  within its two bf16 roundings.

The CUDA implementation, ``csrc/outer_dense.cu``, is compared with the plain
formula on the card by tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pangu_tpu_torch.ops import fused_block_attention as tfba

OP = tfba.DENSE_OP
#: (rows, k, n): the shapes of the outsides' products, cut in rows
SHAPES = [(96, 112, 192), (50, 192, 192), (40, 768, 384), (30, 384, 768), (64, 384, 160),
          (33, 384, 64)]


def _operands(rows, k, n, bias=True, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, k, generator=gen).to(dtype)
    w = torch.randn(n, k, generator=gen) * k ** -0.5
    b = torch.randn(n, generator=gen) if bias else None
    dy = torch.randn(rows, n, generator=gen).to(dtype)
    return x, w, b, dy


def _grads(fn, x, w, b, dy):
    """(y, dx, dW, db) of ``fn(x, w, b)`` with x, the f32 weight and bias as leaves."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, b) if t is not None]
    y = fn(*leaves)
    y.backward(dy)
    return (y.detach(), *(t.grad for t in leaves))


@pytest.mark.parametrize("bias", [True, False])
def test_opcheck(bias):
    x, w, b, _ = _operands(24, 112, 64, bias)
    args = (x.requires_grad_(), w.to(torch.bfloat16).requires_grad_(),
            None if b is None else b.requires_grad_())
    result = torch.library.opcheck(OP, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_operator_registrations():
    name = OP.name()
    assert name == "pangu_tpu_torch::dense"
    for key in ("CPU", "CUDA"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key), key


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,k,n", SHAPES)
def test_dense_on_the_cpu_is_the_plain_formula_and_launches_nothing(rows, k, n, dtype):
    """CPU operands of either dtype take the plain formula: its bits forward
    and backward, both counters unchanged, and no call of the operator."""
    x, w, b, dy = _operands(rows, k, n, dtype=dtype, seed=rows)
    before = (tfba.DENSE_LAUNCHES, tfba.DENSE_BWD_LAUNCHES)
    got = _grads(tfba.dense, x.reshape(1, rows, k), w, b, dy.reshape(1, rows, n))
    ref = _grads(tfba.dense_reference, x.reshape(1, rows, k), w, b, dy.reshape(1, rows, n))
    assert (tfba.DENSE_LAUNCHES, tfba.DENSE_BWD_LAUNCHES) == before
    assert all(g.dtype == r.dtype and torch.equal(g, r) for g, r in zip(got, ref))


def test_dense_on_the_cpu_does_not_call_the_operator(monkeypatch):
    def refuse(*args):
        raise AssertionError("the operator was called")

    monkeypatch.setattr(tfba, "DENSE_OP", refuse)
    x, w, b, _ = _operands(8, 64, 64)
    assert torch.equal(tfba.dense(x, w, b), tfba.dense_reference(x, w, b))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("rows,k,n", SHAPES)
def test_operator_on_the_cpu_gives_the_plain_formulas_bits(rows, k, n, bias):
    """The operator's CPU implementation: ``dot_f32``'s bits with the f32
    bias and one rounding; through autograd, from the f32 weight and bias as
    the model holds them, the plain formula's dx, dW and db bits."""
    x, w, b, dy = _operands(rows, k, n, bias, seed=k + n)
    wb = w.to(torch.bfloat16)
    y = OP(x, wb, b)
    want = tfba.dot_f32(x, wb.t())
    assert torch.equal(y, (want if b is None else want + b).to(torch.bfloat16))

    def through_op(xl, wl, bl=None):
        return OP(xl, wl.to(torch.bfloat16), bl)

    got = _grads(through_op, x, w, b, dy)
    ref = _grads(tfba.dense_reference, x, w, b, dy)
    assert len(got) == len(ref) == (4 if bias else 3)
    assert all(g.dtype == r.dtype and torch.equal(g, r) for g, r in zip(got, ref))


def test_operator_gives_no_gradient_to_an_input_that_needs_none():
    x, w, b, dy = _operands(16, 112, 192)
    wl = w.to(torch.bfloat16).requires_grad_(True)
    OP(x, wl, b).backward(dy)
    assert x.grad is None and wl.grad is not None and wl.grad.dtype == torch.bfloat16


class _OneDense(torch.nn.Module):
    def __init__(self, k, n):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.randn(n, k) * k ** -0.5)
        self.bias = torch.nn.Parameter(torch.randn(n))

    def forward(self, x):
        return OP(x, self.weight.to(x.dtype), self.bias)


def test_export_holds_one_operator_call():
    from pangu_tpu_torch import serving

    module = _OneDense(112, 192).eval()
    x = _operands(40, 112, 192)[0]
    with torch.no_grad():
        program = torch.export.export(module, (x,))
        eager = module(x)
    ops = serving.graph_ops(program)
    assert ops[serving.DENSE_OP] == 1
    assert not [k for k in ops if k != serving.DENSE_OP and not k.startswith("aten::")]
    with torch.no_grad():
        assert torch.equal(program.module()(x), eager)


def test_kernel_checks_raise_before_any_launch():
    """What the Dense kernel does not take raises ValueError in its CUDA
    implementation before anything runs: a row stride that is not a multiple
    of 8, a non-contiguous inner dimension, mixed dtypes, and k or n that is
    not a multiple of 8; a well-formed call on CPU tensors raises too (the
    kernel takes CUDA tensors)."""
    x, w, b, dy = _operands(48, 112, 192)
    wb = w.to(torch.bfloat16)
    wide = torch.zeros(48, 116, dtype=torch.bfloat16)
    bad = {"row stride": (wide[:, :112], wb, b),
           "inner dimension": (x.t().contiguous().t(), wb, b),
           "dtypes": (x, w, b),
           "bias dtype": (x, wb, b.to(torch.bfloat16)),
           "k": (torch.zeros(48, 100, dtype=torch.bfloat16), wb[:, :100].contiguous(), b),
           "CUDA": (x, wb, b)}
    before = (tfba.DENSE_LAUNCHES, tfba.DENSE_BWD_LAUNCHES)
    for name, args in bad.items():
        with pytest.raises(ValueError):
            tfba._dense_launch(*args)
    with pytest.raises(ValueError):
        tfba._dense_bwd_launch(x, wb, dy[:, :96], True, True, True)
    assert (tfba.DENSE_LAUNCHES, tfba.DENSE_BWD_LAUNCHES) == before


def test_reference_functions_stay_plain(monkeypatch):
    """No ``*_reference`` of the ops runs the operator: K2's plain version
    projects with the plain formula."""
    from test_torch_ops import _both, _np_inputs

    def refuse(*args, **kw):
        raise AssertionError("dense was called")

    monkeypatch.setattr(tfba, "dense", refuse)
    monkeypatch.setattr(tfba, "DENSE_OP", refuse)
    args, (window, heads, scale) = _np_inputs(3, masked=True)
    tx = _both(args, True)[1]
    y = tfba.fused_block_attention_reference(*tx[:7], window, heads, scale)
    assert y.shape == tx[0].shape and bool(torch.isfinite(y.float()).all())


@pytest.mark.parametrize("rows,k,n", SHAPES[:3])
def test_operator_matches_flax_dense(rows, k, n):
    """The JAX package's ``nn.Dense(dtype=bfloat16)`` (f32 kernel and bias,
    the input and kernel in bf16) and the operator: flax rounds the product
    to bf16 and adds the bias rounded to bf16 in bf16, where the operator
    adds the f32 bias to the f32 sum and rounds once; with u = 2^-8, the
    bf16 unit roundoff, and s the f32 sum, the two lie within u (|s| + |b| +
    2 |y|)."""
    x, w, b, _ = _operands(rows, k, n, seed=n)
    layer = nn.Dense(n, dtype=jnp.bfloat16, param_dtype=jnp.float32)
    params = {"params": {"kernel": jnp.asarray(w.t().numpy()), "bias": jnp.asarray(b.numpy())}}
    ref = np.asarray(layer.apply(params, jnp.asarray(x.float().numpy(), jnp.bfloat16)),
                     np.float32)
    wb = w.to(torch.bfloat16)
    got = OP(x, wb, b).float().numpy()
    s = tfba.dot_f32(x, wb.t()).numpy()
    assert got.shape == ref.shape and jax.default_backend() == "cpu"
    bound = 2.0 ** -8 * (np.abs(s) + np.abs(b.numpy()) + 2 * np.maximum(np.abs(got), np.abs(ref)))
    np.testing.assert_array_less(np.abs(got - ref), bound + 1e-6)
