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

The CUDA implementation, the hand-written kernel, is compared with the plain
version on the card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from pangu_tpu.ops import fused_block_attention as fba
from pangu_tpu_torch.ops import fused_block_attention as tfba
from test_torch_ops import _assert_scaled_close, _both, _np_inputs, interpret_tpu_route  # noqa: F401

OP = tfba.FUSED_EARTH_BLOCK_OP


def _torch_inputs(seed, masked, dtype_bf16=True):
    args, statics = _np_inputs(seed, masked=masked)
    return _both(args, dtype_bf16)[1], statics


@pytest.mark.parametrize("masked", [False, True])
def test_opcheck(masked):
    tx, (window, heads, scale) = _torch_inputs(11, masked)
    result = torch.library.opcheck(OP, (*tx, list(window), heads, scale))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bf16", [True, False])
def test_operator_on_the_cpu_is_the_plain_version_bit_for_bit(masked, bf16):
    tx, statics = _torch_inputs(12, masked, bf16)
    ref = tfba.fused_earth_block_reference(*tx, *statics)
    before = tfba.LAUNCHES
    window, heads, scale = statics
    direct = OP(*tx, list(window), heads, scale)
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
        out = OP(*fake, list(window), heads, scale)
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
    assert len(calls) == 1 and calls[0][-3:] == (list(statics[0]), statics[1], statics[2])


@pytest.mark.parametrize("masked", [False, True])
def test_operator_matches_interpreted_pallas(interpret_tpu_route, masked):
    args, (window, heads, scale) = _np_inputs(15, masked=masked)
    jx, tx = _both(args, dtype_bf16=True)
    ref = np.asarray(fba.fused_earth_block(*jx, window, heads, scale), np.float32)
    got = OP(*tx, list(window), heads, scale)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    _assert_scaled_close(got.float().numpy(), ref, atol=0.04)
