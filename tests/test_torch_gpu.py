"""The port's CUDA kernel on the card (marker ``gpu``; skips without one).

Imports torch and numpy only, so it runs where jax is absent; the repo's
conftest imports jax, so on such a machine run it as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: the kernel against its plain version, both bf16 with the same
rounding points, atol 0.04 after scaling by max(1, max|ref|) (the bound of
tests/test_kernel_interpret.py: bf16 activations, f32 sums in another
order). The model step on the kernel path against the plain composition
(use_pallas_attention off, different rounding points): RMS 0.01 and max 0.1
in normalized output units, twice and four times the bf16-vs-f32 deviation
of docs/PARITY.md (RMS 0.005, max 0.026).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pangu_tpu.config import pangu_tiny
from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.interop.from_jax import init_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.ops import fused_block_attention as tfba
from pangu_tpu_torch.rollout import make_forecast_step

pytestmark = pytest.mark.gpu
WINDOW = (2, 6, 12)
T = 144


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _inputs(seed, device, b, z, hp, w, c, heads, masked, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    nt = (z // WINDOW[0]) * (hp // WINDOW[1])

    def mk(*s, dt=dtype, base=0.0):
        return torch.from_numpy(base + rng.standard_normal(s).astype(np.float32) * 0.1).to(device, dt)

    mask = (torch.from_numpy(np.where(rng.uniform(size=(nt, T, T)) > 0.8, -100.0, 0.0)
                             .astype(np.float32)).to(device) if masked else None)
    f32 = torch.float32
    return (mk(b, z, hp, w, c), mk(3 * c, c), mk(3 * c), mk(c, c), mk(c),
            mk(nt, heads, T, T, dt=f32), mask, mk(c, dt=f32, base=1.0), mk(c, dt=f32),
            mk(4 * c, c), mk(4 * c), mk(c, 4 * c), mk(c),
            mk(c, dt=f32, base=1.0), mk(c, dt=f32)), (WINDOW, heads, (c // heads) ** -0.5)


@pytest.mark.parametrize("b,c,heads,masked", [
    (1, 192, 6, False), (1, 192, 6, True), (2, 384, 12, True)])
def test_cuda_kernel_matches_plain_version(cuda_device, b, c, heads, masked):
    args, statics = _inputs(6, cuda_device, b, 4, 12, 48, c, heads, masked)
    before = tfba.LAUNCHES
    got = tfba.fused_earth_block(*args, *statics)
    torch.cuda.synchronize()
    assert tfba.LAUNCHES == before + 1
    ref = tfba.fused_earth_block_reference(*args, *statics)
    scale = max(1.0, ref.float().abs().max().item())
    assert ((got.float() - ref.float()).abs().max() / scale).item() < 0.04


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    args, statics = _inputs(7, cuda_device, 1, 2, 6, 24, 192, 6, True, dtype=torch.float32)
    with pytest.raises(ValueError):
        tfba.fused_earth_block(*args, *statics)  # f32 activations
    args, statics = _inputs(7, cuda_device, 1, 2, 6, 24, 128, 4, True)
    with pytest.raises(ValueError):
        tfba.fused_earth_block(*args, *statics)  # C outside (192, 384)


def test_forecast_step_at_full_width_runs_the_kernel(cuda_device):
    """Flagship widths on a small grid: one step through 4 kernel launches
    (depths 1), against the plain bf16 composition."""
    cfg = pangu_tiny(dims=(192, 384, 384, 192), heads=(6, 12, 12, 6),
                     compute_dtype="bfloat16", use_pallas_attention=True)
    m = cfg.model
    aux = synthetic_aux_constants(m, cfg.train, device=cuda_device)
    rng = np.random.default_rng(8)
    upper = torch.from_numpy(rng.standard_normal(
        (1, m.upper_vars, m.levels, m.lat, m.lon)).astype(np.float32)).to(cuda_device)
    surface = torch.from_numpy(rng.standard_normal(
        (1, m.surface_vars, m.lat, m.lon)).astype(np.float32)).to(cuda_device)
    outs = {}
    for fused in (True, False):
        model = PanguModel(dataclasses.replace(m, use_pallas_attention=fused)).to(cuda_device)
        init_params(model, seed=0)
        before = tfba.LAUNCHES
        ou, os_ = make_forecast_step(model, aux)(upper, surface)
        torch.cuda.synchronize()
        assert tfba.LAUNCHES - before == (sum(m.depths) if fused else 0)
        outs[fused] = ((ou - aux.upper_mean) / aux.upper_std,
                       (os_ - aux.surface_mean) / aux.surface_std)
    for got, ref in zip(outs[True], outs[False]):
        assert bool(torch.isfinite(got).all())
        d = (got - ref).float()
        assert d.abs().max().item() < 0.1 and d.pow(2).mean().sqrt().item() < 0.01
