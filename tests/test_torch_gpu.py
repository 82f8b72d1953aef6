"""The port's CUDA kernels on the card (marker ``gpu``; skips without one):
the inference block K1 (also for its determinism at both stages, shifted and
unshifted, at batch 2 and with a partial 64-row tile), the training attention
K2/K3 (K3 also for its determinism and its sums over a batch; K1's and K2's
window attention for the same bits on two runs and, at batch 2 with an odd
lon-window count, the single-sample calls' bits; K2 refusing a partial
projection tile before launch), the post-norm
residual K4/K5, the MLP tail K6/K7 (both, and K10, also for their determinism
and a partial 64-row tile), the
raw MLP K8/K9 (K8 also with a partial 64-row tile and for its determinism),
the training block K11/K12 (K12 also for its determinism), K1-K7 against the
bits of the tree before K8 and K12 moved to the Hopper engines, the inference
MLP tail K10, K2's
LN-epilogue mode (and the two-kernel block they make, against K1) and the
A/B kernels of the three scripts S1-S3
against their plain versions, the forecast step and flagship train steps on
the default route and the two A/B routes through the kernels, and the width
check of the entry points on a model the kernels do not take.

Imports torch and numpy only, so it runs where jax is absent; the repo's
conftest imports jax, so on such a machine run it as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: a kernel against its plain version, both bf16 with the same
rounding points, atol 0.04 after scaling by max(1, max|ref|) (the bound of
tests/test_kernel_interpret.py: bf16 activations, f32 sums in another
order; 0.05 for gradients), and for K2-K5 also RMS(d) / RMS(ref) < 0.01. The model step on the kernel path against the plain composition
(use_pallas_attention off, different rounding points): RMS 0.01 and max 0.1
in normalized output units, twice and four times the bf16-vs-f32 deviation
of docs/PARITY.md (RMS 0.005, max 0.026).
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pangu_tpu_torch.config import pangu_tiny
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


@pytest.mark.parametrize("c,heads,masked", [(192, 6, False), (192, 6, True), (384, 12, False),
                                          (384, 12, True)])
def test_cuda_block_is_deterministic_at_batch_two_with_a_partial_tile(cuda_device, c, heads,
                                                                     masked):
    """K1 (its token tail on the wgmma row engine) at both stage widths,
    shifted and unshifted, at batch 2 on a 2 x 6 x 60 grid: 1440 rows end in
    a partial 64-row tile. Against its plain version, and the same bits on a
    second call."""
    args, statics = _inputs(41, cuda_device, 2, 2, 6, 60, c, heads, masked)
    first = tfba.fused_earth_block(*args, *statics)
    second = tfba.fused_earth_block(*args, *statics)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert _bounded(first, tfba.fused_earth_block_reference(*args, *statics))


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


def _bounded(got, ref, tol=0.04, rms_tol=0.01):
    """max|d| / max(1, max|ref|) < tol and RMS(d) / RMS(ref) < rms_tol."""
    d = (got.float() - ref.float())
    ref = ref.float()
    return ((d.abs().max() / max(1.0, ref.abs().max().item())).item() < tol
            and (d.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item() < rms_tol)


def kernel_digests(device) -> dict:
    """The first 16 hex digits of the sha256 of every output of K1-K7 on
    fixed seeded inputs, at C 192 and 384 (one sample, two window types, four
    lon windows, masked): the forecast block K1, the training attention K2 and
    its backward K3, the post-norm residual K4/K5 and the MLP tail K6/K7 (a
    per-row branch scale)."""
    from pangu_tpu_torch.ops import fused_epilogue as tfep
    from pangu_tpu_torch.ops import fused_mlp as tfm

    def digest(t):
        return hashlib.sha256(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
                              .numpy().tobytes()).hexdigest()[:16]

    out = {}
    for c, heads in ((192, 6), (384, 12)):
        args, (window, heads, scale) = _inputs(21, device, 1, 4, 12, 48, c, heads, True)
        x, wqkv, bqkv, wproj, bproj, bias, mask = args[:7]
        gen = torch.Generator(device).manual_seed(22)
        g = (torch.randn(x.shape, generator=gen, device=device) * 0.1).to(torch.bfloat16)
        rows = x.numel() // c
        x2, g2 = x.reshape(rows, c), g.reshape(rows, c)
        s = 0.5 + torch.rand(rows, generator=gen, device=device)
        mlp = args[9:13] + args[13:15]
        with torch.no_grad():
            outs = {
                "K1": (tfba.fused_earth_block(*args, window, heads, scale),),
                "K2": (tfba.fused_block_attention(x, wqkv, bqkv, wproj, bproj, bias, mask, None,
                                                  None, window, heads, scale),),
                "K3": tfba.fused_block_attention_bwd(x, wqkv, bqkv, wproj, bias, mask, g,
                                                     window, heads, scale),
                "K4": (tfep.fused_residual_postnorm(x2, g2, args[7], args[8], s[:, None]),),
                "K5": tfep.fused_residual_postnorm_bwd(x2, g2, args[7], args[8], s),
                "K6": (tfm.fused_mlp_postnorm(x2, *mlp, s[:, None]),),
                "K7": tfm.fused_mlp_postnorm_bwd(x2, g2, *mlp, s),
            }
        torch.cuda.synchronize()
        for k, ts in outs.items():
            out[f"{k} C={c}"] = [digest(t) for t in ts]
    return out


#: kernel_digests of the tree before K8 and K12 moved to the Hopper engines
#: and K5, K7's hidden pass, the row engine and the wgmma product gained the
#: modes K12 uses (recorded on an NVIDIA H100 80GB HBM3): the forecast and
#: default train kernels must keep these bits
K1_K7_DIGESTS = {
    "K1 C=192": ["139fd244803dbfa5"],
    "K2 C=192": ["0d89ae672c9d3406"],
    "K3 C=192": [
        "35d40eff11d5c34c", "fbc76d4d5af8c6ad", "ab3964e499617abf", "0b5af25adaf8e1a4",
        "f2ea02c259373cd2", "e9eba50826476597"],
    "K4 C=192": ["a60d43e9f7f07326"],
    "K5 C=192": ["d8de6aa2547e1901", "44a0d18ba075e889", "208dee31d97297c2", "7a14b4471cb66753"],
    "K6 C=192": ["b1cd12953341f1cc"],
    "K7 C=192": [
        "ec4f699dbdbef01e", "5a8cee40f2a4650d", "da6aee45f066037c", "89cbe47c0ed69781",
        "f32fe48fa711a04e", "1a406769a3690471", "23e03f29b74390e7", "7430986ee9524133"],
    "K1 C=384": ["037bb3c00c2cfdc0"],
    "K2 C=384": ["128ac4dd5c258797"],
    "K3 C=384": [
        "2f8c8721b11649ec", "2fec486faf346708", "b2da11b66dfd9758", "2f7affd77049376b",
        "492ed5985c788444", "872ba0c39f731049"],
    "K4 C=384": ["1e17270cc1358d46"],
    "K5 C=384": ["2ec743145d006229", "8ee5674a565edb14", "185247c1fc20adf2", "1db1cc454700f56c"],
    "K6 C=384": ["85bdcaca66dc6a82"],
    "K7 C=384": [
        "e80649d2db55247e", "f397b2b27b8b6697", "b56ef0539ed0fb4c", "75ded0d21286773c",
        "916efe9c9a594517", "4f7d1e8be2b8d44d", "9c0f8b79f955590a", "2106193c39ddbd1d"],
}


def test_cuda_k1_to_k7_keep_their_bits(cuda_device):
    assert kernel_digests(cuda_device) == K1_K7_DIGESTS


@pytest.mark.parametrize("b,c,heads,masked", [
    (1, 192, 6, False), (1, 192, 6, True), (2, 384, 12, True)])
def test_cuda_attention_fwd_and_bwd_match_plain_versions(cuda_device, b, c, heads, masked):
    """K2 and K3 through autograd against their plain versions; six grads."""
    args, (window, heads, scale) = _inputs(9, cuda_device, b, 4, 12, 48, c, heads, masked)
    x, wqkv, bqkv, wproj, bproj, bias, mask = args[:7]
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, wqkv, bqkv, wproj, bproj, bias)]
    fwd, bwd = tfba.ATTN_FWD_LAUNCHES, tfba.ATTN_BWD_LAUNCHES
    y = tfba.fused_block_attention(*leaves[:6], mask, None, None, window, heads, scale)
    g = (torch.randn(y.shape, generator=torch.Generator(cuda_device).manual_seed(1),
                     device=cuda_device) * 0.1).to(torch.bfloat16)
    y.backward(g)
    torch.cuda.synchronize()
    assert (tfba.ATTN_FWD_LAUNCHES - fwd, tfba.ATTN_BWD_LAUNCHES - bwd) == (1, 1)
    assert _bounded(y, tfba.fused_block_attention_reference(*args[:7], window, heads, scale))
    ref = tfba.fused_block_attention_bwd_reference(x, wqkv, bqkv, wproj, bias, mask, g,
                                                   window, heads, scale)
    for name, leaf, r in zip(("x", "wqkv", "bqkv", "wproj", "bproj", "bias"), leaves, ref):
        assert leaf.grad.dtype == r.dtype and _bounded(leaf.grad, r, tol=0.05), name


@pytest.mark.parametrize("b,c,heads,masked", [(1, 192, 6, True), (2, 192, 6, False),
                                               (2, 384, 12, True)])
def test_cuda_attention_bwd_is_deterministic_and_sums_the_batch(cuda_device, b, c, heads, masked):
    """K3 called twice on the same inputs gives the same bits; at batch 2 it
    matches its plain version, its dx rows are the single-sample calls' bits
    and dbias, the weight and the bias grads are the sums of the two
    single-sample calls' (f32 sums in another order: the kernel bounds)."""
    args, (window, heads, scale) = _inputs(15, cuda_device, b, 4, 12, 48, c, heads, masked)
    x, wqkv, bqkv, wproj, _, bias, mask = args[:7]
    g = (torch.randn(x.shape, generator=torch.Generator(cuda_device).manual_seed(16),
                     device=cuda_device) * 0.1).to(torch.bfloat16)
    bargs = (wqkv, bqkv, wproj, bias, mask)
    first = tfba.fused_block_attention_bwd(x, *bargs, g, window, heads, scale)
    second = tfba.fused_block_attention_bwd(x, *bargs, g, window, heads, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(first, second))
    ref = tfba.fused_block_attention_bwd_reference(x, *bargs, g, window, heads, scale)
    for name, got, r in zip(("x", "wqkv", "bqkv", "wproj", "bproj", "bias"), first, ref):
        assert got.dtype == r.dtype and _bounded(got, r, tol=0.05), name
    if b == 2:
        each = [tfba.fused_block_attention_bwd(x[i:i + 1].contiguous(), *bargs,
                                               g[i:i + 1].contiguous(), window, heads, scale)
                for i in range(2)]
        assert torch.equal(first[0], torch.cat([e[0] for e in each]))
        for k, name in enumerate(("wqkv", "bqkv", "wproj", "bproj", "bias"), start=1):
            assert _bounded(first[k], each[0][k].float() + each[1][k].float(), tol=0.05), name


@pytest.mark.parametrize("c,heads,masked", [(192, 6, False), (192, 6, True), (384, 12, False),
                                          (384, 12, True)])
def test_cuda_window_attention_through_k1_and_k2_matches_plain_with_the_same_bits(
        cuda_device, c, heads, masked):
    """The window-attention kernel (scores and probabilities in mma.sync
    registers) through K1 and K2 (its projection on wgmma) at both stage
    widths, shifted and unshifted: against their plain versions with
    chip_smoke.py's bounds, and the same bits on a second call."""
    args, statics = _inputs(51, cuda_device, 1, 4, 12, 48, c, heads, masked)
    before = (tfba.LAUNCHES, tfba.ATTN_FWD_LAUNCHES)
    with torch.no_grad():
        k1 = [tfba.fused_earth_block(*args, *statics) for _ in range(2)]
        k2 = [tfba.fused_block_attention(*args[:7], None, None, *statics) for _ in range(2)]
    torch.cuda.synchronize()
    assert (tfba.LAUNCHES, tfba.ATTN_FWD_LAUNCHES) == (before[0] + 2, before[1] + 2)
    assert torch.equal(k1[0], k1[1]) and torch.equal(k2[0], k2[1])
    assert _bounded(k1[0], tfba.fused_earth_block_reference(*args, *statics))
    assert _bounded(k2[0], tfba.fused_block_attention_reference(*args[:7], *statics))


@pytest.mark.parametrize("c,heads,masked", [(192, 6, True), (384, 12, False)])
def test_cuda_window_attention_at_batch_two_with_odd_lon_windows_equals_single_samples(
        cuda_device, c, heads, masked):
    """K1 and K2 at batch 2 on a 4 x 12 x 36 grid (3 lon windows): each
    sample's rows are the bits of the single-sample call, and the batch is
    within the bounds of the plain versions."""
    args, statics = _inputs(52, cuda_device, 2, 4, 12, 36, c, heads, masked)
    x = args[0]
    with torch.no_grad():
        for fn, ref, rest in ((tfba.fused_earth_block, tfba.fused_earth_block_reference,
                               args[1:]),
                              (tfba.fused_block_attention, tfba.fused_block_attention_reference,
                               (*args[1:7], None, None))):
            both = fn(x, *rest, *statics)
            each = torch.cat([fn(x[i:i + 1].contiguous(), *rest, *statics) for i in range(2)])
            torch.cuda.synchronize()
            assert torch.equal(both, each), fn.__name__
            plain = (ref(x, *args[1:], *statics) if fn is tfba.fused_earth_block
                     else ref(*args[:7], *statics))
            assert _bounded(both, plain), fn.__name__


def test_cuda_attention_projection_refuses_a_partial_row_tile_before_launch(cuda_device):
    """K2 and its LN mode share ``_geometry``'s check with K3, whose tiles
    take token rows in multiples of 64 (for 144-token windows, multiples of
    576; the wgmma projection itself takes any row count): a 2 x 6 x 36 grid
    (432 rows) is refused with a ValueError before any launch, while K1,
    whose tail takes any row count, runs it within its bounds."""
    args, statics = _inputs(53, cuda_device, 1, 2, 6, 36, 192, 6, True)
    before = (tfba.ATTN_FWD_LAUNCHES, tfba.ATTN_LN_LAUNCHES)
    with pytest.raises(ValueError):
        tfba.fused_block_attention(*args[:7], None, None, *statics)
    with pytest.raises(ValueError):
        tfba.fused_block_attention(*args[:9], *statics)
    assert (tfba.ATTN_FWD_LAUNCHES, tfba.ATTN_LN_LAUNCHES) == before
    with torch.no_grad():
        got = tfba.fused_earth_block(*args, *statics)
    assert _bounded(got, tfba.fused_earth_block_reference(*args, *statics))


@pytest.mark.parametrize("c,rows", [(192, 4608), (384, 4608), (192, 720), (384, 720)])
def test_cuda_mlp_postnorm_bwd_is_deterministic_with_a_partial_tile(cuda_device, c, rows):
    """K7 on rows against its plain version, and the same bits on a second
    call; at C = 384 its wgmma hidden pass splits dx's columns over two
    warpgroups. 720 = 144 x 5 rows end in a partial 64-row tile (16 rows):
    the kernel computes it, masked (its loads read zeros past the last row,
    its stores stop there), rather than refusing it."""
    from pangu_tpu_torch.ops import fused_mlp as tfm

    gen = torch.Generator(cuda_device).manual_seed(17)

    def rn(*shape, dtype=torch.bfloat16, std=1.0, mean=0.0):
        return (mean + std * torch.randn(shape, generator=gen, device=cuda_device)).to(dtype)

    f32 = torch.float32
    args = (rn(rows, c), rn(rows, c), rn(4 * c, c, std=c ** -0.5), rn(4 * c, std=0.02),
            rn(c, 4 * c, std=(4 * c) ** -0.5), rn(c, std=0.02),
            rn(c, dtype=f32, mean=1.0, std=0.1), rn(c, dtype=f32, std=0.1),
            torch.full((rows,), 1.25, device=cuda_device))
    before = tfm.BWD_LAUNCHES
    first = tfm.fused_mlp_postnorm_bwd(*args)
    second = tfm.fused_mlp_postnorm_bwd(*args)
    torch.cuda.synchronize()
    assert tfm.BWD_LAUNCHES == before + 2
    assert all(torch.equal(p, q) for p, q in zip(first, second))
    ref = tfm.fused_mlp_postnorm_bwd_reference(*args)
    for name, got, r in zip(("x", "w1", "b1", "w2", "b2", "gamma", "beta", "s"), first, ref):
        assert got.dtype == r.dtype and _bounded(got, r, tol=0.05), name


@pytest.mark.parametrize("c,rows", [(192, 4608), (384, 4608), (192, 720), (384, 720)])
def test_cuda_mlp_postnorm_fwd_is_deterministic_with_a_partial_tile(cuda_device, c, rows):
    """K6 (the wgmma row engine) and K10 (the same kernel without a scale) on
    rows against their plain versions, and the same bits on a second call;
    720 = 144 x 5 rows end in a partial 64-row tile (16 rows), read as zeros
    and not stored. K10 equals K6 at s = 1 bit for bit."""
    from pangu_tpu_torch.ops import fused_mlp as tfm

    gen = torch.Generator(cuda_device).manual_seed(18)

    def rn(*shape, dtype=torch.bfloat16, std=1.0, mean=0.0):
        return (mean + std * torch.randn(shape, generator=gen, device=cuda_device)).to(dtype)

    f32 = torch.float32
    args = (rn(rows, c), rn(4 * c, c, std=c ** -0.5), rn(4 * c, std=0.02),
            rn(c, 4 * c, std=(4 * c) ** -0.5), rn(c, std=0.02),
            rn(c, dtype=f32, mean=1.0, std=0.1), rn(c, dtype=f32, std=0.1))
    s = 0.5 + torch.rand(rows, generator=gen, device=cuda_device)
    before = (tfm.FWD_LAUNCHES, tfm.BLOCK_LAUNCHES)
    with torch.no_grad():
        first = tfm.fused_mlp_postnorm(*args, s[:, None])
        second = tfm.fused_mlp_postnorm(*args, s[:, None])
        block = tfm.fused_mlp_block(*args)
        block2 = tfm.fused_mlp_block(*args)
        unit = tfm.fused_mlp_postnorm(*args, torch.ones(rows, 1, device=cuda_device))
    torch.cuda.synchronize()
    assert (tfm.FWD_LAUNCHES, tfm.BLOCK_LAUNCHES) == (before[0] + 3, before[1] + 2)
    assert torch.equal(first, second) and torch.equal(block, block2) and torch.equal(block, unit)
    assert _bounded(first, tfm.fused_mlp_postnorm_reference(*args, s))
    assert _bounded(block, tfm.fused_mlp_block_reference(*args))


@pytest.mark.parametrize("c", [192, 384])
def test_cuda_residual_postnorm_fwd_and_bwd_match_plain_versions(cuda_device, c):
    """K4 and K5 through autograd against their plain versions, with a
    per-sample branch scale."""
    from pangu_tpu_torch.ops import fused_epilogue as tfep

    gen = torch.Generator(cuda_device).manual_seed(2)
    bf = torch.bfloat16

    def rn(*shape, dtype=bf, std=1.0, mean=0.0):
        return (mean + std * torch.randn(shape, generator=gen, device=cuda_device)).to(dtype)

    shortcut, a = rn(2, 4, 12, 48, c), rn(2, 4, 12, 48, c)
    gamma, beta = rn(c, dtype=torch.float32, mean=1.0, std=0.1), rn(c, dtype=torch.float32, std=0.1)
    s = torch.tensor([0.0, 1.25], device=cuda_device).reshape(2, 1, 1, 1, 1)
    leaves = [t.detach().clone().requires_grad_(True) for t in (shortcut, a, gamma, beta, s)]
    fwd, bwd = tfep.FWD_LAUNCHES, tfep.BWD_LAUNCHES
    out = tfep.fused_residual_postnorm(*leaves)
    g = rn(*out.shape)
    out.backward(g)
    torch.cuda.synchronize()
    assert (tfep.FWD_LAUNCHES - fwd, tfep.BWD_LAUNCHES - bwd) == (1, 1)
    rows = a.numel() // c
    s_rows = s.expand(2, 4, 12, 48, 1).reshape(rows).contiguous()
    ref = tfep.fused_residual_postnorm_reference(shortcut.reshape(rows, c), a.reshape(rows, c),
                                                 gamma, beta, s_rows)
    assert _bounded(out.reshape(rows, c), ref)
    da, dgamma, dbeta, ds = tfep.fused_residual_postnorm_bwd_reference(
        a.reshape(rows, c), g.reshape(rows, c), gamma, beta, s_rows)
    assert torch.equal(leaves[0].grad, g)
    for name, got, r in (("a", leaves[1].grad.reshape(rows, c), da), ("gamma", leaves[2].grad, dgamma),
                         ("beta", leaves[3].grad, dbeta),
                         ("s", leaves[4].grad.reshape(2), ds.reshape(2, -1).sum(1))):
        assert _bounded(got, r, tol=0.05), name


@pytest.mark.parametrize("c", [192, 384])
def test_cuda_mlp_postnorm_fwd_and_bwd_match_plain_versions(cuda_device, c):
    """K6 and K7 through autograd against their plain versions, all eight
    gradients, with a per-sample branch scale."""
    from pangu_tpu_torch.ops import fused_mlp as tfm

    gen = torch.Generator(cuda_device).manual_seed(5)
    bf = torch.bfloat16

    def rn(*shape, dtype=bf, std=1.0, mean=0.0):
        return (mean + std * torch.randn(shape, generator=gen, device=cuda_device)).to(dtype)

    f32 = torch.float32
    args = (rn(2, 4, 12, 48, c), rn(4 * c, c, std=c ** -0.5), rn(4 * c, std=0.02),
            rn(c, 4 * c, std=(4 * c) ** -0.5), rn(c, std=0.02),
            rn(c, dtype=f32, mean=1.0, std=0.1), rn(c, dtype=f32, std=0.1),
            torch.tensor([0.0, 1.25], device=cuda_device).reshape(2, 1, 1, 1, 1))
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    fwd, bwd = tfm.FWD_LAUNCHES, tfm.BWD_LAUNCHES
    out = tfm.fused_mlp_postnorm(*leaves)
    g = rn(*out.shape)
    out.backward(g)
    torch.cuda.synchronize()
    assert (tfm.FWD_LAUNCHES - fwd, tfm.BWD_LAUNCHES - bwd) == (1, 1)
    rows = out.numel() // c
    s_rows = args[7].expand(2, 4, 12, 48, 1).reshape(rows).contiguous()
    x2 = args[0].reshape(rows, c)
    assert _bounded(out.reshape(rows, c),
                    tfm.fused_mlp_postnorm_reference(x2, *args[1:7], s_rows))
    ref = tfm.fused_mlp_postnorm_bwd_reference(x2, g.reshape(rows, c), *args[1:7], s_rows)
    ref = ref[:7] + (ref[7].reshape(2, -1).sum(1),)
    for name, leaf, r in zip(("x", "w1", "b1", "w2", "b2", "gamma", "beta", "s"), leaves, ref):
        assert leaf.grad.dtype == r.dtype and _bounded(leaf.grad.reshape(r.shape), r,
                                                       tol=0.05), name


def test_cuda_training_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    """On a CUDA tensor the training wrappers launch or raise: no plain
    fallback for f32 activations, a width outside (192, 384) or a row count
    the MLP kernels do not take."""
    from pangu_tpu_torch.ops import fused_epilogue as tfep
    from pangu_tpu_torch.ops import fused_mlp as tfm

    for dtype, c, heads in ((torch.float32, 192, 6), (torch.bfloat16, 128, 4)):
        args, statics = _inputs(10, cuda_device, 1, 4, 12, 48, c, heads, True, dtype=dtype)
        before = (tfba.ATTN_FWD_LAUNCHES, tfba.ATTN_BWD_LAUNCHES)
        with pytest.raises(ValueError):
            tfba.fused_block_attention(*args[:7], None, None, *statics)
        with pytest.raises(ValueError):
            tfba.fused_block_attention_bwd(*args[:4], args[5], args[6], args[0], *statics)
        assert (tfba.ATTN_FWD_LAUNCHES, tfba.ATTN_BWD_LAUNCHES) == before
    x = torch.zeros(64, 192, device=cuda_device)
    ln = torch.ones(192, device=cuda_device)
    with pytest.raises(ValueError):
        tfep.fused_residual_postnorm(x, x, ln, ln, torch.ones(64, 1, device=cuda_device))
    w1, w2 = torch.zeros(768, 192, device=cuda_device), torch.zeros(192, 768, device=cuda_device)
    b1, b2 = torch.zeros(768, device=cuda_device), torch.zeros(192, device=cuda_device)
    bf = torch.bfloat16
    before = (tfm.FWD_LAUNCHES, tfm.BWD_LAUNCHES)
    for rows, dtype in ((96, torch.float32), (64, bf)):  # f32 rows; 64 rows, not a multiple of 48
        xr = torch.zeros(rows, 192, device=cuda_device, dtype=dtype)
        with pytest.raises(ValueError):
            tfm.fused_mlp_postnorm(xr, w1.to(dtype), b1.to(dtype), w2.to(dtype), b2.to(dtype),
                                   ln, ln, torch.ones(rows, 1, device=cuda_device))
    assert (tfm.FWD_LAUNCHES, tfm.BWD_LAUNCHES) == before


def test_flagship_train_step_launches_the_training_kernels(cuda_device):
    """One flagship train step (remat on, the config's flags keep the
    attention and MLP outputs): K2 and K6 run 16 times, K4 32 times (the
    checkpoint recompute runs it again), K3, K5 and K7 16 times; loss and
    gradients finite."""
    from pangu_tpu_torch import pangu_pretrain
    from pangu_tpu_torch.ops import fused_epilogue as tfep
    from pangu_tpu_torch.ops import fused_mlp as tfm
    from pangu_tpu_torch.train import Batch, make_optimizer, make_train_step

    cfg = pangu_pretrain(24, compute_dtype="bfloat16", matmul_precision="default",
                         use_pallas_attention=True)
    m = cfg.model
    model = PanguModel(m).to(cuda_device)
    init_params(model, seed=0)
    aux = synthetic_aux_constants(m, cfg.train, device=cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(3)
    fields = [aux.upper_mean + aux.upper_std * torch.randn(
        (1, m.upper_vars, m.levels, m.lat, m.lon), generator=gen, device=cuda_device),
              aux.surface_mean + aux.surface_std * torch.randn(
        (1, m.surface_vars, m.lat, m.lon), generator=gen, device=cuda_device)]
    batch = Batch(*fields, *(f + 0.1 * torch.randn(f.shape, generator=gen, device=cuda_device)
                             for f in fields))
    step = make_train_step(model, cfg, make_optimizer(model, cfg))

    def counts():
        return (tfba.ATTN_FWD_LAUNCHES, tfba.ATTN_BWD_LAUNCHES, tfep.FWD_LAUNCHES,
                tfep.BWD_LAUNCHES, tfm.FWD_LAUNCHES, tfm.BWD_LAUNCHES)

    before = counts()
    loss = step(batch, aux, torch.Generator(cuda_device).manual_seed(4))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (16, 16, 32, 16, 16, 16)
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())


def test_cuda_entry_points_check_the_widths_before_any_launch(cuda_device):
    """``pangu_tiny`` on the kernel route (C 16/32, head dim 8) raises
    ValueError at the CUDA entry points -- the forecast step, the train step
    and the model's forward -- before any kernel launches."""
    from pangu_tpu_torch.ops import fused_epilogue as tfep
    from pangu_tpu_torch.ops import fused_mlp as tfm
    from pangu_tpu_torch.train import Batch, make_optimizer, make_train_step

    cfg = pangu_tiny(compute_dtype="bfloat16", use_pallas_attention=True)
    m = cfg.model
    model = PanguModel(m).to(cuda_device)
    aux = synthetic_aux_constants(m, cfg.train, device=cuda_device)
    upper = torch.zeros((1, m.upper_vars, m.levels, m.lat, m.lon), device=cuda_device)
    surface = torch.zeros((1, m.surface_vars, m.lat, m.lon), device=cuda_device)

    def counts():
        return (tfba.LAUNCHES, tfba.ATTN_FWD_LAUNCHES, tfep.FWD_LAUNCHES, tfm.FWD_LAUNCHES)

    before = counts()
    with pytest.raises(ValueError, match="use_pallas_attention=False"):
        make_forecast_step(model, aux)
    with pytest.raises(ValueError, match="head dims"):
        make_train_step(model, cfg, make_optimizer(model, cfg))
    for mode in (model.eval, model.train):
        mode()
        with pytest.raises(ValueError, match="dims"):
            model(upper, surface, aux, torch.Generator(cuda_device).manual_seed(0))
    assert counts() == before
    plain = PanguModel(dataclasses.replace(m, use_pallas_attention=False)).to(cuda_device)
    ou, _ = make_forecast_step(plain, aux)(upper, surface)
    assert bool(torch.isfinite(ou).all()) and counts() == before
    step = make_train_step(plain, dataclasses.replace(cfg, model=plain.cfg),
                           make_optimizer(plain, cfg))
    assert bool(torch.isfinite(step(Batch(upper, surface, upper, surface), aux,
                                    torch.Generator(cuda_device).manual_seed(1))))


@pytest.mark.parametrize("c", [192, 384])
def test_cuda_raw_mlp_fwd_and_bwd_match_plain_versions(cuda_device, c):
    """K8 and K9 through autograd against their plain versions, five grads."""
    from pangu_tpu_torch.ops import fused_mlp as tfm

    gen = torch.Generator(cuda_device).manual_seed(11)

    def rn(*shape, std=1.0):
        return (std * torch.randn(shape, generator=gen, device=cuda_device)).to(torch.bfloat16)

    args = (rn(2, 4, 12, 48, c), rn(4 * c, c, std=c ** -0.5), rn(4 * c, std=0.02),
            rn(c, 4 * c, std=(4 * c) ** -0.5), rn(c, std=0.02))
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    fwd, bwd = tfm.RAW_FWD_LAUNCHES, tfm.RAW_BWD_LAUNCHES
    out = tfm.fused_mlp(*leaves)
    g = rn(*out.shape)
    out.backward(g)
    torch.cuda.synchronize()
    assert (tfm.RAW_FWD_LAUNCHES - fwd, tfm.RAW_BWD_LAUNCHES - bwd) == (1, 1)
    rows = out.numel() // c
    x2 = args[0].reshape(rows, c)
    assert _bounded(out.reshape(rows, c), tfm.fused_mlp_reference(x2, *args[1:]))
    ref = tfm.fused_mlp_bwd_reference(x2, g.reshape(rows, c), *args[1:])
    for name, leaf, r in zip(("x", "w1", "b1", "w2", "b2"), leaves, ref):
        assert leaf.grad.dtype == r.dtype and _bounded(leaf.grad.reshape(r.shape), r,
                                                       tol=0.05), name


@pytest.mark.parametrize("c,rows", [(192, 4608), (384, 4608), (192, 720), (384, 720)])
def test_cuda_raw_mlp_fwd_is_deterministic_with_a_partial_tile(cuda_device, c, rows):
    """K8 (the row kernel's raw mode) on rows against its plain version, and
    the same bits on a second call; 720 = 144 x 5 rows end in a partial 64-row
    tile (16 rows), read as zeros and not stored."""
    from pangu_tpu_torch.ops import fused_mlp as tfm

    gen = torch.Generator(cuda_device).manual_seed(19)

    def rn(*shape, std=1.0):
        return (std * torch.randn(shape, generator=gen, device=cuda_device)).to(torch.bfloat16)

    args = (rn(rows, c), rn(4 * c, c, std=c ** -0.5), rn(4 * c, std=0.02),
            rn(c, 4 * c, std=(4 * c) ** -0.5), rn(c, std=0.02))
    before = tfm.RAW_FWD_LAUNCHES
    with torch.no_grad():
        first = tfm.fused_mlp(*args)
        second = tfm.fused_mlp(*args)
    torch.cuda.synchronize()
    assert tfm.RAW_FWD_LAUNCHES == before + 2 and torch.equal(first, second)
    assert _bounded(first, tfm.fused_mlp_reference(*args))


@pytest.mark.parametrize("b,c,heads,masked", [
    (1, 192, 6, False), (2, 192, 6, True), (2, 384, 12, True)])
def test_cuda_block_train_fwd_and_bwd_match_plain_versions(cuda_device, b, c, heads, masked):
    """K11 and K12 through autograd against their plain versions, sixteen
    grads (the mask has none); per-sample scales s1 != s2; the backward gives
    the same bits twice; K11 at unit scales against K1."""
    from pangu_tpu_torch.ops import fused_block_train as tfbt

    args, statics = _inputs(12, cuda_device, b, 4, 12, 48, c, heads, masked)
    s1 = torch.tensor([1.25, 0.8][:b], device=cuda_device)
    s2 = torch.tensor([0.8, 0.0][:b], device=cuda_device).reshape(b, 1)  # b = 2: one dropped
    diff = args[:6] + args[7:] + (s1, s2)
    leaves = [t.detach().clone().requires_grad_(True) for t in diff]
    fwd, bwd = tfbt.FWD_LAUNCHES, tfbt.BWD_LAUNCHES
    out = tfbt.fused_earth_block_train(*leaves[:6], args[6], *leaves[6:], *statics)
    g = (torch.randn(out.shape, generator=torch.Generator(cuda_device).manual_seed(13),
                     device=cuda_device) * 0.1).to(torch.bfloat16)
    out.backward(g)
    torch.cuda.synchronize()
    assert (tfbt.FWD_LAUNCHES - fwd, tfbt.BWD_LAUNCHES - bwd) == (1, 1)
    assert _bounded(out, tfbt.fused_earth_block_train_reference(*args, s1, s2, *statics))
    ref = tfbt.fused_earth_block_train_bwd_reference(*args, s1, s2, g, *statics)
    for name, leaf, r in zip(tfbt.GRAD_NAMES, leaves, ref):
        assert leaf.grad.dtype == r.dtype and leaf.grad.shape == r.shape, name
        assert _bounded(leaf.grad, r, tol=0.05), name
    again = tfbt.fused_earth_block_train_bwd(*args, s1, s2, g, *statics)
    assert all(torch.equal(a, leaf.grad) for a, leaf in zip(again, leaves))
    one = torch.ones(b, device=cuda_device)
    with torch.no_grad():
        assert _bounded(tfbt.fused_earth_block_train(*args, one, one, *statics),
                        tfba.fused_earth_block(*args, *statics))


def test_cuda_ab_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    """On a CUDA tensor K8 and K11 launch or raise: no plain fallback for f32
    activations, a width outside (192, 384) or a row count they do not
    take."""
    from pangu_tpu_torch.ops import fused_block_train as tfbt
    from pangu_tpu_torch.ops import fused_mlp as tfm

    one = torch.ones(1, device=cuda_device)
    for dtype, c, heads in ((torch.float32, 192, 6), (torch.bfloat16, 128, 4)):
        args, statics = _inputs(14, cuda_device, 1, 4, 12, 48, c, heads, True, dtype=dtype)
        with pytest.raises(ValueError):
            tfbt.fused_earth_block_train(*args, one, one, *statics)
    args, statics = _inputs(14, cuda_device, 1, 2, 6, 24, 192, 6, False)  # 288 rows
    with pytest.raises(ValueError):
        tfbt.fused_earth_block_train(*args, one, one, *statics)
    w1 = torch.zeros(768, 192, device=cuda_device, dtype=torch.bfloat16)
    b1 = torch.zeros(768, device=cuda_device, dtype=torch.bfloat16)
    before = (tfbt.FWD_LAUNCHES, tfm.RAW_FWD_LAUNCHES)
    for rows, dtype in ((96, torch.float32), (64, torch.bfloat16)):
        xr = torch.zeros(rows, 192, device=cuda_device, dtype=dtype)
        with pytest.raises(ValueError):
            tfm.fused_mlp(xr, w1.to(dtype), b1.to(dtype), w1.t().contiguous().to(dtype),
                          b1[:192].to(dtype))
    assert (tfbt.FWD_LAUNCHES, tfm.RAW_FWD_LAUNCHES) == before


@pytest.mark.parametrize("variant,want", [
    ("fused_block", {"fused_earth_block_train": 16, "fused_earth_block_train_bwd": 16}),
    ("unfused_tail", {"fused_block_attention": 16, "fused_block_attention_bwd": 16,
                      "fused_residual_postnorm": 32, "fused_residual_postnorm_bwd": 16,
                      "fused_mlp": 16, "fused_mlp_bwd": 16})])
def test_flagship_ab_route_steps_launch_their_kernels(cuda_device, variant, want):
    """One flagship train step (remat on, attention and MLP outputs kept) per
    A/B route through the A/B script: exactly the route's launches (K11 is
    not checkpointed), finite step time and peak memory."""
    from pangu_tpu_torch.scripts import bench_train_ab

    res = bench_train_ab.run_variant(variant, warmup=0, steps=1, device=cuda_device)
    assert res["launches_per_step"] == want
    assert res["step_s"] > 0 and res["peak_bytes"] > 0


@pytest.mark.parametrize("c,heads", [(192, 6), (384, 12)])
def test_cuda_inference_tail_kernels_match_plain_versions(cuda_device, c, heads):
    """K10 and K2's LN mode against their plain versions (K10 with the same
    bits as K6 at s = 1); the two-kernel block through the module entry points
    against K1 (they differ by one bf16 rounding of x1), one launch each."""
    from pangu_tpu_torch.model.attention import EarthAttention3D
    from pangu_tpu_torch.model.blocks import Mlp
    from pangu_tpu_torch.ops import fused_mlp as tfm

    args, statics = _inputs(40, cuda_device, 1, 4, 12, 48, c, heads, True)
    x, mask = args[0], args[6]
    rows = x.reshape(-1, c)
    margs = (rows, *args[9:13], args[13], args[14])
    got = tfm.fused_mlp_block(*margs)
    torch.cuda.synchronize()
    ref = tfm.fused_mlp_block_reference(*margs)
    assert (got.float() - ref.float()).abs().max().item() / max(1.0, ref.float().abs().max()
                                                                 .item()) < 0.04
    assert torch.equal(got, tfm.fused_mlp_postnorm(*margs, torch.ones(rows.shape[0], 1,
                                                                      device=cuda_device)))
    fargs = (*args[:7], args[7], args[8], *statics)
    got = tfba.fused_block_attention(*fargs)
    torch.cuda.synchronize()
    ref = tfba.fused_block_attention_reference(*args[:7], *statics, args[7], args[8])
    d = (got.float() - ref.float())
    assert d.abs().max().item() / max(1.0, ref.float().abs().max().item()) < 0.04
    assert (d.pow(2).mean().sqrt() / ref.float().pow(2).mean().sqrt()).item() < 0.01

    class Stage:  # the module reads only these of a StageGeometry
        window, tokens_per_window, n_type_windows = WINDOW, T, args[5].shape[0]

    attn = EarthAttention3D(c, heads, Stage, use_kernel=True).to(cuda_device).eval()
    mlp = Mlp(c).to(cuda_device).eval()
    with torch.no_grad():
        for p, a in ((attn.linear1.weight, args[1]), (attn.linear1.bias, args[2]),
                     (attn.linear2.weight, args[3]), (attn.linear2.bias, args[4]),
                     (attn.earth_specific_bias, args[5][None]), (mlp.linear1.weight, args[9]),
                     (mlp.linear1.bias, args[10]), (mlp.linear2.weight, args[11]),
                     (mlp.linear2.bias, args[12])):
            p.copy_(a.float())
        before = (tfba.ATTN_LN_LAUNCHES, tfm.BLOCK_LAUNCHES)
        two = mlp(attn(x, mask, epilogue=(args[7], args[8])), ln=(args[13], args[14]),
                  fused=True)
        torch.cuda.synchronize()
        assert (tfba.ATTN_LN_LAUNCHES, tfm.BLOCK_LAUNCHES) == (before[0] + 1, before[1] + 1)
        ref = tfba.fused_earth_block(*args, *statics)
    d = (two.float() - ref.float())
    assert d.abs().max().item() / max(1.0, ref.float().abs().max().item()) < 0.04
    assert (d.pow(2).mean().sqrt() / ref.float().pow(2).mean().sqrt()).item() < 0.01


@pytest.mark.parametrize("variant", ["loop", "blockdiag", "qblockdiag", "loop_int8"])
def test_cuda_mxu_micro_matches_plain_version(cuda_device, variant):
    from pangu_tpu_torch.scripts import bench_mxu_micro as m

    qkv, qkv8 = m.make_inputs(cuda_device)
    x = (qkv8 if variant == "loop_int8" else qkv)[:4].contiguous()
    for sweeps in (1, 8):
        before = m.LAUNCHES[variant]
        got = m.mxu_micro(variant, x, sweeps)
        torch.cuda.synchronize()
        assert m.LAUNCHES[variant] == before + 1
        ref = m.mxu_micro_reference(variant, x, sweeps)
        tol = m.TOL[variant] if sweeps == 1 else 1e-4  # int8: exact only below 2^24
        assert ((got - ref).abs().max() / ref.abs().max()).item() < tol


@pytest.mark.parametrize("variant", ["batched", "dbl", "quad"])
def test_cuda_attn_fwd_ab_variant_matches_plain_and_shipped(cuda_device, variant):
    from pangu_tpu_torch.scripts import bench_attn_fwd_ab as f

    base, bias = f.make_args(cuda_device, (1, 2, 6, 48, 192, 6))
    res = f.compare_variant(variant, f.variant_args(variant, base, bias, {}), bias, {})
    assert res["ok"], res


def test_cuda_local_accum_matches_plain_and_shipped_with_the_same_bits(cuda_device):
    from pangu_tpu_torch.scripts import bench_attn_bwd_ab as bw

    args = bw.make_args(cuda_device, (1, 4, 12, 48, 192, 6))
    res = bw.compare_variant("local_accum", args, {})
    assert res["same_bits"] and res["vs_shipped"] <= bw.PARITY_TOL and res["ok"], res


def test_chip_smoke_passes_and_lists_the_twenty_one_kernels(cuda_device):
    """``python3 chip_smoke.py`` exits 0; the line before the last lists K1-K12,
    K2's LN mode and the script kernels with their launches over the run of
    their path: the forecast (K1), the 3 timed default train steps (K2-K7),
    the 3 timed steps of ``unfused_tail`` (K8/K9) and of ``fused_block``
    (K11/K12), the two-kernel block at one forecast step's mix (K10, K2 LN),
    and each script's timed run (2 warm-up + 10 or 12 timed calls)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=repo, capture_output=True,
                          text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    kernels = {k["name"]: k for k in json.loads(lines[-2])["kernels"]}
    assert {n: k["launches"] for n, k in kernels.items()} == {
        "fused_earth_block": 48, "fused_block_attention": 48, "fused_block_attention_bwd": 48,
        "fused_residual_postnorm": 96, "fused_residual_postnorm_bwd": 48,
        "fused_mlp_postnorm": 48, "fused_mlp_postnorm_bwd": 48,
        "fused_mlp": 48, "fused_mlp_bwd": 48,
        "fused_earth_block_train": 48, "fused_earth_block_train_bwd": 48,
        "fused_mlp_block": 16, "fused_block_attention_ln": 16,
        "bench_mxu_micro:loop": 12, "bench_mxu_micro:blockdiag": 12,
        "bench_mxu_micro:qblockdiag": 12, "bench_mxu_micro:loop_int8": 12,
        "bench_attn_fwd_ab:batched": 14, "bench_attn_fwd_ab:dbl": 14,
        "bench_attn_fwd_ab:quad": 14, "bench_attn_bwd_ab:local_accum": 14}
    assert all(k["route"] == "cuda" and k["ms"] > 0 and k["plain_ms"] > 0
               and 0 < k["bound_ms"] < k["ms"] and k["bound_by"] in ("bytes", "operations")
               and "library_ms" in k for k in kernels.values())
    assert kernels["bench_mxu_micro:loop"]["library_ms"] > 0
    score = [ln for ln in lines if ln.startswith("forecast and score: ")]
    assert len(score) == 1
    assert set(json.loads(score[0].split(": ", 1)[1])["eval_per_sample_s"]) == {
        "load", "h2d", "forecast", "score", "total"}
    assert json.loads(lines[-1])["ok"] is True
