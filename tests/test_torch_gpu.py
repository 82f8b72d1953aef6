"""The port's one on-card check (marker ``gpu``; every test skips without a
CUDA card):

* every kernel source builds (nvcc, one library a source);
* each kernel against its plain version: the inference block K1 (also
  for its determinism at both stages, shifted and unshifted, at batch 2
  and with a partial 64-row tile; its folded gather against the unfolded
  route, re-zero, ``torch.roll``, K1, roll back, at both flagship stages,
  the same bits on the real rows), the training attention K2/K3 (K3 also
  for its determinism and its sums over a batch; K1's and K2's window
  attention for the same bits on two runs and, at batch 2 with an odd
  lon-window count, the single-sample calls' bits; K2 refusing a partial
  projection tile before launch), the post-norm residual K4/K5, the MLP
  tail K6/K7 (both, and K10, also for their determinism and a partial
  64-row tile), the raw MLP K8/K9, the training block K11/K12, the
  inference MLP tail K10 and K2's LN-epilogue mode (and the two-kernel
  block they make, against K1), the A/B kernels of the three scripts
  S1-S3, FuXi's cosine window attention, and the Dense operator at the
  flagship's outside shapes and Aurora's resampler shapes; K1-K7 against
  the bits of the tree before K8 and K12 moved to the Hopper engines;
* the block and row kernels at the flagship stage shapes, and on the slabs
  of the flagship lat=2 x lon=2 plane;
* K1's operator and the exported step (in this process on a small grid,
  and at flagship geometry served by a fresh process);
* the flagship forecast steps and train steps (the default route and the
  three A/B routes) against the plain bf16 steps, merged and unmerged LoRA,
  ``Trainer.fit`` with its resume, the ``test`` and ``rollout`` scripts,
  an npy store read by the native reader, the pipeline's stages on one
  card, a FuXi-Short step;
* on a host with several cards, the rank workers of the data-parallel,
  spatial and pipeline tests over NCCL (``tests/torch_*_worker.py``'s
  ``card`` cases); each skips, saying why, where the host has too few.

Imports torch and numpy only, so it runs where jax is absent; the repo's
conftest imports jax, so on such a machine run it as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: a kernel against its plain version, both bf16 with the same
rounding points, atol 0.04 after scaling by max(1, max|ref|) (the bound of
tests/test_kernel_interpret.py: bf16 activations, f32 sums in another
order; 0.05 for gradients), and for K2-K5 also RMS(d) / RMS(ref) < 0.01;
at the flagship stage shapes every output and gradient is held to 0.04 and
0.01 both (``ab_common.compare``). The model step on the kernel path
against the plain composition (use_pallas_attention off, different rounding
points): RMS 0.01 and max 0.1 in normalized output units, twice and four
times the bf16-vs-f32 deviation of docs/PARITY.md (RMS 0.005, max 0.026).
A flagship train step against the plain bf16 step: ``torch_card.TRAIN_BOUNDS``.
"""

import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_card as card
from pangu_tpu_torch.config import pangu_tiny
from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.interop.from_jax import init_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.ops import fused_block_attention as tfba
from pangu_tpu_torch.rollout import make_forecast_step
from pangu_tpu_torch.train import make_optimizer, make_train_step

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
        before = (tfba.LAUNCHES, tfba.FOLDED_LAUNCHES)
        ou, os_ = make_forecast_step(model, aux)(upper, surface)
        torch.cuda.synchronize()
        assert tfba.LAUNCHES - before[0] == (sum(m.depths) if fused else 0)
        assert tfba.FOLDED_LAUNCHES - before[1] == tfba.LAUNCHES - before[0]
        outs[fused] = ((ou - aux.upper_mean) / aux.upper_std,
                       (os_ - aux.surface_mean) / aux.surface_std)
    for got, ref in zip(outs[True], outs[False]):
        assert bool(torch.isfinite(got).all())
        d = (got - ref).float()
        assert d.abs().max().item() < 0.1 and d.pow(2).mean().sqrt().item() < 0.01


#: the flagship stages: (Z, Hp, W, C, heads, real lat rows h)
FLAGSHIP_STAGES = {"outer": (8, 186, 360, 192, 6, 181), "inner": (8, 96, 180, 384, 12, 91)}


@pytest.mark.parametrize("junk", ["large", "nan"])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("stage", ["outer", "inner"])
def test_folded_k1_gives_the_unfolded_routes_bits_on_real_rows(cuda_device, stage, shifted,
                                                               junk):
    """K1 given the block's shift and real rows (the folded window gather)
    against the unfolded route: rows >= h re-zeroed, ``torch.roll`` by
    -shift, K1 without a fold, the roll back. The folded call's input holds
    large finite values or NaN in its pad rows, which it must read as zeros
    (a select, not a product). Real rows: the same bits."""
    z, hp, w, c, heads, h = FLAGSHIP_STAGES[stage]
    args, statics = _inputs(42, cuda_device, 1, z, hp, w, c, heads, masked=shifted)
    x = args[0].clone()
    x[:, :, h:] = float("nan") if junk == "nan" else 3e4
    shift = [k // 2 if shifted else 0 for k in WINDOW]
    before = (tfba.LAUNCHES, tfba.FOLDED_LAUNCHES)
    got = tfba.fused_earth_block(x, *args[1:], *statics, shift=shift, h=h)
    xr = torch.nn.functional.pad(x[:, :, :h], (0, 0, 0, 0, 0, hp - h))
    xr = torch.roll(xr, [-s for s in shift], dims=(1, 2, 3))
    ref = torch.roll(tfba.fused_earth_block(xr, *args[1:], *statics), shift, dims=(1, 2, 3))
    torch.cuda.synchronize()
    assert (tfba.LAUNCHES, tfba.FOLDED_LAUNCHES) == (before[0] + 2, before[1] + 1)
    assert torch.equal(got[:, :, :h], ref[:, :, :h])
    assert bool(torch.isfinite(got[:, :, :h].float()).all())


def test_cuda_operator_is_the_kernel_and_checks_its_arguments(cuda_device):
    """K1's operator on CUDA tensors is the hand-written kernel (one launch,
    the wrapper's bits) and refuses, inside its CUDA implementation, what the
    kernel does not take: f32 activations and a tensor on another device."""
    args, (window, heads, scale) = _inputs(9, cuda_device, 1, 2, 6, 24, 192, 6, True)
    before = tfba.LAUNCHES
    no_fold = ([0, 0, 0], args[0].shape[2])
    got = tfba.FUSED_EARTH_BLOCK_OP(*args, list(window), heads, scale, *no_fold)
    torch.cuda.synchronize()
    assert tfba.LAUNCHES == before + 1
    assert torch.equal(got, tfba.fused_earth_block(*args, window, heads, scale))
    bad = list(args)
    bad[0] = bad[0].float()
    with pytest.raises(ValueError, match="bfloat16"):
        tfba.FUSED_EARTH_BLOCK_OP(*bad, list(window), heads, scale, *no_fold)
    bad = list(args)
    bad[6] = bad[6].cpu()
    with pytest.raises(ValueError, match="argument 6"):
        tfba.FUSED_EARTH_BLOCK_OP(*bad, list(window), heads, scale, *no_fold)
    assert tfba.LAUNCHES == before + 2


def test_exported_step_at_full_width_launches_k1_with_the_eager_bits(cuda_device, tmp_path):
    """Flagship widths on a small grid, depths (2, 2, 2, 2): the exported
    step holds 8 K1 calls and 7 Dense calls, its tensors sit on the card, and
    the loaded step launches K1 8 times and the Dense kernel 7 times with the
    bits of the eager step."""
    from pangu_tpu_torch import serving

    cfg = pangu_tiny(dims=(192, 384, 384, 192), heads=(6, 12, 12, 6), depths=(2, 2, 2, 2),
                     compute_dtype="bfloat16", use_pallas_attention=True)
    m = cfg.model
    aux = synthetic_aux_constants(m, cfg.train, device=cuda_device)
    model = PanguModel(m).to(cuda_device)
    init_params(model, seed=0)
    path = str(tmp_path / "step.pt2")
    program = serving.export_forecast_step(model, aux, path)
    ops = serving.graph_ops(program)
    assert (ops[serving.K1_OP], ops[serving.DENSE_OP]) == (8, 7)
    step = serving.load_forecast_step(path)
    tensors = (*step.program.state_dict.values(), *step.program.constants.values())
    assert {t.device for t in tensors} == {torch.device(cuda_device)}
    rng = np.random.default_rng(8)
    upper = torch.from_numpy(rng.standard_normal(
        (1, m.upper_vars, m.levels, m.lat, m.lon)).astype(np.float32)).to(cuda_device)
    surface = torch.from_numpy(rng.standard_normal(
        (1, m.surface_vars, m.lat, m.lon)).astype(np.float32)).to(cuda_device)
    before = card.launches()
    got = step(upper, surface)
    torch.cuda.synchronize()
    assert card.launched(before) == {"fused_earth_block": 8, **card.FORECAST_DENSE}
    eager = make_forecast_step(model, aux)(upper, surface)
    assert all(torch.equal(g, e) for g, e in zip(got, eager))


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


# ---- the Dense product (csrc/outer_dense.cu) --------------------------------------------------

#: the outsides' seven Dense products of a flagship step at batch 1, (rows, k, n, bias): the
#: patch embedding's surface and upper projections, the downsampling, the upsampling's two
#: linears, the patch recovery's upper and surface projections
DENSE_SHAPES = {"embed_surface": (65160, 112, 192, True), "embed_upper": (456120, 192, 192, True),
                "down": (131040, 768, 384, False), "up1": (131040, 384, 768, False),
                "up2": (521280, 192, 192, False), "recover_upper": (456120, 384, 160, True),
                "recover_surface": (65160, 384, 64, True)}
#: f32 unit roundoff
_U32 = 2.0 ** -24


def _dense_operands(device, rows, k, n, bias, seed=0):
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn(rows, k, generator=gen, device=device).to(torch.bfloat16)
    w = torch.randn(n, k, generator=gen, device=device) * k ** -0.5
    b = torch.randn(n, generator=gen, device=device) if bias else None
    dy = torch.randn(rows, n, generator=gen, device=device).to(torch.bfloat16)
    return x, w, b, dy


def _dense_grads(fn, x, w, b, dy):
    """(y, dx, dW, db) of ``fn`` through autograd, x, the f32 weight and bias as leaves."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, b) if t is not None]
    y = fn(*leaves)
    y.backward(dy)
    return (y.detach(), *(t.grad for t in leaves), *([None] if b is None else []))


def _within_sum_order(got, ref, terms, depth, rounded=True):
    """``got`` and ``ref`` compute one function of exact products (a bf16 x bf16
    product is exact in f32) with f32 sums in two orders: each differs from the
    true sum by at most ~depth u sum|terms| (u = 2^-24; 2 depth u for the kernel,
    whose tensor-core sums may truncate), so 4 depth u sum|terms| bounds the
    two apart, plus, where both are rounded to bf16, one bf16 ulp (at most 2^-7
    of the larger magnitude). Besides, two f32 sums that far closer than a
    bf16 ulp round apart only rarely: the relative L2 of the difference under
    2^-9 (a quarter of the elements one ulp apart), 1e-5 for f32 results."""
    g, r = got.float(), ref.float()
    bound = 4 * depth * _U32 * terms + (2.0 ** -7 * torch.maximum(g.abs(), r.abs())
                                        if rounded else 0)
    rel = ((g - r).norm() / r.norm()).item()
    return bool(((g - r).abs() <= bound).all()) and rel < (2.0 ** -9 if rounded else 1e-5)


def _check_dense(device, rows, k, n, bias, seed=0):
    x, w, b, dy = _dense_operands(device, rows, k, n, bias, seed)
    before = (tfba.DENSE_LAUNCHES, tfba.DENSE_BWD_LAUNCHES)
    got = _dense_grads(tfba.dense, x, w, b, dy)
    torch.cuda.synchronize()
    assert (tfba.DENSE_LAUNCHES, tfba.DENSE_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref = _dense_grads(tfba.dense_reference, x, w, b, dy)
    assert (tfba.DENSE_LAUNCHES, tfba.DENSE_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    xa, wa, dya = x.float().abs(), w.to(torch.bfloat16).float().abs(), dy.float().abs()
    ba = 0 if b is None else b.abs()
    checks = {"y": (xa @ wa.t() + ba, k), "dx": (dya @ wa, n), "dw": (dya.t() @ xa, rows)}
    for name, g, r in zip(("y", "dx", "dw"), got, ref):
        assert g.dtype == r.dtype and _within_sum_order(g, r, *checks[name]), name
    if bias:
        assert got[3].dtype == torch.float32
        assert _within_sum_order(got[3], ref[3], dya.sum(0), rows, rounded=False), "db"
    return x, w, b, dy, got


@pytest.mark.parametrize("site", list(DENSE_SHAPES))
def test_cuda_dense_matches_the_plain_formula_at_the_outsides_shapes(cuda_device, site):
    """The operator forward and backward (dx, dW, db) against the plain
    formula on the card (f32 cuBLAS, TF32 off) at each of the seven products
    of a flagship step: one launch each way, within the sum-order bound."""
    _check_dense(cuda_device, *DENSE_SHAPES[site])


@pytest.mark.parametrize("site,rows", [("embed_surface", 2 * 65160), ("recover_upper", 2 * 456120),
                                       ("recover_upper", 1000), ("down", 1000),
                                       ("embed_surface", 1000)])
def test_cuda_dense_at_batch_two_and_a_partial_row_tile(cuda_device, site, rows):
    """Batch 2 and 1000 rows (not a multiple of the product's 192-row tile):
    within the sum-order bound of the plain formula, and the same bits on a
    second call, forward and backward."""
    _, k, n, bias = DENSE_SHAPES[site]
    x, w, b, dy, first = _check_dense(cuda_device, rows, k, n, bias, seed=rows)
    again = _dense_grads(tfba.dense, x, w, b, dy)
    assert all(p is q is None or torch.equal(p, q) for p, q in zip(first, again))


#: the resamplers' Dense products of an Aurora 0.25-degree step at batch 1, (rows, k, n, bias):
#: the two merges (LayerNorm, then 4C -> 2C) and each split's expansion (C -> 2C) and mixing
#: (C/2 -> C/2) linears
AURORA_DENSE_SHAPES = {"merge_512": (64800, 2048, 1024, False),
                       "merge_1024": (16200, 4096, 2048, False),
                       "split_2048": (16200, 2048, 4096, False),
                       "mix_1024": (64800, 1024, 1024, False),
                       "split_1024": (64800, 1024, 2048, False),
                       "mix_512": (259200, 512, 512, False)}


@pytest.mark.parametrize("site", list(AURORA_DENSE_SHAPES))
def test_cuda_dense_matches_the_plain_formula_at_auroras_resampler_shapes(cuda_device, site):
    """Aurora's merges and splits run ``model.blocks``' ``DownSample`` and
    ``UpSample``, so the operator at M up to 259,200, K up to 4,096 and N up
    to 4,096: forward and backward within the sum-order bound of the plain
    formula, one launch each way."""
    _check_dense(cuda_device, *AURORA_DENSE_SHAPES[site])


def test_cuda_dense_skips_what_no_input_needs_and_refuses_before_launch(cuda_device):
    """An input that needs no gradient gets none (the patch embedding's x);
    the operator on the card raises ValueError before any launch on a row
    stride that is not a multiple of 8, a non-contiguous inner dimension and
    mixed dtypes."""
    x, w, b, dy = _dense_operands(cuda_device, 960, 112, 192, True)
    wl = w.detach().clone().requires_grad_(True)
    before = (tfba.DENSE_LAUNCHES, tfba.DENSE_BWD_LAUNCHES)
    tfba.dense(x, wl, b).backward(dy)
    torch.cuda.synchronize()
    assert (tfba.DENSE_LAUNCHES, tfba.DENSE_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref = _dense_grads(tfba.dense_reference, x, w, b, dy)[2]
    assert _within_sum_order(wl.grad, ref, dy.float().abs().t() @ x.float().abs(), 960)
    wb = w.to(torch.bfloat16)
    wide = torch.zeros(960, 116, device=cuda_device, dtype=torch.bfloat16)
    bad = {"stride": (wide[:, :112], wb), "inner": (x.t().contiguous().t(), wb),
           "dtype": (x, w)}
    for name, (xa, wa) in bad.items():
        with pytest.raises(ValueError):
            tfba.DENSE_OP(xa, wa, b)
    assert (tfba.DENSE_LAUNCHES, tfba.DENSE_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)


def test_flagship_forecast_step_runs_its_outsides_on_the_dense_kernel(cuda_device):
    """One flagship forecast step launches the Dense kernel 7 times (the
    outsides' products) and K1 16 times, and a profile of it holds no f32
    cuBLAS product (``gemm_f32f32``) and no CUTLASS f32 kernel."""
    from torch.profiler import ProfilerActivity, profile

    cfg, model, aux = _flagship(cuda_device)
    batch = card.seeded_batch(aux, cfg.model, cuda_device)
    step = make_forecast_step(model, aux)
    step(batch.upper, batch.surface)
    torch.cuda.synchronize()
    before = card.launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(batch.upper, batch.surface)
        torch.cuda.synchronize()
    assert card.launched(before) == {"fused_earth_block": 16, "dense": 7}
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("outer_dense_kernel" in n for n in names), sorted(names)
    assert not [n for n in names if "f32f32" in n], sorted(names)


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
    widths, shifted and unshifted: against their plain versions with the
    kernel bounds, and the same bits on a second call."""
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


#: a flagship train step's launches on the default route and the three A/B routes
ROUTE_LAUNCHES = {
    "base": card.TRAIN_LAUNCHES, "bf16_grads": card.TRAIN_LAUNCHES,
    "fused_block": {"fused_earth_block_train": 16, "fused_earth_block_train_bwd": 16,
                    **card.TRAIN_DENSE},
    "unfused_tail": {"fused_block_attention": 16, "fused_block_attention_bwd": 16,
                     "fused_residual_postnorm": 32, "fused_residual_postnorm_bwd": 16,
                     "fused_mlp": 16, "fused_mlp_bwd": 16, **card.TRAIN_DENSE}}


@pytest.fixture(scope="module")
def plain_flagship_train_step():
    """One plain bf16 flagship train step (no block kernel; its Dense
    products on the Dense kernel, ``torch_card.PLAIN_TRAIN_LAUNCHES``) from
    seeded weights, batch and drop-path draws: the kernel routes' reference
    (its weights, aux constants, batch, loss and f32 gradients)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = card.flagship()
    with dev:
        model = PanguModel(dataclasses.replace(cfg.model, use_pallas_attention=False)).to(dev)
    init_params(model, seed=0)
    w0 = {k: v.clone() for k, v in model.state_dict().items()}
    aux = synthetic_aux_constants(cfg.model, cfg.train, device=dev)
    batch = card.seeded_batch(aux, cfg.model, dev)
    before = card.launches()
    loss = make_train_step(model, cfg, make_optimizer(model, cfg))(
        batch, aux, torch.Generator(dev).manual_seed(3)).item()
    assert card.launched(before) == card.PLAIN_TRAIN_LAUNCHES
    grads = {k: p.grad.float() for k, p in model.named_parameters()}
    return dict(cfg=cfg, w0=w0, aux=aux, batch=batch, loss=loss, grads=grads)


@pytest.mark.parametrize("route", list(ROUTE_LAUNCHES))
def test_flagship_train_route_matches_the_plain_bf16_step(cuda_device, plain_flagship_train_step,
                                                          route):
    """One flagship train step (remat on, the config's flags keep the
    attention and MLP outputs) on the default route (``base``) and each A/B
    route of ``scripts.bench_train_ab`` from the plain step's weights, batch
    and drop-path draws: exactly the route's launches (K4 twice a block on
    the checkpointed routes: the recompute runs it again; K11 is not
    checkpointed); a finite loss and finite gradients; every parameter with
    a gradient updated (a branch that drop path drops has none); against
    the plain bf16 step the loss within 1%, the gradient's global relative
    L2 < 1%, each earth-specific bias's relative L2 < 10% and every other
    parameter's < 2% (``torch_card.TRAIN_BOUNDS``)."""
    from pangu_tpu_torch.scripts import bench_train_ab

    ref = plain_flagship_train_step
    with bench_train_ab.variant_flags(route):
        cfg = ref["cfg"].replace(model=dataclasses.replace(
            ref["cfg"].model, grads_dtype=bench_train_ab.variant_config(route).model.grads_dtype))
        with cuda_device:
            model = PanguModel(cfg.model).to(cuda_device)
        model.load_state_dict(ref["w0"])
        before = card.launches()
        loss = make_train_step(model, cfg, make_optimizer(model, cfg))(
            ref["batch"], ref["aux"], torch.Generator(cuda_device).manual_seed(3)).item()
        torch.cuda.synchronize()
        assert card.launched(before) == ROUTE_LAUNCHES[route]
    named = dict(model.named_parameters())
    assert math.isfinite(loss) and all(bool(torch.isfinite(p.grad).all()) for p in named.values())
    assert not [k for k, p in named.items()
                if bool(p.grad.any()) and torch.equal(p.detach(), ref["w0"][k])]
    d = card.train_deviation(loss, {k: p.grad for k, p in named.items()}, ref["loss"],
                             ref["grads"])
    assert card.within_train_bounds(d), d


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


def _flagship(cuda_device, **kw):
    from pangu_tpu_torch import pangu_pretrain

    cfg = pangu_pretrain(24, compute_dtype="bfloat16", use_pallas_attention=True, **kw)
    with cuda_device:
        model = PanguModel(cfg.model).to(cuda_device)
    init_params(model, seed=0)
    return cfg, model, synthetic_aux_constants(cfg.model, cfg.train, device=cuda_device)


def _lora_step_against_plain(cuda_device, unmerged: bool):
    """One flagship LoRA step (rank 16, alpha 16, dropout 0, B drawn
    nonzero) in the merged or unmerged form, on the kernel route and on the
    plain bf16 route from the same weights, tree, batch and drop-path
    draws: (the kernel route's launches, the loss's relative deviation, the
    relative L2 of the adapters' and heads' gradient)."""
    from pangu_tpu_torch.train.lora import (LoraConfig, attach_lora, flatten_trainable,
                                            init_lora_params)
    from pangu_tpu_torch.train.step import loss_fn

    cfg, model, aux = _flagship(cuda_device)
    m = cfg.model
    lcfg = LoraConfig(rank=16, alpha=16.0, dropout=0.0)
    batch = card.seeded_batch(aux, m, cuda_device)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    results = []
    for kernel in (True, False):
        if not kernel:
            with cuda_device:
                model = PanguModel(dataclasses.replace(m, use_pallas_attention=False)).to(
                    cuda_device)
            model.load_state_dict(base)
        tree = init_lora_params(base, lcfg, torch.Generator(cuda_device).manual_seed(1))
        with torch.no_grad():
            for ab in tree["lora"].values():
                ab["b"].normal_(0.0, 0.02, generator=torch.Generator(cuda_device).manual_seed(2))
        attach_lora(model, tree, lcfg, unmerged=unmerged)
        before = card.launches()
        model.train()
        loss = loss_fn(model, batch, aux, cfg, torch.Generator(cuda_device).manual_seed(3))
        loss.backward()
        torch.cuda.synchronize()
        results.append((card.launched(before), loss.item(),
                        {k: t.grad.float() for k, t in flatten_trainable(tree).items()}))
    (launched, loss_k, g_k), (plain, loss_p, g_p) = results
    assert plain == card.PLAIN_TRAIN_LAUNCHES
    d2 = sum(float((g_k[k] - g_p[k]).pow(2).sum()) for k in g_p)
    n2 = sum(float(g.pow(2).sum()) for g in g_p.values())
    return launched, abs(loss_k - loss_p) / abs(loss_p), (d2 / n2) ** 0.5


def test_merged_lora_kernel_step_matches_the_plain_bf16_step(cuda_device):
    """The merged form: K2, K3, K5, K6 and K7 16 launches and K4 32; the
    loss within 1% and the adapters' and heads' gradient within 1% relative
    L2 of the plain bf16 step (the flagship train step's bounds)."""
    launched, loss_dev, rel_l2 = _lora_step_against_plain(cuda_device, unmerged=False)
    assert launched == card.TRAIN_LAUNCHES
    assert loss_dev < 0.01 and rel_l2 < 0.01


def test_unmerged_lora_kernel_step_matches_the_plain_bf16_unmerged_step(cuda_device):
    """The unmerged form, whose adapter taps leave the attention and MLP
    kernels for the plain route: of the block kernels only K4 (32) and K5
    (16) run, and the Dense kernel as in the plain step; the loss within 1%
    and the gradient within 1% relative L2 of the plain bf16 unmerged step."""
    launched, loss_dev, rel_l2 = _lora_step_against_plain(cuda_device, unmerged=True)
    assert launched == {"fused_residual_postnorm": 32, "fused_residual_postnorm_bwd": 16,
                        **card.PLAIN_TRAIN_LAUNCHES}
    assert loss_dev < 0.01 and rel_l2 < 0.01


def test_trainer_fit_launches_the_training_kernels(cuda_device, tmp_path):
    """``Trainer.fit``, one epoch of one flagship synthetic sample and one
    validation sample: K2, K3, K5, K6, K7 16 launches and K4 32 for the
    step, K1 16 for the validation forward, the Dense kernel 7 times in
    each forward and 7 in the backward; a finite loss, a checkpoint and the
    best params."""
    from pangu_tpu_torch.config import DataConfig
    from pangu_tpu_torch.data import make_loader
    from pangu_tpu_torch.train.trainer import Trainer

    cfg, model, aux = _flagship(cuda_device)
    cfg = cfg.replace(
        data=DataConfig(store="synthetic", train_start="20240101", train_end="20240103",
                        val_start="20240104", val_end="20240106"),
        train=dataclasses.replace(cfg.train, epochs=1, batch_size=1))
    train = make_loader(cfg.data, cfg.model, "train", 24, 1)
    val = make_loader(cfg.data, cfg.model, "val", 24, 1)
    assert (len(train), len(val)) == (1, 1)
    losses = []

    class Writer:
        def add_scalars(self, tag, values, epoch):
            losses.append(values)

    before = card.launches()
    best, state = Trainer(cfg, model, aux, str(tmp_path), writer=Writer()).fit(train, val)
    torch.cuda.synchronize()
    assert card.launched(before) == {"fused_block_attention": 16, "fused_block_attention_bwd": 16,
                        "fused_residual_postnorm": 32, "fused_residual_postnorm_bwd": 16,
                        "fused_mlp_postnorm": 16, "fused_mlp_postnorm_bwd": 16,
                        "fused_earth_block": 16, "dense": 7 + 7, "dense_bwd": 7}
    assert state.step == 1 and all(np.isfinite(v) for v in losses[0].values())
    assert sorted(os.listdir(tmp_path / "models")) == ["best", "train_1"]
    assert sorted(best) == sorted(state.params)


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
    """At 3 (odd) and 4 windows and 1, 8 and 256 sweeps (split 1, then 4
    CTAs a window with 2 and 64 repeats): the plain version's sum, and the
    same bits on a second run (fixed-order partials, no atomics)."""
    from pangu_tpu_torch.scripts import bench_mxu_micro as m

    qkv, qkv8 = m.make_inputs(cuda_device)
    for windows in (3, 4):
        x = (qkv8 if variant == "loop_int8" else qkv)[:windows].contiguous()
        for sweeps in (1, 8, m.SWEEPS):
            before = m.LAUNCHES[variant]
            got = m.mxu_micro(variant, x, sweeps)
            again = m.mxu_micro(variant, x, sweeps)
            torch.cuda.synchronize()
            assert m.LAUNCHES[variant] == before + 2
            assert torch.equal(got, again)
            ref = m.mxu_micro_reference(variant, x, sweeps)
            tol = m.TOL[variant] if sweeps == 1 else m.SWEEPS_TOL  # int8: exact below 2^24
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


@pytest.mark.parametrize("variant", ["batched", "dbl", "quad"])
def test_cuda_attn_fwd_ab_variant_over_batches_and_types(cuda_device, variant):
    """Two batch entries and four window types: the fat-window CTAs run
    type-major, each reads its type's bias rows, and quad streams x through
    its ring for every head."""
    from pangu_tpu_torch.scripts import bench_attn_fwd_ab as f

    base, bias = f.make_args(cuda_device, (2, 4, 12, 48, 192, 6), seed=1)
    before = f.LAUNCHES[variant]
    res = f.compare_variant(variant, f.variant_args(variant, base, bias, {}), bias, {})
    assert res["ok"], res
    assert f.LAUNCHES[variant] == before + 1


def test_cuda_local_accum_over_batches_with_the_same_bits(cuda_device):
    """Two batch entries: each CTA's dbias tile in device memory and its
    on-chip weight sums carry across the batch as across the lon windows,
    with the same bits on a second run."""
    from pangu_tpu_torch.scripts import bench_attn_bwd_ab as bw

    args = bw.make_args(cuda_device, (2, 4, 12, 24, 192, 6), seed=1)
    before = bw.LAUNCHES
    res = bw.compare_variant("local_accum", args, {})
    assert res["same_bits"] and res["vs_shipped"] <= bw.PARITY_TOL and res["ok"], res
    assert bw.LAUNCHES == before + 2  # the checked call and the second run


# ---- the build and the flagship stage shapes --------------------------------------------------


def test_every_kernel_source_builds(cuda_device):
    """Every CUDA source of ``ops._build.SOURCES`` compiles with nvcc (one
    process a source, all at once) and loads as a library of its own."""
    from pangu_tpu_torch.ops import _build

    _build.build_all()
    assert set(_build.SOURCES) <= set(_build._LIBS)
    paths = {_build._lib_path(s) for s in _build.SOURCES}
    assert len(paths) == len(_build.SOURCES) and all(os.path.isfile(p) for p in paths)


def _flagship_stages() -> dict:
    """The flagship model's two stages: name -> (StageGeometry, C, heads)."""
    from pangu_tpu_torch import pangu_pretrain
    from pangu_tpu_torch.geometry import compute_geometry

    g = compute_geometry(pangu_pretrain(24).model)
    return {"outer": (g.outer, 192, 6), "inner": (g.inner, 384, 12)}


def _block_inputs(stage, c: int, heads: int, shifted: bool, dev, seed: int, gy_seed: int = 0):
    """Seeded bf16 block inputs at one stage's full shape: unit-scale x,
    fan-in-scaled (out, in) weights, a unit earth bias (softmax far from
    uniform) and, shifted, the stage's shift mask; and a unit-normal
    output gradient from ``gy_seed``."""
    from pangu_tpu_torch.model.attention import shift_attention_mask

    gen = torch.Generator(device=dev).manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, std=1.0, mean=0.0, dtype=bf):
        return (mean + std * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    mask = torch.from_numpy(shift_attention_mask(stage)).to(dev) if shifted else None
    args = (rn(1, stage.z, stage.h_pad, stage.w, c),
            rn(3 * c, c, std=c ** -0.5), rn(3 * c, std=0.02),
            rn(c, c, std=c ** -0.5), rn(c, std=0.02),
            rn(stage.n_type_windows, heads, T, T, dtype=f32), mask,
            rn(c, mean=1.0, std=0.1, dtype=f32), rn(c, std=0.1, dtype=f32),
            rn(4 * c, c, std=c ** -0.5), rn(4 * c, std=0.02),
            rn(c, 4 * c, std=(4 * c) ** -0.5), rn(c, std=0.02),
            rn(c, mean=1.0, std=0.1, dtype=f32), rn(c, std=0.1, dtype=f32))
    gy = torch.randn(args[0].shape, generator=torch.Generator(device=dev).manual_seed(gy_seed),
                     device=dev).to(bf)
    return args, (stage.window, heads, (c // heads) ** -0.5), gy


def _held(label: str, got, ref) -> None:
    """Every output of ``got`` within the kernel bounds of its ``ref``:
    max|d| / max(1, max|ref|) < 0.04 and RMS(d) / RMS(ref) < 0.01."""
    from pangu_tpu_torch.scripts.ab_common import compare

    for i, (a, b) in enumerate(zip(got, ref, strict=True)):
        c = compare(a, b)
        assert c["ok"], (label, i, c)


def _twice(fn) -> tuple:
    """``fn()``'s outputs, as a tuple, after checking that a second call
    gives the same bits."""
    first, second = ((t,) if torch.is_tensor(t) else tuple(t) for t in (fn(), fn()))
    assert all(torch.equal(a, b) for a, b in zip(first, second, strict=True))
    return first


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("stage_name", ["outer", "inner"])
def test_block_kernels_at_the_flagship_stage_shapes(cuda_device, stage_name, shifted):
    """The block kernels at each flagship stage's full shape (1 x 8 x 186 x
    360 x 192 in 6 heads, 1 x 8 x 96 x 180 x 384 in 12), unshifted and
    shifted with the stage's shift mask, from fan-in-scaled weights and a
    unit earth bias, against their plain versions under the kernel bounds
    (``_held``, every gradient too): K1 as the forecast step calls it, the
    block's shift and real lat rows folded into its gather, junk and NaN in
    the pad rows (the real rows compared); K2 and its flash backward K3;
    K11 at branch scales 1.25 and 0.8 and its backward K12, and K11 at unit
    scales against K1; K2's LN-epilogue mode; the two-kernel inference
    block (``EarthAttention3D(..., epilogue=)`` then ``Mlp(..., fused=True)``)
    against K1, one launch of each of its kernels. K1, K2, K3 and K12 give
    the same bits on a second call. Each group draws its inputs from the
    seeds the retired smoke script's phases used (K1 0-3, K2/K3 10-13 and
    20-23, K11/K12 60-63 and 70-73, K2 LN 80-83): a per-sample scale's
    gradient of K12 is one sum over the stage's tokens that cancels far
    below the rounding noise of its summands, so its RMS bound, which for a
    scalar is its max bound, holds on these draws and not on every draw
    (PERF.md section 7)."""
    from pangu_tpu_torch.model.attention import EarthAttention3D
    from pangu_tpu_torch.model.blocks import Mlp
    from pangu_tpu_torch.ops import fused_block_train as tfbt

    stage, c, heads = _flagship_stages()[stage_name]
    i = 2 * (stage_name == "inner") + shifted

    def inputs(seed, gy_seed=0):
        return _block_inputs(stage, c, heads, shifted, cuda_device, seed, gy_seed)

    h, shift = stage.h, [w // 2 if shifted else 0 for w in stage.window]
    s1, s2 = torch.full((1,), 1.25, device=cuda_device), torch.full((1,), 0.8, device=cuda_device)
    one = torch.ones(1, device=cuda_device)
    with torch.no_grad():
        args, statics, _ = inputs(i)
        junk = args[0].clone()
        junk[:, :, h:] = 3e4
        junk[:, :, -1] = float("nan")
        got = _twice(lambda: tfba.fused_earth_block(junk, *args[1:], *statics, shift=shift,
                                                    h=h)[:, :, :h])
        _held("K1", got, [tfba.fused_earth_block_folded_reference(
            junk, *args[1:], *statics, shift, h)[:, :, :h]])
        del got, junk
        args, statics, gy = inputs(10 + i, 20 + i)
        _held("K2", _twice(lambda: tfba.fused_block_attention(*args[:7], None, None, *statics)),
              [tfba.fused_block_attention_reference(*args[:7], *statics)])
        bargs = (args[0], *args[1:4], *args[5:7], gy, *statics)
        _held("K3", _twice(lambda: tfba.fused_block_attention_bwd(*bargs)),
              tfba.fused_block_attention_bwd_reference(*bargs))
        args, statics, gy = inputs(60 + i, 70 + i)
        _held("K11", [tfbt.fused_earth_block_train(*args, s1, s2, *statics)],
              [tfbt.fused_earth_block_train_reference(*args, s1, s2, *statics)])
        _held("K11 at unit scales", [tfbt.fused_earth_block_train(*args, one, one, *statics)],
              [tfba.fused_earth_block(*args, *statics)])
        bargs = (*args, s1, s2, gy, *statics)
        _held("K12", _twice(lambda: tfbt.fused_earth_block_train_bwd(*bargs)),
              tfbt.fused_earth_block_train_bwd_reference(*bargs))
        args, statics, _ = inputs(80 + i)
        x, mask = args[0], args[6]
        _held("K2 LN", [tfba.fused_block_attention(*args[:9], *statics)],
              [tfba.fused_block_attention_reference(*args[:7], *statics, args[7], args[8])])
        attn = EarthAttention3D(c, heads, stage, use_kernel=True).to(cuda_device).eval()
        mlp = Mlp(c).to(cuda_device).eval()
        for p, a in ((attn.linear1.weight, args[1]), (attn.linear1.bias, args[2]),
                     (attn.linear2.weight, args[3]), (attn.linear2.bias, args[4]),
                     (attn.earth_specific_bias, args[5][None]), (mlp.linear1.weight, args[9]),
                     (mlp.linear1.bias, args[10]), (mlp.linear2.weight, args[11]),
                     (mlp.linear2.bias, args[12])):
            p.copy_(a.float())
        before = card.launches()
        two = mlp(attn(x, mask, epilogue=(args[7], args[8])), ln=(args[13], args[14]), fused=True)
        torch.cuda.synchronize()
        assert card.launched(before) == {"fused_block_attention_ln": 1, "fused_mlp_block": 1}
        _held("two-kernel block", [two], [tfba.fused_earth_block(*args, *statics)])


@pytest.mark.parametrize("stage_name", ["outer", "inner"])
def test_row_kernels_at_the_flagship_stage_rows(cuda_device, stage_name):
    """The row kernels at each flagship stage's row count (535,680 at C 192,
    138,240 at C 384) with one sample's drop-path keep scale, 1.25, against
    their plain versions under the kernel bounds, every gradient too: the
    post-norm residual K4 and its backward K5, the MLP tail K6 and K7, the
    raw MLP K8 and K9, and the inference MLP tail K10; K6, K7 and K8 give
    the same bits on a second call."""
    from pangu_tpu_torch.ops import fused_epilogue as tfep
    from pangu_tpu_torch.ops import fused_mlp as tfm

    stage, c, _ = _flagship_stages()[stage_name]
    rows = stage.z * stage.h_pad * stage.w
    gen = torch.Generator(device=cuda_device).manual_seed(30)

    def rn(*shape, dtype=torch.bfloat16, mean=0.0, std=1.0):
        return (mean + std * torch.randn(shape, generator=gen, device=cuda_device)).to(dtype)

    shortcut, x, gy = rn(rows, c), rn(rows, c), rn(rows, c)
    ln = (rn(c, dtype=torch.float32, mean=1.0, std=0.1), rn(c, dtype=torch.float32, std=0.1))
    w = (rn(4 * c, c, std=c ** -0.5), rn(4 * c, std=0.02), rn(c, 4 * c, std=(4 * c) ** -0.5),
         rn(c, std=0.02))
    s = torch.full((rows,), 1.25, device=cuda_device)
    with torch.no_grad():
        _held("K4", [tfep.fused_residual_postnorm(shortcut, x, *ln, s[:, None])],
              [tfep.fused_residual_postnorm_reference(shortcut, x, *ln, s)])
        _held("K5", tfep.fused_residual_postnorm_bwd(x, gy, *ln, s),
              tfep.fused_residual_postnorm_bwd_reference(x, gy, *ln, s))
        _held("K6", _twice(lambda: tfm.fused_mlp_postnorm(x, *w, *ln, s[:, None])),
              [tfm.fused_mlp_postnorm_reference(x, *w, *ln, s)])
        _held("K7", _twice(lambda: tfm.fused_mlp_postnorm_bwd(x, gy, *w, *ln, s)),
              tfm.fused_mlp_postnorm_bwd_reference(x, gy, *w, *ln, s))
        _held("K8", _twice(lambda: tfm.fused_mlp(x, *w)), [tfm.fused_mlp_reference(x, *w)])
        _held("K9", tfm.fused_mlp_bwd(x, gy, *w), tfm.fused_mlp_bwd_reference(x, gy, *w))
        _held("K10", [tfm.fused_mlp_block(x, *w, *ln)],
              [tfm.fused_mlp_block_reference(x, *w, *ln)])


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("stage_name", ["outer", "inner"])
def test_block_kernels_on_the_slabs_of_the_flagship_plane(cuda_device, stage_name, shifted):
    """K1, K2, K3, K11 and K12 (``torch_card.block_calls``) on each slab of
    the flagship lat=2 x lon=2 plane (``spatial.slab_of``: whole windows,
    the earth bias and the shift mask cut by ``Slab.cut_types``) against
    the same windows of the whole-grid launch: the forward outputs and dx
    the same bits, or else within the kernel bounds; the weight and bias
    gradients summed over the four slabs, and the earth bias's placed at
    each slab's window types and summed, within the kernel bounds of the
    whole grid's."""
    from pangu_tpu_torch.parallel.mesh import Mesh
    from pangu_tpu_torch.parallel.spatial import slab_of
    from pangu_tpu_torch.scripts.ab_common import compare

    stage, c, heads = _flagship_stages()[stage_name]
    i = 2 * (stage_name == "inner") + shifted
    args, statics, gy = _block_inputs(stage, c, heads, shifted, cuda_device, 90 + i, 95 + i)
    slabs = [slab_of(stage, Mesh(None, 1, r, 2, 2)) for r in range(4)]
    with torch.no_grad():
        for route in ("attention", "block"):
            whole = card.block_calls(route, args, statics, gy)
            sums = {k: [None] * len(grads) for k, (_, grads, _) in whole.items()}
            for slab in slabs:
                (r0, r1), (c0, c1) = slab.rows, slab.cols
                for k, (outs, grads, names) in card.block_calls(route, args, statics, gy,
                                                                slab).items():
                    for got, want in zip([*outs, *grads[:1]], [*whole[k][0], *whole[k][1][:1]]):
                        want = want[:, :, r0:r1, c0:c1]
                        assert torch.equal(got, want) or compare(got, want)["ok"], (k, slab.rows,
                                                                                   slab.cols)
                    for i in range(1, len(grads)):
                        t = grads[i].float()
                        if names[i] == "dbias":
                            t = card.place_types(t, slab, whole[k][1][i])
                        sums[k][i] = t if sums[k][i] is None else sums[k][i] + t
            for k, (_, grads, _) in whole.items():
                _held(f"{k} summed over the slabs", sums[k][1:], grads[1:])
            del whole, sums


# ---- the flagship steps on one card -----------------------------------------------------------


def _within_step_bounds(got, ref, aux) -> bool:
    """Two forecast steps' (upper, surface) outputs within max|d| < 0.1 and
    RMS(d) < 0.01 of each other in normalized units."""
    d = [((a - b) / std).float() for a, b, std in zip(got, ref, (aux.upper_std,
                                                                 aux.surface_std))]
    rms = ((d[0].pow(2).sum() + d[1].pow(2).sum()) / (d[0].numel() + d[1].numel())).sqrt()
    return max(t.abs().max().item() for t in d) < 0.1 and rms.item() < 0.01


def test_flagship_forecast_steps_launch_k1_per_block_within_the_plain_steps_bounds(cuda_device):
    """Three autoregressive flagship bf16 forecast steps from seeded
    weights, aux constants and fields: 16 K1 launches a step, the last
    step's outputs (1, 5, 13, 721, 1440) and (1, 4, 721, 1440) and finite;
    the first step against the plain bf16 composition and against the f32
    step on the same weights and inputs, neither of which launches K1:
    max|d| < 0.1 and RMS(d) < 0.01 in normalized units."""
    cfg, model, aux = _flagship(cuda_device)
    m = cfg.model
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    upper = aux.upper_mean + aux.upper_std * torch.randn(
        (1, m.upper_vars, m.levels, m.lat, m.lon), generator=gen, device=cuda_device)
    surface = aux.surface_mean + aux.surface_std * torch.randn(
        (1, m.surface_vars, m.lat, m.lon), generator=gen, device=cuda_device)
    step = make_forecast_step(model, aux)
    before = tfba.LAUNCHES
    first = last = step(upper, surface)
    for _ in range(2):
        last = step(*last)
    torch.cuda.synchronize()
    assert tfba.LAUNCHES - before == 3 * sum(m.depths) == 48
    for out, shape in zip(last, ((1, 5, 13, 721, 1440), (1, 4, 721, 1440))):
        assert tuple(out.shape) == shape and bool(torch.isfinite(out).all())
    for kw in (dict(use_pallas_attention=False),
               dict(compute_dtype="float32", use_pallas_attention=False)):
        with cuda_device:
            other = PanguModel(dataclasses.replace(m, **kw)).to(cuda_device)
        other.load_state_dict(model.state_dict())
        before = tfba.LAUNCHES
        ref = make_forecast_step(other, aux)(upper, surface)
        assert tfba.LAUNCHES == before
        assert _within_step_bounds(first, ref, aux), kw
        del other, ref


#: the kernel route's overrides and the synthetic store's scored range (3 samples at 24 h)
KERNEL_ROUTE = ["--set", "model.compute_dtype=bfloat16",
                "--set", "model.use_pallas_attention=true"]
SCORE_DATES = dict(store="synthetic", test_start="20240101", test_end="20240105", test_freq="24h")
SCORE_TARGETS = ["2024010200", "2024010300", "2024010400"]


def _sets(data: dict) -> list:
    return [f"--set=data.{k}={v}" for k, v in data.items()]


def _score_tables(csv_dir: str, rows: list) -> dict:
    """The 8 rmse_* and 6 acc_* tables of ``csv_dir`` (and nothing else
    there), each with the rows ``rows``, the ERA5 level or surface-variable
    columns and finite values."""
    from pangu_tpu_torch.config import ERA5_SURFACE_VARIABLES, ERA5_UPPER_LEVELS
    from pangu_tpu_torch.eval.csv_io import load_error_scores
    from pangu_tpu_torch.eval.evaluate import ACC_FAMILIES, RMSE_FAMILIES

    tables = {}
    for error, families in (("rmse", RMSE_FAMILIES), ("acc", ACC_FAMILIES)):
        for f in families:
            index, columns, values = load_error_scores(csv_dir, error, f)
            want = (list(ERA5_SURFACE_VARIABLES) if f == "surface" else
                    ["wind_speed"] if f == "surface_wind_speed" else list(ERA5_UPPER_LEVELS))
            assert (index, columns) == (rows, want) and np.isfinite(values).all(), (error, f)
            tables[f"{error}_{f}"] = values
    assert sorted(os.listdir(csv_dir)) == sorted(f"{k}.csv" for k in tables)
    return tables


def test_flagship_test_and_rollout_scripts_score_on_the_kernel_route(cuda_device, tmp_path):
    """The ``test`` script over the synthetic store's 3 samples at 24 h and
    the ``rollout`` script's ``--mode multi --lead-days 2`` over the same
    range (3 inits of 2 steps), flagship bf16 on the kernel route from the
    config's seeded weights: 16 K1 launches a forecast step and no other
    kernel; every CSV of both held by ``_score_tables``; the test script's
    values those of the score step on the same weights and samples; on the
    first sample the kernel route against the plain bf16 route: per channel
    |RMSE_kernel - RMSE_plain| <= RMSE(pred_kernel, pred_plain) x (1 + 1e-4)
    (the weighted RMSE is a norm) and |dACC| <= 0.02."""
    import argparse
    from datetime import datetime, timedelta

    from pangu_tpu_torch.aux import load_aux_constants
    from pangu_tpu_torch.cli import base_parser, build_config, load_model_and_params
    from pangu_tpu_torch.data import make_loader
    from pangu_tpu_torch.eval.evaluate import (ACC_FAMILIES, RMSE_FAMILIES, make_field_scorer,
                                               make_score_step, to_device)
    from pangu_tpu_torch.scripts import rollout as rollout_script
    from pangu_tpu_torch.scripts import test as test_script
    from pangu_tpu_torch.train import Batch

    argv = ["--out", str(tmp_path), *KERNEL_ROUTE, *_sets(SCORE_DATES)]
    cfg = build_config(base_parser("").parse_args(argv))
    before = card.launches()
    test_script.main(argv, device=cuda_device)
    assert card.launched(before) == {k: 3 * v for k, v in card.FORECAST_LAUNCHES.items()}
    tables = _score_tables(str(tmp_path / "test" / "24" / "csv"), SCORE_TARGETS)
    before = card.launches()
    out = rollout_script.main([*argv, "--mode", "multi", "--lead-days", "2"], device=cuda_device)
    assert card.launched(before) == {k: 6 * v for k, v in card.FORECAST_LAUNCHES.items()}
    inits = ["2024010100", "2024010200", "2024010300"]
    assert sorted(d for d in os.listdir(out) if os.path.isdir(os.path.join(out, d))) == inits
    for init in inits:
        t = datetime.strptime(init, "%Y%m%d%H")
        _score_tables(os.path.join(out, init, "csv"),
                      [(t + timedelta(days=d + 1)).strftime("%Y%m%d%H") for d in range(2)])

    aux = load_aux_constants(cfg.model, cfg.train, None, cfg.horizon, device=cuda_device)
    model = load_model_and_params(cfg, argparse.Namespace(weights=None), aux, device=cuda_device)
    step = make_score_step(model, cfg, return_fields=True)
    first = None
    for host, periods in make_loader(cfg.data, cfg.model, "test", cfg.horizon, 1):
        batch = Batch(*(to_device(x, cuda_device) for x in host))
        scores = {k: v.cpu().numpy() for k, v in step(batch, aux).items()
                  if not k.startswith("output")}
        for k, table in tables.items():
            np.testing.assert_array_equal(table[SCORE_TARGETS.index(periods[0][1])],
                                          scores[k][0].astype(np.float32), err_msg=k)
        first = first or (batch, scores)
    batch, kernel = first
    kout = step(batch, aux)
    with cuda_device:
        plain = PanguModel(dataclasses.replace(cfg.model, use_pallas_attention=False)).to(
            cuda_device)
    plain.load_state_dict(model.state_dict())
    pout = make_score_step(plain, cfg, return_fields=True)(batch, aux)
    between = make_field_scorer(cfg)(kout["output_upper"], kout["output_surface"],
                                     pout["output_upper"], pout["output_surface"], aux)
    for f in RMSE_FAMILIES:
        gap = np.abs(kernel[f"rmse_{f}"][0].astype(np.float64)
                     - pout[f"rmse_{f}"][0].cpu().numpy().astype(np.float64))
        norm = between[f"rmse_{f}"][0].cpu().numpy().astype(np.float64)
        assert (gap <= norm * (1 + 1e-4)).all(), f
    for f in ACC_FAMILIES:
        assert np.abs(kernel[f"acc_{f}"][0] - pout[f"acc_{f}"][0].cpu().numpy()).max() <= 0.02, f


#: the synthetic store's train (2 samples at 24 h) and validation (1 sample) ranges
FINETUNE_DATES = dict(store="synthetic", train_start="20240101", train_end="20240104",
                      train_freq="24h", val_start="20240105", val_end="20240107",
                      val_freq="24h")


class _Scalars:
    """A writer for the Trainer: its scalars by epoch."""

    def __init__(self):
        self.by_epoch = {}

    def add_scalars(self, tag, values, epoch):
        self.by_epoch[epoch] = dict(values)


def test_flagship_trainer_resume_gives_the_uninterrupted_bits(cuda_device, tmp_path):
    """``Trainer.fit`` at flagship widths on the kernel route, batch 1: 2
    epochs of 2 steps over the synthetic store, a train-state checkpoint
    each epoch and one validation pass at epoch 2: the default route's
    launches a step, 16 K1 launches for the validation forward and no other
    kernel, finite losses, ``best`` the final parameters; then
    ``Trainer.resume`` from ``train_1`` and epoch 2 again: the same losses
    and the same parameter bits."""
    from pangu_tpu_torch.config import DataConfig
    from pangu_tpu_torch.data import make_loader
    from pangu_tpu_torch.train.trainer import Trainer

    cfg, model, aux = _flagship(cuda_device)
    cfg = cfg.replace(data=DataConfig(**FINETUNE_DATES), train=dataclasses.replace(
        cfg.train, epochs=2, batch_size=1, save_interval=1, val_interval=2))
    train = make_loader(cfg.data, cfg.model, "train", cfg.horizon, 1)
    val = make_loader(cfg.data, cfg.model, "val", cfg.horizon, 1)
    assert (len(train), len(val)) == (2, 1)
    writer = _Scalars()
    before = card.launches()
    best, state = Trainer(cfg, model, aux, str(tmp_path), writer=writer,
                          steps_per_epoch=2).fit(train, val)
    torch.cuda.synchronize()
    assert card.launched(before) == {**{k: 4 * v for k, v in card.TRAIN_LAUNCHES.items()},
                                     "fused_earth_block": 16, "dense": 4 * 7 + 7}
    assert state.step == 4 and all(map(math.isfinite, writer.by_epoch[2].values()))
    assert sorted(os.listdir(tmp_path / "models")) == ["best", "train_1", "train_2"]
    named = dict(model.named_parameters())
    assert all(torch.equal(best[k], named[k]) for k in best)
    final = {k: p.detach().clone() for k, p in named.items()}
    again = _Scalars()
    no_saves = cfg.replace(train=dataclasses.replace(cfg.train, save_interval=3))
    trainer = Trainer(no_saves, model, aux, str(tmp_path), writer=again, steps_per_epoch=2)
    state, start = trainer.resume(epoch=1)
    trainer.fit(train, val, start_epoch=start, state=state)
    assert start == 2 and again.by_epoch[2] == writer.by_epoch[2]
    assert not [k for k, p in model.named_parameters() if not torch.equal(p, final[k])]


#: the process that serves an exported step: it imports the serving module and the
#: profiling tools, never the model; argv: artifact, input fields, output path, trace
#: directory. Prints one JSON line.
SERVE = r"""
import json, sys
import torch
from pangu_tpu_torch import serving
from pangu_tpu_torch.ops import fused_block_attention as fba
from pangu_tpu_torch.utils import profiling

path, inputs, outputs, trace_dir = sys.argv[1:]
step = serving.load_forecast_step(path)
fields = torch.load(inputs)
u, s = fields["upper"].cuda(), fields["surface"].cuda()
launches = []
for i in range(3):
    before = (fba.LAUNCHES, fba.DENSE_LAUNCHES)
    u, s = step(u, s)
    torch.cuda.synchronize()
    launches.append([fba.LAUNCHES - before[0], fba.DENSE_LAUNCHES - before[1]])
    if i == 0:
        torch.save({"upper": u.cpu(), "surface": s.cpu()}, outputs)
with profiling.trace(trace_dir):
    step(u, s)
    torch.cuda.synchronize()
program = step.program
print(json.dumps(dict(
    launches=launches, busy=profiling.trace_device_busy_split(trace_dir),
    graph_ops=dict(serving.graph_ops(program)),
    devices=sorted({str(t.device) for t in (*program.state_dict.values(),
                                            *program.constants.values())}),
    finite=bool(torch.isfinite(u).all() and torch.isfinite(s).all()),
    model_modules=sorted(m for m in sys.modules if m.startswith("pangu_tpu_torch.model")))))
"""


def test_exported_flagship_step_serves_in_a_fresh_process_with_the_eager_bits(cuda_device,
                                                                             tmp_path):
    """The flagship bf16 step exported to a ``.pt2`` holds 16 calls of K1's
    operator, 7 of the Dense operator and no other op outside aten. A fresh
    process that imports ``pangu_tpu_torch.serving`` and no module of
    ``pangu_tpu_torch.model`` loads it and runs 3 autoregressive steps: 16
    K1 and 7 Dense launches each, the loaded graph's 16 and 7 calls, every
    tensor of the artifact on the card, finite fields, a traced step with
    device time (``profiling.trace``); its first step has the bits of the
    eager step, which launches K1 16 times and the Dense kernel 7 times."""
    from pangu_tpu_torch import serving

    cfg, model, aux = _flagship(cuda_device)
    m = cfg.model
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    upper = aux.upper_mean + aux.upper_std * torch.randn(
        (1, m.upper_vars, m.levels, m.lat, m.lon), generator=gen, device=cuda_device)
    surface = aux.surface_mean + aux.surface_std * torch.randn(
        (1, m.surface_vars, m.lat, m.lon), generator=gen, device=cuda_device)
    path = str(tmp_path / "pangu24.pt2")
    ops = serving.graph_ops(serving.export_forecast_step(model, aux, path))
    assert (ops[serving.K1_OP], ops[serving.DENSE_OP]) == (16, 7)
    assert not [k for k in ops
                if k not in (serving.K1_OP, serving.DENSE_OP) and not k.startswith("aten::")]
    before = card.launches()
    eager = make_forecast_step(model, aux)(upper, surface)
    torch.cuda.synchronize()
    assert card.launched(before) == card.FORECAST_LAUNCHES
    torch.save({"upper": upper.cpu(), "surface": surface.cpu()}, tmp_path / "inputs.pt")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", SERVE, path, str(tmp_path / "inputs.pt"),
         str(tmp_path / "served.pt"), str(tmp_path / "trace")], cwd=repo,
        env=dict(os.environ, PYTHONPATH=repo), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    served = json.loads(proc.stdout.strip().splitlines()[-1])
    assert served["model_modules"] == [] and served["launches"] == [[16, 7]] * 3
    assert served["graph_ops"][serving.K1_OP] == 16 and served["devices"] == ["cuda:0"]
    assert served["graph_ops"][serving.DENSE_OP] == 7
    assert served["finite"] and served["busy"] and served["busy"]["modules_ms"] > 0
    got = torch.load(tmp_path / "served.pt")
    assert torch.equal(got["upper"].to(cuda_device), eager[0])
    assert torch.equal(got["surface"].to(cuda_device), eager[1])


def _batch_reads(fn):
    from pangu_tpu_torch.data import dataset as tds

    before = dict(tds.BATCH_READS)
    out = fn()
    return out, {k: tds.BATCH_READS[k] - before[k] for k in before}


def _fit_epoch(cuda_device, data: dict, out: str) -> tuple:
    """One ``Trainer.fit`` epoch (2 steps) at flagship widths on the kernel
    route from seeded weights over the train range of ``data``'s store:
    (each step's loss, the launches)."""
    from pangu_tpu_torch.config import DataConfig
    from pangu_tpu_torch.data import make_loader
    from pangu_tpu_torch.train.trainer import Trainer

    cfg, model, aux = _flagship(cuda_device)
    cfg = cfg.replace(data=DataConfig(**{**FINETUNE_DATES, **data}), train=dataclasses.replace(
        cfg.train, epochs=1, batch_size=1))
    train = make_loader(cfg.data, cfg.model, "train", cfg.horizon, 1)
    trainer = Trainer(cfg, model, aux, out, steps_per_epoch=len(train))
    losses, step = [], trainer.train_step

    def recorded(batch, aux, gen):
        loss = step(batch, aux, gen)
        losses.append(loss.item())
        return loss

    trainer.train_step = recorded
    before = card.launches()
    trainer.fit(train)
    return losses, card.launched(before)


def test_flagship_npy_store_feeds_the_scripts_the_synthetic_stores_bits(cuda_device, tmp_path):
    """The native batch reader builds. The synthetic store's 2024-01-01..07
    at 24 h (7 flagship frames, about 2.0 GB) written through
    ``convert_range`` into an npy store: ``load_batch`` there gives the
    synthetic store's arrays bit for bit; the ``test`` script over it on the
    kernel route launches K1 16 times and the Dense kernel 7 times a step
    and writes the CSVs that it writes over the synthetic store, byte for
    byte; one ``Trainer.fit``
    epoch over it (2 steps) launches the default route's kernels a step and
    gives the synthetic store's losses to the bit; the native reader, never
    the per-sample path, assembles every batch (``BATCH_READS``); the
    ``stats`` script reads the store."""
    from pangu_tpu_torch.data import native_loader
    from pangu_tpu_torch.data.convert import convert_range
    from pangu_tpu_torch.data.dataset import Era5Dataset, NpyStore, SyntheticStore
    from pangu_tpu_torch.scripts import stats as stats_script
    from pangu_tpu_torch.scripts import test as test_script

    assert native_loader.native_available()
    cfg = card.flagship()
    root, days = str(tmp_path / "npy"), ("20240101", "20240107", "24h")
    synthetic = SyntheticStore(cfg.model, cfg.data.seed)
    assert convert_range(synthetic, root, *days, log=None) == 7
    ds = Era5Dataset(NpyStore(root), *days, cfg.horizon)
    (got, periods), reads = _batch_reads(lambda: ds.load_batch([len(ds) - 1, 0]))
    ref, ref_periods = Era5Dataset(synthetic, *days, cfg.horizon).load_batch([len(ds) - 1, 0])
    assert reads == {"native": 1, "per_sample": 0} and periods == ref_periods
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    del got, ref
    npy = dict(store="npy", root=root)
    csvs = {}
    for name, data in (("synthetic", {}), ("npy", npy)):
        out = tmp_path / name
        before = card.launches()
        _, reads = _batch_reads(lambda: test_script.main(
            ["--out", str(out), *KERNEL_ROUTE, *_sets({**SCORE_DATES, **data})],
            device=cuda_device))
        assert card.launched(before) == {k: 3 * v for k, v in card.FORECAST_LAUNCHES.items()}
        csvs[name] = {f: (out / "test" / "24" / "csv" / f).read_bytes()
                      for f in os.listdir(out / "test" / "24" / "csv")}
    assert reads == {"native": -(-3 // cfg.eval.batch_size), "per_sample": 0}
    assert len(csvs["npy"]) == 14 and csvs["npy"] == csvs["synthetic"]
    (losses, launched), reads = _batch_reads(
        lambda: _fit_epoch(cuda_device, npy, str(tmp_path / "fit_npy")))
    assert reads == {"native": 2, "per_sample": 0}
    assert launched == {k: 2 * v for k, v in card.TRAIN_LAUNCHES.items()}
    assert len(losses) == 2 and losses == _fit_epoch(cuda_device, {},
                                                     str(tmp_path / "fit_synthetic"))[0]
    report = stats_script.main([*_sets({**SCORE_DATES, **npy}), "--out",
                                str(tmp_path / "stats"), "--limit", "2"])
    with open(report) as f:
        assert "2 samples" in f.readline()


def test_pipeline_stages_on_one_card_match_the_one_process_model(cuda_device):
    """The default 4-way split's stages (``parallel.pipeline``) at flagship
    widths on one card, drop path off, fed one another's outputs in the
    transport dtype by ``stage_forward`` / ``stage_backward`` in GPipe order
    over 2 microbatches of one sample: each sample's eval forward within
    max|d| < 0.1 and RMS < 0.01 (normalized) of the one-process forecast
    step, K1 launched once a block of each stage a sample and the Dense
    kernel once a product of its outsides; the train step's
    loss and gradients within ``torch_card.TRAIN_BOUNDS`` of the
    one-process step with ``accumulation_steps`` = 2, each stage launching
    the default route's kernels for its blocks and the Dense kernel for its
    outsides, each microbatch."""
    from pangu_tpu_torch import dtype_of
    from pangu_tpu_torch.aux import norm_back_data
    from pangu_tpu_torch.parallel import pipeline
    from pangu_tpu_torch.train import Batch
    from pangu_tpu_torch.train.step import output_loss

    micro = 2
    cfg, model, aux = _flagship(cuda_device, drop_path_max=0.0)
    m = cfg.model
    transport = dtype_of(m.compute_dtype)
    batch = card.seeded_batch(aux, m, cuda_device, rows=micro)
    stages = []
    for ops, part in zip(pipeline.DEFAULT_STAGES, pipeline.split_stage_params(
            model.state_dict(), pipeline.DEFAULT_STAGES)):
        with cuda_device:
            stages.append(pipeline.PanguStage(m, ops).to(cuda_device))
        stages[-1].load_state_dict(part)
    blocks = [sum(len(st.get_submodule(pipeline.MODULE_NAMES[op]).blocks)
                  for op in st.ops if op.startswith("layer")) for st in stages]
    rows = [slice(i, i + 1) for i in range(micro)]

    def counted(i, fn):
        before = card.launches()
        out = fn()
        for k, v in card.launched(before).items():
            launches[i][k] = launches[i].get(k, 0) + v
        return out

    launches = [{} for _ in stages]
    forecast = make_forecast_step(model, aux)
    for r in rows:
        ref = forecast(batch.upper[r], batch.surface[r])
        payload = (batch.upper[r], batch.surface[r])
        with torch.no_grad():
            for i, stage in enumerate(stages):
                run = counted(i, lambda: pipeline.stage_forward(stage.eval(), payload, aux,
                                                                grad=False))
                payload = run.outputs if i == len(stages) - 1 else tuple(
                    o.to(transport) for o in run.outputs)
        assert _within_step_bounds(norm_back_data(*payload, aux), ref, aux)
    dense = [sum(card.OUTER_DENSE.get(op, 0) for op in st.ops) * micro for st in stages]
    assert launches == [{**({"fused_earth_block": n * micro} if n else {}),
                         **({"dense": d} if d else {})} for n, d in zip(blocks, dense)]

    acc_cfg = cfg.replace(train=dataclasses.replace(cfg.train, accumulation_steps=micro))
    model.train()
    ref_loss = make_train_step(model, acc_cfg, make_optimizer(model, acc_cfg))(
        Batch(*(t.reshape(micro, 1, *t.shape[1:]) for t in batch)), aux).item()
    ref_grads = {k: p.grad.float() for k, p in model.named_parameters()}
    del forecast, model
    launches = [{} for _ in stages]
    runs = [[None] * micro for _ in stages]
    loss_sum = 0.0
    for j, r in enumerate(rows):  # every forward, microbatch by microbatch
        payload = (batch.upper[r], batch.surface[r])
        for i, stage in enumerate(stages):
            run = counted(i, lambda: pipeline.stage_forward(stage.train(), payload, aux))
            if i == len(stages) - 1:
                loss = output_loss(*run.outputs, batch.target_upper[r], batch.target_surface[r],
                                   aux, cfg)
                run = run._replace(outputs=(loss,))
                loss_sum += loss.item()
            else:
                payload = tuple(o.detach().to(transport) for o in run.outputs)
            runs[i][j] = run
    for j in range(micro):  # then every backward, in the same microbatch order
        grads = None
        for i in reversed(range(len(stages))):
            grads = counted(i, lambda: pipeline.stage_backward(runs[i][j], grads))
            runs[i][j] = None
    got = {k: p.grad / micro for st in stages for k, p in st.named_parameters()}
    d = card.train_deviation(loss_sum / micro, got, ref_loss, ref_grads)
    assert card.within_train_bounds(d), d
    assert launches == [card.stage_launches(st.ops, n, micro) for st, n in zip(stages, blocks)]


# ---- several cards over NCCL: the rank workers of the CPU tests, on the card ------------------


def _ranks(worker: str, world: int, cases: list, tmp_path) -> list:
    """The results of ``world`` ranks of ``tests/torch_<worker>_worker.py``,
    one process a card joined over NCCL, given ``cases``; skips on a host
    with fewer cards."""
    have = torch.cuda.device_count()
    if have < world:
        pytest.skip(f"needs {world} cards, one process a card over NCCL; this host has {have}")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return card.spawn(world, dict(dir=str(tmp_path), cases=cases, device="cuda"),
                      str(tmp_path / "ranks"),
                      os.path.join(repo, "tests", f"torch_{worker}_worker.py"), 900)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_zero2_steps_over_nccl_keep_every_rank_on_the_same_bits(cuda_device, tmp_path, world):
    """``torch_parallel_worker.case_card``, data = world, ZeRO-2, flagship
    bf16 on the kernel route: every step of every rank launches the default
    route's kernels; after each step every rank holds the same loss and
    parameter bits; the step resumed from ``train_1`` has the bits of the
    uninterrupted step; in a world of one the mesh step has the bits of the
    one-process step."""
    ranks = [r["card"] for r in _ranks("parallel", world, ["card"], tmp_path)]
    runs = [[(x["loss"], x["params"]) for x in r["runs"]] for r in ranks]
    for r in ranks:
        assert [x["launches"] for x in r["runs"]] == [card.TRAIN_LAUNCHES] * len(r["runs"])
        assert r["epoch"] == 1
    assert all(r[:3] == runs[0][:3] for r in runs)
    assert runs[0][2] == runs[0][1]
    if world == 1:
        assert runs[0][3] == runs[0][0]


@pytest.mark.parametrize("world,axes", [(2, dict(lat=2)), (4, dict(lat=2, lon=2))])
def test_spatial_steps_over_nccl_match_the_one_process_step(cuda_device, tmp_path, world, axes):
    """``torch_spatial_worker.case_card``, ZeRO-2 on the mesh's plane,
    flagship bf16 on the kernel route: every one of 3 steps of every rank
    launches the default route's kernels, every rank holds the same loss
    and parameter bits after each; the validation value is the same on
    every rank, with 16 K1 and 7 Dense launches a sample; the first step's loss and
    gradients within ``torch_card.TRAIN_BOUNDS`` of the one-process step."""
    key = "card:" + ",".join(f"{k}={v}" for k, v in sorted(axes.items()))
    ranks = [r[key] for r in _ranks("spatial", world, [["card", axes]], tmp_path)]
    for r in ranks:
        assert [x["launches"] for x in r["runs"]] == [card.TRAIN_LAUNCHES] * 3
        assert [(x["loss"], x["params"]) for x in r["runs"]] == [
            (x["loss"], x["params"]) for x in ranks[0]["runs"]]
        assert r["val"] == ranks[0]["val"]
        assert r["val_launches"] == {k: v * ranks[0]["val"][1]
                                     for k, v in card.FORECAST_LAUNCHES.items()}
    assert card.within_train_bounds(ranks[0]["one_process"]), ranks[0]["one_process"]


@pytest.mark.parametrize("world,axes", [(2, dict(pipe=2, micro=2)), (4, dict(pipe=4, micro=4)),
                                        (4, dict(data=2, pipe=2, micro=2))])
def test_pipeline_steps_over_nccl_match_the_one_process_accumulation_step(cuda_device, tmp_path,
                                                                         world, axes):
    """``torch_pipeline_worker.case_card``, flagship bf16 on the kernel
    route, drop path off: in each of 3 steps every rank launches what its
    stage's blocks launch on the default route, each microbatch, and every
    rank holds the same loss; the first step's loss and gradients within
    ``torch_card.TRAIN_BOUNDS`` of the one-process step that accumulates the
    same microbatches."""
    key = "card:" + ",".join(f"{k}={v}" for k, v in sorted(axes.items()))
    ranks = [r[key] for r in _ranks("pipeline", world, [["card", dict(axes)]], tmp_path)]
    for r in ranks:
        assert [x["launches"] for x in r["runs"]] == [r["want"]] * 3
        assert [x["loss"] for x in r["runs"]] == [x["loss"] for x in ranks[0]["runs"]]
    assert card.within_train_bounds(ranks[0]["one_process"]), ranks[0]["one_process"]


FUXI_GRID = (90, 180)


def _fuxi_attention_inputs(device, b, shifted, seed, cfg=None):
    """The attention inputs of a FuXi block at ``cfg``'s widths (FuXi-Short's
    by default: qkv (B, 90, 180, 3 x 1536)), seeded: unit-normal qkv,
    temperatures in [1, 100], a position bias of 16 sigmoid less its row
    maxima (bf16); the model's order, inverse and labels."""
    from pangu_tpu_torch.model import fuxi

    cfg = cfg or fuxi.fuxi_short()
    (h, w), heads, t = cfg.tokens, cfg.heads, cfg.window[0] * cfg.window[1]
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, h, w, 3 * cfg.dim), generator=gen, device=device).to(torch.bfloat16)
    temp = torch.exp(torch.rand((heads,), generator=gen, device=device) * math.log(100.0))
    scale = torch.stack([temp, torch.ones_like(temp)]).view(2, heads, 1)
    bias = 16 * torch.sigmoid(torch.randn((heads, t, t), generator=gen, device=device))
    bias = (bias - bias.amax(-1, keepdim=True))[None].to(torch.bfloat16)
    order = fuxi.window_order(h, w, cfg.window, shifted).to(device)
    labels = fuxi.shift_labels(h, w, cfg.window).to(device) if shifted else None
    return qkv, (scale, bias, order.int(), torch.argsort(order), labels)


@pytest.mark.parametrize("b,shifted", [(1, False), (1, True), (2, False), (2, True)])
def test_cuda_cosine_window_attention_matches_plain_version(cuda_device, b, shifted):
    """FuXi's attention kernel against its plain version (the chain of
    PyTorch calls with SDPA) at FuXi-Short's shape. Both keep the chain's
    rounding points (q and k rounded once to bf16 after f32 norms, f32
    scores and softmax, bf16 P, f32 sums of P v); they differ in the order of
    the f32 sums, in where P is normalized (SDPA's flash kernel after P v,
    the kernel before) and in the mask, which the kernel adds in f32 and the
    plain version in bf16 with the bias: the repo's kernel bound, max|d| /
    max(1, max|ref|) < 0.04 and RMS(d) / RMS(ref) < 0.01."""
    from pangu_tpu_torch.ops import cosine_attention as tca

    qkv, args = _fuxi_attention_inputs(cuda_device, b, shifted, seed=3 + b)
    before = tca.LAUNCHES
    got = tca.cosine_window_attention(qkv, *args)
    torch.cuda.synchronize()
    assert tca.LAUNCHES == before + 1
    assert got.shape == (b, *FUXI_GRID, 1536) and got.dtype == torch.bfloat16
    ref = tca.cosine_window_attention_reference(qkv.clone(), *args)
    assert torch.isfinite(got).all()
    assert _bounded(got, ref)


@pytest.mark.parametrize("shifted", [False, True])
def test_cuda_cosine_window_attention_at_96_places(cuda_device, shifted):
    """Windows of 8 x 12 = 96 places, the most the kernel takes (its twelfth
    tile of keys holds real keys), on a 16 x 24 token grid, C 64 in two
    heads of 32, batch 2: the bound above."""
    from pangu_tpu_torch.model import fuxi_tiny
    from pangu_tpu_torch.ops import cosine_attention as tca

    cfg = fuxi_tiny(lat=129, lon=192, dim=64, heads=2, window=(8, 12))
    assert cfg.tokens == (16, 24)
    qkv, args = _fuxi_attention_inputs(cuda_device, 2, shifted, 5, cfg)
    got = tca.cosine_window_attention(qkv, *args)
    assert _bounded(got, tca.cosine_window_attention_reference(qkv.clone(), *args))


def test_cuda_cosine_window_attention_gives_the_same_bits_twice(cuda_device):
    from pangu_tpu_torch.ops import cosine_attention as tca

    qkv, args = _fuxi_attention_inputs(cuda_device, 2, True, seed=9)
    first = tca.cosine_window_attention(qkv, *args)
    second = tca.cosine_window_attention(qkv, *args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_cuda_cosine_window_attention_refuses_before_any_launch(cuda_device):
    """f32 qkv, heads of 64, windows of 100 places, a strided qkv, an int64
    order: ValueError, and no launch."""
    from pangu_tpu_torch.model import fuxi
    from pangu_tpu_torch.ops import cosine_attention as tca

    qkv, (scale, bias, order, inverse, labels) = _fuxi_attention_inputs(
        cuda_device, 1, True, seed=1)
    big = torch.zeros((1, 20, 40, 3 * 64), dtype=torch.bfloat16, device=cuda_device)
    order10 = fuxi.window_order(20, 40, (10, 10), False).to(cuda_device)
    cases = [
        (qkv.float(), scale, bias, order, inverse, labels),
        (qkv, scale[:, :24], bias[:, :24], order, inverse, labels),
        (big, scale[:, :2], torch.zeros((1, 2, 100, 100), dtype=torch.bfloat16,
                                        device=cuda_device), order10.int(), order10, None),
        (qkv[:, :, :90], scale, bias, order[:8100], inverse, None),
        (qkv, scale, bias, order.long(), inverse, labels),
    ]
    before = tca.LAUNCHES
    for case in cases:
        with pytest.raises(ValueError):
            tca.cosine_window_attention(*case)
    assert tca.LAUNCHES == before


def test_cuda_fuxi_step_launches_the_kernel_once_a_block(cuda_device, monkeypatch):
    """A bf16 FuXi step on a small grid (18x36 tokens of 9x9 windows, C 64
    in two heads of 32, four blocks): one launch a block, and the output of
    the step with every block on the plain version within RMS 0.01 of its
    own RMS in normalized units (the bf16 rounding of the attention outputs
    carried through four blocks, the Up Block and the head)."""
    from pangu_tpu_torch.model import FuxiConstants, FuxiModel, fuxi, fuxi_tiny
    from pangu_tpu_torch.ops import cosine_attention as tca

    cfg = fuxi_tiny(lat=145, lon=288, dim=64, heads=2, window=(9, 9),
                    compute_dtype="bfloat16")
    torch.manual_seed(0)
    with torch.device(cuda_device):
        model, plain = FuxiModel(cfg), FuxiModel(cfg)
    plain.load_state_dict(model.state_dict())
    v = cfg.variables
    k = FuxiConstants(torch.zeros((1, v, 1, 1), device=cuda_device),
                      torch.ones((1, v, 1, 1), device=cuda_device))
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    a, b = (torch.randn((1, v, cfg.lat, cfg.lon), generator=gen, device=cuda_device)
            for _ in range(2))
    before = tca.LAUNCHES
    got = make_forecast_step(model, k)(a, b)[1]
    torch.cuda.synchronize()
    assert tca.LAUNCHES == before + cfg.depth
    monkeypatch.setattr(fuxi, "cosine_window_attention", tca.cosine_window_attention_reference)
    want = make_forecast_step(plain, k)(a, b)[1]
    assert tca.LAUNCHES == before + cfg.depth
    d = (got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt()
    assert torch.isfinite(got).all() and d.item() < 0.01


def test_fuxi_short_step_launches_the_kernel_once_a_block(cuda_device):
    """One bf16 FuXi-Short step at its published widths (48 Swin V2 blocks
    at C 1536, seeded weights and states): 48 launches of the cosine window
    attention kernel, and a finite state."""
    from pangu_tpu_torch.model import FuxiConstants, FuxiModel, fuxi_short

    cfg = fuxi_short()
    with torch.random.fork_rng(devices=[cuda_device]), torch.device(cuda_device):
        torch.manual_seed(23)
        model = FuxiModel(cfg)
    v = cfg.variables
    k = FuxiConstants(torch.zeros((1, v, 1, 1), device=cuda_device),
                      torch.ones((1, v, 1, 1), device=cuda_device))
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    state = [torch.randn((1, v, cfg.lat, cfg.lon), generator=gen, device=cuda_device)
             for _ in range(2)]
    before = card.launches()
    out = make_forecast_step(model, k)(*state)[1]
    torch.cuda.synchronize()
    assert card.launched(before) == {"cosine_window_attention": cfg.depth} and cfg.depth == 48
    assert bool(torch.isfinite(out).all())
