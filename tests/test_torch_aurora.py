"""Aurora in the port (``pangu_tpu_torch.model.aurora``) against the
benchmark's plain f32 reference (``benchmark/reference/aurora.py``, kept
once and imported here) at ``aurora_tiny``, on the CPU: the forward and the
clocked step, the bf16 route within its tolerance, the shift mask, the
bottom stage's pad, the Fourier encodings and AdaLN against values worked
out by hand, the published size, the step's profiler ranges and a 20-step
rollout."""

import dataclasses
import math
import re
from collections import Counter

import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import aurora as reference
from pangu_tpu_torch.model import AuroraConstants, AuroraModel, aurora_pretrained, aurora_tiny
from pangu_tpu_torch.model import aurora
from pangu_tpu_torch.rollout import make_forecast_step, rollout

#: bf16 rounds each product's operands and the residual stream to an 8-bit
#: mantissa (2^-9 relative); over the tiny model's 12 blocks, both Perceivers
#: and the heads the gaps add to 0.6-0.85% of the output's RMS (6 seeds). The
#: limit leaves 3x that; fp8 e4m3's 3-bit mantissa (2^-4) reads 5.2-7.0%.
BF16_REL_RMS = 0.025


def _weights(cfg, seed=3):
    """Every parameter of ``cfg``: 0.02 x a normal cut at 2, plus 1 on the
    LayerNorm scales."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in reference.param_shapes(dataclasses.asdict(cfg)).items():
        t = torch.randn(shape, generator=g).clamp(-2, 2) * 0.02
        if re.search(r"norm\d?\.weight$", name):
            t += 1.0
        out[name] = t
    return out


def _setup(seed=3, **kw):
    """(cfg, params, constants, state, the f32 model): the state (u_prev,
    s_prev, u, s, hours) physical, the clock 2020-01-01 00 UTC."""
    cfg = aurora_tiny(**kw)
    params = _weights(cfg, seed)
    g = torch.Generator().manual_seed(seed + 1)
    lv, shape = cfg.levels, (cfg.lat, cfg.lon)
    k = reference.Constants(torch.randn(1, 5, lv, 1, 1, generator=g),
                            1.5 + torch.rand(1, 5, lv, 1, 1, generator=g),
                            torch.randn(1, 4, 1, 1, generator=g),
                            1.5 + torch.rand(1, 4, 1, 1, generator=g),
                            torch.randn(3, *shape, generator=g))

    def upper():
        return k.upper_mean + k.upper_std * torch.randn(1, 5, lv, *shape, generator=g)

    def surface():
        return k.surface_mean + k.surface_std * torch.randn(1, 4, *shape, generator=g)

    state = (upper(), surface(), upper(), surface(), torch.tensor([438288.0]))
    model = AuroraModel(cfg)
    model.load_state_dict(params)
    return cfg, params, k, state, model


def _aux(k):
    return AuroraConstants(**dataclasses.asdict(k))


def _rel(prog_physical, ref_normalized, k):
    """RMS over upper and surface of the normalized gap, over the reference's."""
    (pu, ps), (ru, rs) = prog_physical, ref_normalized
    du, ds = (pu - k.upper_mean) / k.upper_std - ru, (ps - k.surface_mean) / k.surface_std - rs
    return float(((du.square().sum() + ds.square().sum())
                  / (ru.square().sum() + rs.square().sum())).sqrt())


def test_forward_matches_the_reference_in_f32():
    """Summation order alone separates them: the program's windows go through
    ``scaled_dot_product_attention``, its encodings, queries and AdaLN
    affines are computed once per call, its AdaLN is one LayerNorm with the
    affine folded in."""
    cfg, params, k, state, model = _setup()
    with torch.no_grad():
        got = model(*state, _aux(k))
    want = reference.forward(params, dataclasses.asdict(cfg), *state, k)
    assert got[0].shape == want[0].shape == (1, 5, cfg.levels, cfg.lat, cfg.lon)
    assert got[1].shape == want[1].shape == (1, 4, cfg.lat, cfg.lon)
    assert _rel(got, want, k) <= 1e-5


def test_three_chained_steps_follow_the_reference_and_advance_the_clock():
    cfg, params, k, state, model = _setup(seed=5)
    step = make_forecast_step(model, _aux(k))
    m = dataclasses.asdict(cfg)
    ref = tuple(state)
    for i in range(3):
        prev = state
        state = step(*state)
        assert state[0] is prev[2] and state[1] is prev[3]
        assert state[4].tolist() == [438288.0 + 6 * (i + 1)]
        nxt = reference.to_physical(*reference.forward(params, m, *ref, k), k)
        ref = (ref[2], ref[3], *nxt, ref[4] + 6.0)
        assert _rel(state[2:4], [(ref[2] - k.upper_mean) / k.upper_std,
                                 (ref[3] - k.surface_mean) / k.surface_std], k) <= 1e-5
    # the clock enters the step: the last input a day later gives another forecast
    again = step(*prev)
    assert torch.equal(again[2], state[2]) and torch.equal(again[3], state[3])
    later = step(*prev[:4], prev[4] + 24.0)
    assert _rel(later[2:4], [(state[2] - k.upper_mean) / k.upper_std,
                             (state[3] - k.surface_mean) / k.surface_std], k) > 1e-3


def test_bf16_within_its_tolerance_and_fp8_outside():
    cfg, params, k, state, _ = _setup(seed=7)
    m = dataclasses.asdict(cfg)
    want = reference.forward(params, m, *state, k)
    model = AuroraModel(dataclasses.replace(cfg, compute_dtype="bfloat16"))
    model.load_state_dict(params)
    out = make_forecast_step(model, _aux(k))(*state)
    assert model.backbone.encoder[0][0].qkv.weight.dtype == torch.bfloat16  # cast once, when made
    assert out[2].dtype == out[3].dtype == torch.float32
    assert 1e-4 < _rel(out[2:4], want, k) <= BF16_REL_RMS
    fp8 = reference.forward(params, m, *state, k, "fp8")
    num = (fp8[0] - want[0]).square().sum() + (fp8[1] - want[1]).square().sum()
    assert float((num / (want[0].square().sum() + want[1].square().sum())).sqrt()) > BF16_REL_RMS


def test_the_shift_masks_regions_and_the_longitude_wrap():
    """A 4 x 12 x 24 grid of (2, 6, 12) windows rolled by (1, 3, 6): levels
    split at 2 and 3, rows at 6 and 9, columns never. Windows go longitude
    first, then (level window, lat window): type 1 is (levels 0-1, rows
    6-11), type 3 (levels 2-3, rows 6-11)."""
    mask = aurora.shift_mask((4, 12, 24), (2, 6, 12))
    assert mask.shape == (8, 1, 144, 144)
    mask = mask[:, 0]

    def tok(dz, dh, dw):
        return (dz * 6 + dh) * 12 + dw

    cases = [(0, (0, 0, 0), (1, 5, 11), 0.0), (1, (0, 0, 0), (1, 2, 11), 0.0),
             (1, (0, 0, 0), (0, 3, 5), -100.0), (3, (0, 0, 0), (0, 2, 11), 0.0),
             (3, (0, 0, 0), (1, 0, 0), -100.0), (3, (0, 0, 0), (0, 3, 0), -100.0),
             (3, (1, 3, 0), (1, 5, 11), 0.0), (2, (0, 0, 0), (1, 5, 0), -100.0)]
    for t, a, b, want in cases:
        for lon_window in (0, 1):  # the last longitude window is no different: it wraps
            w = 4 * lon_window + t
            assert mask[w, tok(*a), tok(*b)] == want == mask[w, tok(*b), tok(*a)]
    assert torch.equal(mask[:4], mask[4:])
    assert mask[0].eq(0).all()
    # type 3's four regions (a level by a half of the rows) hold 36 tokens each
    assert (mask[3] == 0).sum(1).eq(36).all()


@pytest.mark.parametrize("shifted", [False, True])
def test_the_bottom_stage_pads_both_ends_and_crops(shifted):
    """The published bottom grid 4 x 45 x 90 pads to 4 x 48 x 96 (lat 1 + 2,
    lon 3 + 3), the tiny one 4 x 3 x 6 by the same split. On a 4 x 9 x 18
    grid (two windows each way once padded) the padded attention equals the
    attention on a grid of zero tokens at those places (whose qkv is the
    bias), cropped back, and differs from a pad at the ends alone."""
    assert aurora.window_pads((4, 45, 90), (2, 6, 12)) == ((1, 2), (3, 3))
    assert aurora.window_pads((4, 3, 6), (2, 6, 12)) == ((1, 2), (3, 3))
    assert aurora.window_pads((4, 90, 180), (2, 6, 12)) == ((0, 0), (0, 0))
    geo = aurora.StageGeometry((4, 9, 18), aurora.window_pads((4, 9, 18), (2, 6, 12)), (2, 6, 12))
    assert geo.padded == (4, 12, 24) and geo.shift == (1, 3, 6)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 9, 18, 16, generator=g)
    w, b = torch.randn(48, 16, generator=g) * 0.3, torch.randn(48, generator=g)
    mask = aurora.shift_mask(geo.padded, geo.window) if shifted else None
    got = aurora.window_attention(F.linear(x, w, b), b, 2, geo, aurora.window_order(geo, shifted),
                                  mask)
    assert got.shape == (1, 4, 9, 18, 16)
    whole = aurora.StageGeometry(geo.padded, ((0, 0), (0, 0)), geo.window)

    def padded(pads):
        return aurora.window_attention(F.linear(F.pad(x, pads), w, b), b, 2, whole,
                                       aurora.window_order(whole, shifted), mask)

    want = padded((0, 0, 3, 3, 1, 2))[:, :, 1:10, 3:21]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert not torch.allclose(got, padded((0, 0, 0, 6, 0, 3))[:, :, :9, :18], atol=1e-3)


def test_fourier_encodings_and_the_patch_geometry_by_hand():
    enc = aurora.fourier(torch.tensor([2.5]), 6, (1.0, 100.0))  # wavelengths 1, 10, 100
    want = [math.sin(5 * math.pi), 1.0, math.sin(math.pi / 20), -1.0, 0.0, math.cos(math.pi / 20)]
    assert enc[0].tolist() == pytest.approx(want, abs=2e-6)
    assert aurora.fourier(torch.zeros(3, 2), 8, (1.0, 10.0)).shape == (3, 2, 8)
    torch.testing.assert_close(aurora.fourier(torch.tensor([438288.0]), 32, (1.0, 8766.0)),
                               reference.encode(torch.tensor([438288.0]), 32, "time"),
                               rtol=0, atol=0)
    cfg = aurora_tiny()  # 48 x 96: rows 3.75 degrees apart, patches of 15 x 15 degrees
    rows, cols, area = aurora.patch_geometry(cfg)
    assert rows.shape == (12, 24)
    assert rows[0, 0] == pytest.approx(90 + 90 - 3.75 * 1.5) and cols[0, 1] == pytest.approx(
        15 + 5.625)
    r2 = 6371.0 ** 2 * math.radians(15)
    assert area[0, 3] == pytest.approx(r2 * (1 - math.sin(math.radians(90 - 13.125))), rel=1e-6)
    centre = 90 - 3.75 * (24 + 1.5)  # row 6, just south of the equator
    assert area[6, 0] == pytest.approx(r2 * (math.sin(math.radians(centre + 7.5))
                                             - math.sin(math.radians(centre - 7.5))), rel=1e-6)
    pub = aurora.patch_geometry(aurora_pretrained())[2]
    assert float(pub.sum()) == pytest.approx(4 * math.pi * 6371.0 ** 2, rel=1e-3)


def test_adaln_with_zero_modulation_is_a_plain_layer_norm():
    g = torch.Generator().manual_seed(1)
    norm = aurora.AdaLN(8, 4)
    y, c = torch.randn(2, 3, 8, generator=g), torch.randn(4, generator=g)
    with torch.no_grad():
        norm.modulation.weight.zero_()
        norm.modulation.bias.zero_()
        torch.testing.assert_close(aurora.ada_layer_norm(y, *norm.affine(c)),
                                   F.layer_norm(y, (8,)), rtol=0, atol=0)
        norm.modulation.bias.copy_(torch.arange(16.0) / 16)  # shift first, then scale
        weight, bias = norm.affine(c)
        assert bias.tolist() == pytest.approx([i / 16 for i in range(8)])
        assert weight.tolist() == pytest.approx([1 + i / 16 for i in range(8, 16)])


def test_aurora_pretrained_holds_its_published_size():
    cfg = aurora_pretrained()
    with torch.device("meta"):
        model = AuroraModel(cfg)
    d, hd, patch, e = 512, 1024, 2 * 4 * 4, 1024

    def lin(i, o, bias=True):
        return i * o + o * bias

    def perceiver(n, ratio):
        return (lin(n, hd, False) + lin(n, 2 * hd, False) + lin(hd, n, False) + 4 * n
                + lin(n, ratio * n) + lin(ratio * n, n))

    def block(c):
        return lin(c, 3 * c) + lin(c, c) + lin(c, 4 * c) + lin(4 * c, c) + 2 * lin(d, 2 * c)

    encoder = (lin(7 * patch, d) + 2 * d + lin(5 * patch, d) + lin(d, d) + 3 * d
               + perceiver(d, 4) + 4 * lin(d, d))
    backbone = (2 * lin(d, d) + 12 * block(512) + 20 * block(1024) + 16 * block(2048)
                + sum(8 * c + lin(4 * c, 2 * c, False) for c in (512, 1024))
                + sum(lin(c, 2 * c, False) + c + lin(c // 2, c // 2, False) for c in (2048, 1024)))
    decoder = lin(e, e) + perceiver(e, 2) + lin(e, 5 * 16) + lin(e, 4 * 16)
    count = encoder + backbone + decoder
    assert sum(p.numel() for p in model.parameters()) == count == 1_255_248_528
    shapes = reference.param_shapes(dataclasses.asdict(cfg))
    assert {n: tuple(p.shape) for n, p in model.state_dict().items()} == shapes
    assert cfg.grids == [(4, 180, 360), (4, 90, 180), (4, 45, 90)]
    assert [g.padded for g in model.geometry] == [(4, 180, 360), (4, 90, 180), (4, 48, 96)]


NAMES = ("aurora.encode", "aurora.block", "aurora.block.attention", "aurora.resample",
         "aurora.decode")


def test_the_step_opens_its_ranges_under_a_profiler_and_none_without(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    cfg, _, k, state, model = _setup()
    step = make_forecast_step(model, _aux(k))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            state = step(*state)
    counts = Counter(e.name for e in prof.events() if e.name in NAMES)
    blocks = sum(cfg.encoder_depths) + sum(cfg.decoder_depths)
    assert counts == {"aurora.encode": 2, "aurora.block": 2 * blocks,
                      "aurora.block.attention": 2 * blocks, "aurora.resample": 2 * 4,
                      "aurora.decode": 2}

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    step(*state)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_twenty_step_rollout_stays_finite(dtype):
    cfg, params, k, state, _ = _setup(seed=9, compute_dtype=dtype)
    model = AuroraModel(cfg)
    model.load_state_dict(params)
    traj = rollout(model, state, _aux(k), 20)
    u_prev, s_prev, u, s, hours = traj
    assert u.shape == (20, 1, 5, cfg.levels, cfg.lat, cfg.lon) and s.shape == (20, 1, 4, cfg.lat,
                                                                               cfg.lon)
    assert torch.isfinite(u).all() and torch.isfinite(s).all()
    assert torch.equal(u_prev[1:], u[:-1]) and torch.equal(s_prev[1:], s[:-1])
    assert hours[:, 0].tolist() == [438288.0 + 6 * (i + 1) for i in range(20)]
    last = rollout(model, state, _aux(k), 2, keep_trajectory=False)
    assert torch.equal(last[2], u[1]) and torch.equal(last[4], hours[1])
