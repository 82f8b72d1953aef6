"""FuXi in the port (``pangu_tpu_torch.model.fuxi``) against its plain f32
reference (``tests/fuxi_reference.py``) at ``fuxi_tiny``, on the CPU: the
forward and the two-state step, the bf16 route within its tolerance, the
position-bias tables and the shift mask against values worked out by hand,
the published size, a 20-step rollout and the step's profiler ranges."""

import dataclasses
import math
import os
from collections import Counter

import pytest
import torch

import fuxi_reference as reference
from pangu_tpu_torch.model import FuxiConstants, FuxiModel, fuxi_short, fuxi_tiny
from pangu_tpu_torch.model import fuxi
from pangu_tpu_torch.rollout import make_forecast_step, rollout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: bf16 rounds each product's operands and the residual stream to an 8-bit
#: mantissa (2^-9 relative); over the tiny model's 4 blocks, the convolutions
#: and the head the gaps add to about 1% of the output's RMS. The limit leaves
#: 3x that; fp8 e4m3's 3-bit mantissa (2^-4) reads about 9%.
BF16_REL_RMS = 0.03


def _weights(cfg, seed=3):
    """Every parameter of ``cfg``: 0.02 x a normal cut at 2, plus 1 on the
    norms' scales and log 10 on the logit scales."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in reference.param_shapes(dataclasses.asdict(cfg)).items():
        t = torch.randn(shape, generator=g).clamp(-2, 2) * 0.02
        if ".norm" in name and name.endswith(".weight"):
            t += 1.0
        elif name.endswith(".logit_scale"):
            t += math.log(10.0)
        out[name] = t
    return out


def _setup(seed=3, **kw):
    cfg = fuxi_tiny(**kw)
    params = _weights(cfg, seed)
    g = torch.Generator().manual_seed(seed + 1)
    v = cfg.variables
    k = reference.Constants(torch.randn(1, v, 1, 1, generator=g),
                            1.5 + torch.rand(1, v, 1, 1, generator=g))
    states = [k.mean + k.std * torch.randn(1, v, cfg.lat, cfg.lon, generator=g) for _ in range(2)]
    model = FuxiModel(cfg)
    model.load_state_dict(params)
    return cfg, params, k, states, model


def _rel(prog_physical, ref_normalized, k):
    d = (prog_physical - k.mean) / k.std - ref_normalized
    return float(d.norm() / ref_normalized.norm())


def test_forward_matches_the_reference_in_f32():
    """Summation order alone separates them: the program's embedding is one
    product over patches and its attention goes through
    ``scaled_dot_product_attention`` on gathered windows."""
    cfg, params, k, (a, b), model = _setup()
    with torch.no_grad():
        got = model(a, b, FuxiConstants(k.mean, k.std))
    want = reference.forward(params, dataclasses.asdict(cfg), a, b, k)
    assert got.shape == want.shape == (1, cfg.variables, cfg.lat, cfg.lon)
    assert _rel(got, want, k) <= 1e-5


def test_three_chained_steps_follow_the_reference():
    cfg, params, k, state, model = _setup(seed=5)
    step = make_forecast_step(model, FuxiConstants(k.mean, k.std))
    m = dataclasses.asdict(cfg)
    ref = tuple(state)
    for _ in range(3):
        prev = state
        state = step(*state)
        assert state[0] is prev[1]
        ref = (ref[1], reference.to_physical(reference.forward(params, m, *ref, k), k))
        assert _rel(state[1], (ref[1] - k.mean) / k.std, k) <= 1e-5
        torch.testing.assert_close(state[0], ref[0], rtol=1e-5, atol=1e-5)


def test_bf16_within_its_tolerance_and_fp8_outside():
    cfg, params, k, (a, b), _ = _setup(seed=7)
    m = dataclasses.asdict(cfg)
    want = reference.forward(params, m, a, b, k)
    model = FuxiModel(dataclasses.replace(cfg, compute_dtype="bfloat16"))
    model.load_state_dict(params)
    _, got = make_forecast_step(model, FuxiConstants(k.mean, k.std))(a, b)
    assert model.blocks[0].mlp.linear1.weight.dtype == torch.bfloat16  # cast once, when made
    assert got.dtype == torch.float32
    assert 1e-4 < _rel(got, want, k) <= BF16_REL_RMS
    fp8 = reference.forward(params, m, a, b, k, "fp8")
    assert float((fp8 - want).norm() / want.norm()) > BF16_REL_RMS


def _f(d):
    """Swin V2's map of an offset of a 9x9 window: d / 8 * 8 = d, then
    sign(d) log2(1 + |d|) / log2(8)."""
    return math.copysign(math.log2(1 + abs(d)) / 3, d) if d else 0.0


def test_log_spaced_offsets_and_the_position_bias_of_a_9x9_window():
    table = fuxi.log_spaced_offsets((9, 9))
    assert table.shape == (17, 17, 2)
    for dh, dw, want in [(-8, 3, (-math.log2(9) / 3, 2 / 3)), (1, -7, (1 / 3, -1.0)),
                         (0, 8, (0.0, math.log2(9) / 3)), (7, 0, (1.0, 0.0))]:
        assert table[dh + 8, dw + 8].tolist() == pytest.approx(want, abs=1e-6)
    index = fuxi.relative_index((9, 9))
    # token 80 is (8, 8), token 0 is (0, 0), token 13 is (1, 4)
    assert index[80, 0] == 16 * 17 + 16 and index[0, 80] == 0 and index[13, 80] == 1 * 17 + 4
    assert index.diagonal().eq(8 * 17 + 8).all()
    attn = fuxi.CosineWindowAttention(32, 2, 4)
    with torch.no_grad():  # hidden units (relu(a), relu(-a), relu(b)); heads a-b, 2a+b
        attn.cpb_mlp[0].weight.copy_(torch.tensor([[1., 0.], [-1., 0.], [0., 1.], [0., 0.]]))
        attn.cpb_mlp[0].bias.zero_()
        attn.cpb_mlp[2].weight.copy_(torch.tensor([[1., -1., -1., 0.], [2., -2., 1., 0.]]))
    bias = attn.position_bias((9, 9))
    for i, j in [(80, 0), (13, 80), (40, 40), (9, 71)]:
        (hi, wi), (hj, wj) = divmod(i, 9), divmod(j, 9)
        a, b = _f(hi - hj), _f(wi - wj)
        want = [16 / (1 + math.exp(-(a - max(b, 0)))), 16 / (1 + math.exp(-(2 * a + max(b, 0))))]
        assert bias[:, i, j].tolist() == pytest.approx(want, abs=1e-5)


def test_the_shift_masks_regions():
    """An 18x18 grid of 9x9 windows shifted by 4: rows and columns split at
    9 and 14. Windows go longitude-major: 0 (lat 0, lon 0), 1 (lat 1, lon
    0), 3 (lat 1, lon 1)."""
    mask = fuxi.shift_mask(18, 18, (9, 9))
    assert mask.shape == (4, 81, 81)
    assert mask[0].eq(0).all() and mask[2].unique().tolist() == [-100.0, 0.0]

    def tok(r, c):
        return 9 * r + c

    cases = [(1, (0, 0), (4, 8), 0.0), (1, (0, 0), (5, 0), -100.0), (3, (0, 0), (4, 4), 0.0),
             (3, (0, 0), (5, 4), -100.0), (3, (0, 0), (4, 5), -100.0), (3, (8, 8), (5, 5), 0.0),
             (3, (0, 8), (8, 0), -100.0)]
    for win, a, b, want in cases:
        assert mask[win, tok(*a), tok(*b)] == want == mask[win, tok(*b), tok(*a)]
    # the four regions of window 3 hold 25, 20, 20 and 16 tokens
    zeros = (mask[3] == 0).sum(1)
    assert sorted(Counter(zeros.tolist()).items()) == [(16, 16), (20, 40), (25, 25)]


def test_the_window_order_gathers_the_rolled_grid():
    h, w, win = 6, 12, (3, 3)
    grid = torch.arange(h * w).view(h, w)
    for shifted in (False, True):
        order = fuxi.window_order(h, w, win, shifted)
        rolled = torch.roll(grid, (-1, -1), (0, 1)) if shifted else grid
        # window 0 holds the rolled grid's first 3x3 tokens; window 1 the next lat window
        assert order[:9].tolist() == rolled[:3, :3].flatten().tolist()
        assert order[9:18].tolist() == rolled[3:6, :3].flatten().tolist()
        assert sorted(order.tolist()) == list(range(h * w))


def test_fuxi_short_holds_its_published_size():
    cfg = fuxi_short()
    with torch.device("meta"):
        model = FuxiModel(cfg)
    c, v, heads, hid = 1536, 70, 48, 512
    res = 2 * (9 * c * c + c + 2 * c)
    block = 12 * c * c + 2 * c + heads + (3 * hid + hid * heads) + c + 4 * c + c + 4 * c
    count = ((v * 2 * 4 * 4 * c + c + 2 * c) + (9 * c * c + c + res) + 48 * block
             + (2 * c * c * 4 + c + res) + (c * v * 16 + v * 16))
    assert sum(p.numel() for p in model.parameters()) == count == 1_491_325_792
    shapes = reference.param_shapes(dataclasses.asdict(cfg))
    assert {n: tuple(p.shape) for n, p in model.state_dict().items()} == shapes
    assert cfg.grid == (180, 360) and cfg.tokens == (90, 180)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_twenty_step_rollout_stays_finite(dtype):
    cfg, _, k, (a, b), _ = _setup(seed=9, compute_dtype=dtype)
    model = FuxiModel(cfg)
    model.load_state_dict(_weights(cfg, 9))
    prev, cur = rollout(model, (a, b), FuxiConstants(k.mean, k.std), 20)
    assert prev.shape == cur.shape == (20, 1, cfg.variables, cfg.lat, cfg.lon)
    assert torch.isfinite(cur).all() and torch.equal(prev[1:], cur[:-1])
    last = rollout(model, (a, b), FuxiConstants(k.mean, k.std), 20, keep_trajectory=False)
    torch.testing.assert_close(last[1], cur[-1], rtol=0, atol=0)


NAMES = ("fuxi.embed", "fuxi.down", "fuxi.block", "fuxi.block.attention", "fuxi.up",
         "fuxi.head")


def test_the_step_opens_its_ranges_under_a_profiler_and_none_without(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    cfg, _, k, state, model = _setup()
    step = make_forecast_step(model, FuxiConstants(k.mean, k.std))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            step(*state)
    counts = Counter(e.name for e in prof.events() if e.name in NAMES)
    assert counts == {"fuxi.embed": 2, "fuxi.down": 2, "fuxi.block": 2 * cfg.depth,
                      "fuxi.block.attention": 2 * cfg.depth, "fuxi.up": 2, "fuxi.head": 2}

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    step(*state)


def test_the_benchmarks_reference_is_this_one():
    with open(os.path.join(REPO, "tests", "fuxi_reference.py")) as f:
        here = f.read()
    with open(os.path.join(REPO, "benchmark", "reference", "fuxi.py")) as f:
        assert f.read() == here
