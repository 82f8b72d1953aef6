"""Aurora (Bodnar et al. 2024, arXiv:2405.13063) in the benchmark: the
architecture module of ``aurora_pretrained_bf16``, keeping the contract's
forecast part (``benchmark/arch/__init__.py``). It has no training part:
Aurora's pretraining runs over many cards on several datasets, so a train
cell on it is refused.

The program is ``pangu_tpu_torch``, reached through its public entry points:
``AuroraModel``, ``AuroraConstants`` and ``make_forecast_step``. A state is
(u_{t-1}, s_{t-1}, u_t, s_t, hours): the upper (B, 5, 13, lat, lon) and
surface (B, 4, lat, lon) fields at t - 6 h and t in physical units and the
clock at t, hours since 1970, (B,) f32; a step maps it to (u_t, s_t,
u_{t+1}, s_{t+1}, hours + 6). The plain reference (``reference/aurora.py``)
returns the next state normalized, and the gaps are read in normalized units.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import torch

from benchmark import inputs
from benchmark.reference import aurora as reference
from benchmark.reference.aurora import Constants, grids, param_shapes, widths

#: every branch of the real geometry at a CPU size: three stages on a 12x24
#: patch grid with the real (2, 6, 12) windows (the bottom 3x6 stage padded in
#: latitude and longitude), shifted and unshifted blocks in every stage
TINY = dict(lat=48, lon=96, pressures=[100, 250, 500, 850, 1000], dim=32,
            encoder_depths=[2, 2, 2], encoder_heads=[4, 8, 16], decoder_depths=[2, 2, 2],
            decoder_heads=[16, 8, 4], perceiver_heads=4, perceiver_head_dim=8)
#: the clocks drawn: 6-hourly from 2015-01-01 00 UTC to 2025-01-01 00 UTC, in
#: hours since 1970
CLOCK_HOURS = (394464, 482136)


# ---- the program ----------------------------------------------------------------------


def build_kernels() -> None:
    """The Dense operator's source, which the model's resamplers run."""
    from pangu_tpu_torch.ops import _build

    _build.build_all(["outer_dense.cu"])


def program_config(config: dict):
    """The program's ``AuroraConfig`` of a configuration file."""
    import dataclasses

    from pangu_tpu_torch.model.aurora import AuroraConfig

    names = {f.name for f in dataclasses.fields(AuroraConfig)}
    return AuroraConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in config["model"].items() if k in names})


def build_model(cell, seed: int, device):
    """(AuroraConfig, the model on ``device`` holding the seed's weights),
    built without initializing the weights it then loads."""
    from pangu_tpu_torch.model.aurora import AuroraModel

    cfg = program_config(cell.config)
    with torch.device("meta"):
        model = AuroraModel(cfg)
    model.to_empty(device=device)
    w = weights(cell.config, seed, device)
    model.load_state_dict(w, strict=True)
    del w
    return cfg, model


def aux_constants(k: Constants):
    from pangu_tpu_torch.model.aurora import AuroraConstants

    return AuroraConstants(upper_mean=k.upper_mean, upper_std=k.upper_std,
                           surface_mean=k.surface_mean, surface_std=k.surface_std,
                           static=k.static)


def forecast_step(model, aux):
    from pangu_tpu_torch.rollout import make_forecast_step

    return make_forecast_step(model, aux)


# ---- the inputs -----------------------------------------------------------------------


def weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter, float32, as views of one buffer drawn in one call:
    0.02 x a normal cut at 2, plus 1 on the LayerNorm scales."""
    shapes = param_shapes(config["model"])
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=inputs.generator(seed, "weights", device),
                       device=device)
    flat.clamp_(-2.0, 2.0).mul_(0.02)
    out = {}
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):
        t = part.view(shape)
        if re.search(r"norm\d?\.weight$", name):
            t.add_(1.0)
        out[name] = t
    return out


def constants(config: dict, seed: int, device) -> Constants:
    """Normalization statistics around 0 with spreads in [1.5, 2.5], and the
    three static fields as unit normals (normalized units)."""
    m = config["model"]
    gen = inputs.generator(seed, "constants", device)
    lv, vu, vs = len(m["pressures"]), m["upper_vars"], m["surface_vars"]
    return Constants(
        upper_mean=torch.randn((1, vu, lv, 1, 1), generator=gen, device=device),
        upper_std=1.5 + torch.rand((1, vu, lv, 1, 1), generator=gen, device=device),
        surface_mean=torch.randn((1, vs, 1, 1), generator=gen, device=device),
        surface_std=1.5 + torch.rand((1, vs, 1, 1), generator=gen, device=device),
        static=torch.randn((m["static_vars"], m["lat"], m["lon"]), generator=gen, device=device))


def states(config: dict, k: Constants, seed: int, device, count: int,
           batch: int) -> List[Tuple[torch.Tensor, ...]]:
    """``count`` states (u_{t-1}, s_{t-1}, u_t, s_t, hours): each field mean +
    std x a unit normal, drawn in one call a kind, and the clock a 6-hourly
    time of ``CLOCK_HOURS``."""
    m = config["model"]
    gen = inputs.generator(seed, "states", device)
    lv, lat, lon = len(m["pressures"]), m["lat"], m["lon"]
    u = torch.randn((count, 2, batch, m["upper_vars"], lv, lat, lon), generator=gen,
                    device=device)
    u.mul_(k.upper_std).add_(k.upper_mean)
    s = torch.randn((count, 2, batch, m["surface_vars"], lat, lon), generator=gen, device=device)
    s.mul_(k.surface_std).add_(k.surface_mean)
    lo, hi = CLOCK_HOURS
    steps = torch.randint(0, (hi - lo) // 6, (count, batch), generator=gen, device=device)
    hours = (lo + 6 * steps).float()
    return [(up[0], sp[0], up[1], sp[1], h) for up, sp, h in zip(u, s, hours)]


# ---- the reference and the comparison -------------------------------------------------


def reference_step(params: dict, config: dict, state: tuple, k: Constants,
                   precision: str = "f32"):
    """(u_t, s_t as given, the reference's normalized u_{t+1} and s_{t+1},
    hours + lead) from a physical state."""
    m = config["model"]
    u, s = reference.forward(params, m, *state, k, precision)
    return state[2], state[3], u, s, state[4] + float(m["lead_hours"])


def to_state(out, k: Constants):
    return (out[0], out[1], *reference.to_physical(out[2], out[3], k), out[4])


@torch.no_grad()
def forecast_gaps(state, out, k: Constants) -> Dict[str, float]:
    """``state`` the program's physical state, ``out`` the reference's: the
    gaps in normalized units of the forecast and of the passed-through u_t
    and s_t (which a sound step returns as given), over the RMS of the
    reference's forecast. A clock that does not read the reference's
    ``hours + lead`` is an infinite gap."""
    pu, ps, pu1, ps1, ph = state
    ru, rs, ru1, rs1, rh = out
    if not torch.equal(ph, rh):
        return {"rel_rms": math.inf, "max_abs": math.inf}
    d = [(pu1 - k.upper_mean) / k.upper_std - ru1, (ps1 - k.surface_mean) / k.surface_std - rs1,
         (pu - ru) / k.upper_std, (ps - rs) / k.surface_std]
    num = sum(x.double().square().sum() for x in d)
    den = ru1.double().square().sum() + rs1.double().square().sum()
    return {"rel_rms": math.sqrt(float(num / den)),
            "max_abs": max(float(x.abs().max()) for x in d)}


# ---- the work -------------------------------------------------------------------------


def forward_matmul_flops(config: dict, batch: int = 1) -> float:
    """2 FLOP per multiply-add of every product of one step, as the reference
    makes them: the embeddings and encodings (the position and area ones
    per patch, the lead and absolute time per sample, the pressures' and
    both Perceivers' queries once per level or latent, since they are the
    same at every patch), both Perceivers, every block's qkv, window
    products (on the padded grid), projection, MLP and two AdaLN
    modulations, the lead time's MLP, the merges and splits, and the heads."""
    m = config["model"]
    b, d, p, nt = batch, m["dim"], m["patch"], m["history"]
    lv, nl, r = len(m["pressures"]), m["latent_levels"], m["mlp_ratio"]
    inner = m["perceiver_heads"] * m["perceiver_head_dim"]
    patches = (m["lat"] // p) * (m["lon"] // p)
    bp, e = b * patches, 2 * d
    window = m["window"][0] * m["window"][1] * m["window"][2]

    def perceiver(n_q, n_k, dim, ratio):
        return (2.0 * n_q * dim * inner + 2.0 * bp * n_k * dim * 2 * inner
                + 2 * 2.0 * bp * n_q * n_k * inner + 2.0 * bp * n_q * inner * dim
                + 2 * 2.0 * bp * n_q * dim * ratio * dim)

    encoder = (2.0 * bp * lv * m["upper_vars"] * nt * p * p * d + 2.0 * lv * d * d
               + 2.0 * bp * (m["surface_vars"] + m["static_vars"]) * nt * p * p * d
               + perceiver(nl, lv, d, r) + 2 * 2.0 * patches * d * d + 2 * 2.0 * b * d * d)
    backbone = 2 * 2.0 * b * d * d
    ws, gs = widths(m), grids(m)

    def block(c, grid):
        z, h, w = grid
        hp, wp = (n + -n % k for n, k in zip((h, w), m["window"][1:]))
        tokens = b * z * h * w
        return (2.0 * tokens * (3 + 1 + 2 * r) * c * c + 2 * 2.0 * b * z * hp * wp * window * c
                + 2 * 2.0 * b * d * 2 * c)

    for s, (c, g) in enumerate(zip(ws, gs)):
        backbone += (m["encoder_depths"][s] + m["decoder_depths"][-1 - s]) * block(c, g)
    for c, (z, h, w) in zip(ws[:-1], gs[:-1]):
        half = b * z * (h // 2) * (w // 2)
        full = b * z * h * w
        backbone += 2.0 * half * 4 * c * 2 * c  # merge
        backbone += 2.0 * half * 2 * c * 4 * c + 2.0 * full * c * c  # split
    decoder = (2.0 * lv * e * e + perceiver(lv, nl, e, m["decoder_mlp_ratio"])
               + 2.0 * bp * lv * e * m["upper_vars"] * p * p
               + 2.0 * bp * e * m["surface_vars"] * p * p)
    return encoder + backbone + decoder
