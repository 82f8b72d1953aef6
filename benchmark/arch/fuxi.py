"""FuXi (Chen et al. 2023, arXiv:2306.12873) in the benchmark: the
architecture module of ``fuxi_short_bf16``, keeping the contract's forecast
part (``benchmark/arch/__init__.py``). It has no training part: FuXi's
configuration gives no recipe, so a train cell on it is refused.

The program is ``pangu_tpu_torch``, reached through its public entry points:
``FuxiModel``, ``FuxiConstants`` and ``make_forecast_step``. A state is the
pair (x_{t-1}, x_t), each (B, V, lat, lon) in physical units; a step maps it
to (x_t, x_{t+1}). The plain reference (``reference/fuxi.py``) returns the
next state normalized, and the gaps are read in normalized units.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark import inputs
from benchmark.reference import fuxi as reference
from benchmark.reference.fuxi import Constants, grid, param_shapes

#: every branch of the real geometry at a CPU size: the dropped latitude row,
#: a 6x12 token grid of 3x3 windows (all nine shift regions), shifted and
#: unshifted blocks twice each
TINY = dict(lat=49, lon=96, variables=5, dim=32, depth=4, heads=4, window=[3, 3],
            cpb_hidden=16, groups=4)


# ---- the program ----------------------------------------------------------------------


def build_kernels() -> None:
    """Nothing to build: FuXi runs no kernel of the program."""


def program_config(config: dict):
    """The program's ``FuxiConfig`` of a configuration file."""
    import dataclasses

    from pangu_tpu_torch.model.fuxi import FuxiConfig

    names = {f.name for f in dataclasses.fields(FuxiConfig)}
    return FuxiConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in config["model"].items() if k in names})


def build_model(cell, seed: int, device):
    """(FuxiConfig, the model on ``device`` holding the seed's weights),
    built without initializing the weights it then loads."""
    from pangu_tpu_torch.model.fuxi import FuxiModel

    cfg = program_config(cell.config)
    with torch.device("meta"):
        model = FuxiModel(cfg)
    model.to_empty(device=device)
    w = weights(cell.config, seed, device)
    model.load_state_dict(w, strict=True)
    del w
    return cfg, model


def aux_constants(k: Constants):
    from pangu_tpu_torch.model.fuxi import FuxiConstants

    return FuxiConstants(mean=k.mean, std=k.std)


def forecast_step(model, aux):
    from pangu_tpu_torch.rollout import make_forecast_step

    return make_forecast_step(model, aux)


# ---- the inputs -----------------------------------------------------------------------


def weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter, float32, as views of one buffer drawn in one call:
    0.02 x a normal cut at 2, plus 1 on the LayerNorm and GroupNorm scales
    and log 10 on the logit scales."""
    shapes = param_shapes(config["model"])
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=inputs.generator(seed, "weights", device),
                       device=device)
    flat.clamp_(-2.0, 2.0).mul_(0.02)
    out = {}
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):
        t = part.view(shape)
        if ".norm" in name and name.endswith(".weight"):
            t.add_(1.0)
        elif name.endswith(".logit_scale"):
            t.add_(math.log(10.0))
        out[name] = t
    return out


def constants(config: dict, seed: int, device) -> Constants:
    """Normalization statistics around 0 with spreads in [1.5, 2.5]."""
    v = config["model"]["variables"]
    gen = inputs.generator(seed, "constants", device)
    mean = torch.randn((1, v, 1, 1), generator=gen, device=device)
    std = 1.5 + torch.rand((1, v, 1, 1), generator=gen, device=device)
    return Constants(mean=mean, std=std)


def states(config: dict, k: Constants, seed: int, device, count: int,
           batch: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``count`` physical pairs (x_{t-1}, x_t), each (B, V, lat, lon): mean +
    std x a unit normal, drawn in one call."""
    m = config["model"]
    gen = inputs.generator(seed, "states", device)
    x = torch.randn((count, 2, batch, m["variables"], m["lat"], m["lon"]), generator=gen,
                    device=device)
    x.mul_(k.std).add_(k.mean)
    return [tuple(pair.unbind(0)) for pair in x.unbind(0)]


# ---- the reference and the comparison -------------------------------------------------


def reference_step(params: dict, config: dict, state: tuple, k: Constants,
                   precision: str = "f32"):
    """(x_t as given, the reference's normalized x_{t+1}) from a physical
    pair (x_{t-1}, x_t)."""
    return state[1], reference.forward(params, config["model"], *state, k, precision)


def to_state(out, k: Constants):
    return out[0], reference.to_physical(out[1], k)


@torch.no_grad()
def forecast_gaps(state, out, k: Constants) -> Dict[str, float]:
    """``state`` the program's physical pair, ``out`` the reference's: the
    gaps in normalized units of the forecast and of the passed-through x_t
    (which a sound step returns as it was given), over the RMS of the
    reference's forecast."""
    (prog_cur, prog_next), (ref_cur, ref_next) = state, out
    d = [(prog_next - k.mean) / k.std - ref_next, (prog_cur - ref_cur) / k.std]
    num = sum(x.double().square().sum() for x in d)
    den = ref_next.double().square().sum()
    return {"rel_rms": math.sqrt(float(num / den)),
            "max_abs": max(float(x.abs().max()) for x in d)}


# ---- the work -------------------------------------------------------------------------


def forward_matmul_flops(config: dict, batch: int = 1) -> float:
    """2 FLOP per multiply-add of every product of one step: the embedding
    (one product over the patches), the convolutions (the 3x3 ones over the
    zero pad too), the blocks' four linears and two window products, the
    head. The position-bias MLP is left out: its tables depend on the
    weights alone, and the program makes them once per model."""
    m = config["model"]
    c, v, r = m["dim"], m["variables"], m["mlp_ratio"]
    kt, kh, kw = m["cube"]
    h, w = grid(m)
    tokens, half = h * w, (h // 2) * (w // 2)
    window = m["window"][0] * m["window"][1]
    res = 2 * 2.0 * 9 * c * c
    embed = 2.0 * tokens * v * kt * kh * kw * c
    down = 2.0 * half * 9 * c * c + half * res
    block = 2.0 * half * (3 + 1 + 2 * r) * c * c + 2 * 2.0 * half * window * c
    up = 2.0 * half * 2 * c * 4 * c + tokens * res
    head = 2.0 * tokens * c * v * kh * kw
    return batch * (embed + down + m["depth"] * block + up + head)
