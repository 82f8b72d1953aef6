"""Pangu-Weather (arXiv:2211.02556) in the benchmark: the architecture
module of both ``pangu_weather_24h_*`` configurations, keeping the whole
contract of ``benchmark/arch/__init__.py``, training included.

The program is ``pangu_tpu_torch``, reached through its public entry points:
``PanguModel``, ``AuxConstants``, ``make_forecast_step``, ``make_train_step``,
``make_optimizer`` and ``ops._build``. The weights and constants it hands
over are the benchmark's own. A state is (upper (B, Vu, L, lat, lon),
surface (B, Vs, lat, lon)) in physical units; the plain reference
(``reference/pangu.py``) returns the next state normalized, and the gaps are
read in normalized units.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from benchmark import compare, inputs
from benchmark.reference import pangu as reference
from benchmark.reference.pangu import Constants, Stage, grid, param_shapes, stage_of

#: every pad, crop and shifted-window branch of the real geometry: odd
#: latitude, levels needing a pad, latitude needing a window pad after the
#: embedding and after the downsampling, two blocks a layer
TINY = dict(lat=49, lon=96, levels=5, depths=[2, 2, 2, 2], heads=[2, 4, 4, 2],
            dims=[16, 32, 32, 16])


# ---- the program ----------------------------------------------------------------------


def build_kernels() -> None:
    """The program's CUDA kernels, built into the checkout (``build/``)."""
    from pangu_tpu_torch.ops import _build

    _build.build_all([s for s in _build.SOURCES if not s.startswith("bench_")])


def program_config(config: dict):
    """The program's ``PanguConfig`` of a configuration file."""
    from pangu_tpu_torch.config import ModelConfig, PanguConfig, TrainConfig

    def build(cls, values: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in values.items() if k in names})

    return PanguConfig(model=build(ModelConfig, config["model"]),
                       train=build(TrainConfig, config["train"]), horizon=config["horizon"])


def build_model(cell, seed: int, device):
    """(PanguConfig, the model on ``device`` holding the seed's weights)."""
    from pangu_tpu_torch.model import PanguModel

    cfg = program_config(cell.config)
    with torch.device(device):
        model = PanguModel(cfg.model)
    model.to(device)
    w: Dict[str, torch.Tensor] = weights(cell.config, seed, device)
    model.load_state_dict(w, strict=True)
    del w
    return cfg, model


def aux_constants(k: Constants):
    """The program's ``AuxConstants`` holding the benchmark's constants."""
    from pangu_tpu_torch.aux import AuxConstants

    return AuxConstants(surface_mean=k.surface_mean, surface_std=k.surface_std,
                        upper_mean=k.upper_mean, upper_std=k.upper_std,
                        surface_mask=k.surface_mask, const_h=k.const_h,
                        upper_weights=k.upper_weights, surface_weights=k.surface_weights,
                        upper_loss_weight=k.upper_loss_weight,
                        surface_loss_weight=k.surface_loss_weight, custom_mask=None)


def forecast_step(model, aux):
    from pangu_tpu_torch.rollout import make_forecast_step

    return make_forecast_step(model, aux)


def train_step(model, cfg, steps_per_epoch: int):
    """(step(batch, aux, generator) -> loss, its Adam optimizer)."""
    from pangu_tpu_torch.train import make_optimizer, make_train_step

    optimizer = make_optimizer(model, cfg)
    return make_train_step(model, cfg, optimizer, steps_per_epoch=steps_per_epoch), optimizer


def first_moments(optimizer, model) -> Dict[str, torch.Tensor]:
    """Adam's first moment of every parameter by name."""
    state = optimizer.state_dict()["state"]
    return {n: state[i]["exp_avg"] for i, (n, _) in enumerate(model.named_parameters())}


def batch(upper, surface, target_upper, target_surface):
    from pangu_tpu_torch.train import Batch

    return Batch(upper, surface, target_upper, target_surface)


# ---- the inputs -----------------------------------------------------------------------


def weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter, float32, as views of one buffer drawn in one call:
    0.02 x a normal cut at 2 (weights, biases, earth biases), plus 1 on the
    LayerNorm scales."""
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
        out[name] = t
    return out


def constants(config: dict, seed: int, device) -> Constants:
    """Normalization statistics around 0 with spreads in [1.5, 2.5], unit
    normal constant fields, and the configuration's loss weights."""
    m, train = config["model"], config["train"]
    g, gen = grid(m), inputs.generator(seed, "constants", device)
    vs, vu, L = m["surface_vars"], m["upper_vars"], m["levels"]

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def spread(*shape):
        return 1.5 + torch.rand(shape, generator=gen, device=device)

    return Constants(
        surface_mean=normal(1, vs, 1, 1), surface_std=spread(1, vs, 1, 1),
        upper_mean=normal(1, vu, L, 1, 1), upper_std=spread(1, vu, L, 1, 1),
        surface_mask=normal(m["surface_const_channels"], m["lat"] + g.lat_pad, m["lon"]),
        const_h=normal(m["upper_const_channels"], L, m["lat"], m["lon"]),
        upper_weights=torch.tensor(train["upper_weights"], device=device).reshape(1, -1, 1, 1, 1),
        surface_weights=torch.tensor(train["surface_weights"], device=device).reshape(1, -1, 1, 1),
        upper_loss_weight=float(train["upper_loss_weight"]),
        surface_loss_weight=float(train["surface_loss_weight"]))


def states(config: dict, k: Constants, seed: int, device, count: int,
           batch: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``count`` physical states (upper (B, Vu, L, lat, lon), surface (B, Vs,
    lat, lon)): mean + std x a unit normal, drawn in one call each."""
    m = config["model"]
    gen = inputs.generator(seed, "states", device)
    vu, vs, L, lat, lon = m["upper_vars"], m["surface_vars"], m["levels"], m["lat"], m["lon"]
    up = torch.randn((count, batch, vu, L, lat, lon), generator=gen, device=device)
    sf = torch.randn((count, batch, vs, lat, lon), generator=gen, device=device)
    up.mul_(k.upper_std).add_(k.upper_mean)
    sf.mul_(k.surface_std).add_(k.surface_mean)
    return list(zip(up.unbind(0), sf.unbind(0)))


def pairs(config: dict, k: Constants, seed: int, device, traffic: dict) -> List[tuple]:
    """(input upper, input surface, target upper, target surface) x pool."""
    s = states(config, k, seed, device, 2 * traffic["pool"], traffic["batch"])
    return [s[2 * j] + s[2 * j + 1] for j in range(traffic["pool"])]


# ---- the reference and the comparison -------------------------------------------------


def reference_step(params: dict, config: dict, state: tuple, k: Constants,
                   precision: str = "f32"):
    """The reference's normalized (upper, surface) at t + 24 h from a
    physical state at t."""
    return reference.forward(params, config["model"], *state, k, precision)


def to_state(out, k: Constants):
    return reference.to_physical(*out, k)


@torch.no_grad()
def forecast_gaps(state, out, k: Constants) -> Dict[str, float]:
    """``state`` the program's physical fields, ``out`` the reference's
    normalized fields."""
    (prog_u, prog_s), (ref_u, ref_s) = state, out
    du = (prog_u - k.upper_mean) / k.upper_std - ref_u
    ds = (prog_s - k.surface_mean) / k.surface_std - ref_s
    num = du.double().square().sum() + ds.double().square().sum()
    den = ref_u.double().square().sum() + ref_s.double().square().sum()
    return {"rel_rms": math.sqrt(float(num / den)),
            "max_abs": max(float(du.abs().max()), float(ds.abs().max()))}


def reference_steps(config: dict, k: Constants, steps: List[tuple], seed: int, device,
                    precision: str = "f32") -> dict:
    """The reference's losses, first gradient norms (decay added, as Adam
    takes it) and change norms over ``steps`` (one pair each): from the
    seed's weights, each step's drop paths drawn as the program draws them."""
    m, tr = config["model"], config["train"]
    params = weights(config, seed, device)
    for p in params.values():
        p.requires_grad_(True)
    adam = reference.Adam(params, tr["lr"], tr["weight_decay"])
    gen = inputs.generator(seed, "drop_path", device)
    losses, grad = [], None
    for u, s, tu, ts in steps:
        scales = reference.drop_path_scales(m, u.shape[0], gen, device)
        ou, os_ = reference.forward(params, m, u, s, k, precision, scales, remat=m["remat"])
        loss = reference.loss(ou, os_, tu, ts, k)
        g = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        del ou, os_, loss
        taken = adam.step(dict(zip(params, g)))
        if grad is None:
            grad = compare.leaf_norms(taken)
        del g, taken
    start = weights(config, seed, device)
    update = {n: float((params[n].detach() - start[n]).double().norm()) for n in params}
    return {"losses": losses, "grad": grad, "update": update}


# ---- the work -------------------------------------------------------------------------


def forward_matmul_flops(config: dict, batch: int = 1) -> float:
    """A copy of the program's analytic count (``utils/flops.py``): 2 FLOP
    per multiply-add of every product of the forward pass, blocks counted on
    the window-padded grid, elementwise work not counted."""
    m = config["model"]
    g = grid(m)
    c0, pz, ph, pw = m["dims"][0], *m["patch"]
    surf_tokens, upper_tokens = g.h * g.w, g.zu * g.h * g.w
    embed_u = (m["upper_vars"] + m["upper_const_channels"]) * pz * ph * pw
    embed_s = (m["surface_vars"] + m["surface_const_channels"]) * ph * pw
    total = 2.0 * (surf_tokens * embed_s * c0 + upper_tokens * embed_u * c0)
    for i, (depth, c) in enumerate(zip(m["depths"], m["dims"])):
        st = stage_of(m, i)
        tokens = st.z * st.hp * st.w
        windows = st.n_types * (st.w // st.window[2])
        attn = 2.0 * tokens * c * 3 * c + 2 * (2.0 * windows * st.tokens ** 2 * c) \
            + 2.0 * tokens * c * c
        mlp = 2.0 * (2.0 * tokens * c * m["mlp_ratio"] * c)
        total += depth * (attn + mlp)
    half = g.outer.z * g.h2 * (g.w // 2)
    total += 2.0 * half * 4 * m["dims"][0] * m["dims"][1]
    total += 2.0 * (half * m["dims"][2] * 4 * m["dims"][3]
                    + g.outer.z * g.h * g.w * m["dims"][3] ** 2)
    cin = m["dims"][0] + m["dims"][3]
    total += 2.0 * (upper_tokens * cin * m["upper_vars"] * pz * ph * pw
                    + surf_tokens * cin * m["surface_vars"] * ph * pw)
    return batch * total


def train_matmul_flops(config: dict, batch: int = 1) -> float:
    """3 forwards: each product has two backward products of its shape; a
    recompute under remat is not counted."""
    return 3.0 * forward_matmul_flops(config, batch)


def blocks(config: dict) -> List[Tuple[Stage, int, int, bool]]:
    """(stage, C, heads, shifted) of every block of the model, in order."""
    m = config["model"]
    return [(stage_of(m, i), c, heads, bool(j % 2))
            for i, (depth, c, heads) in enumerate(zip(m["depths"], m["dims"], m["heads"]))
            for j in range(depth)]
