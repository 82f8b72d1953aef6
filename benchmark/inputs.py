"""What the benchmark makes from ``--seed`` and hands to the program and to the
reference alike: the weights, the constants and the pools of fields.

Everything is drawn on the run's device by a ``torch.Generator`` of that
device, in a few large calls, so one seed gives the same tensors to both
sides and to a second run on the same kind of device. Each kind of input has
a stream of its own, so adding one never moves another.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

import torch

from benchmark.reference.pangu import Constants, grid, param_shapes

STREAMS = {"weights": 1, "constants": 2, "states": 3, "drop_path": 4, "sample": 5}
_MIX = 0x9E3779B97F4A7C15


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of ``stream`` for the run's ``seed`` (any whole number)."""
    return (int(seed) * _MIX + STREAMS[stream] * 0xBF58476D1CE4E5B9) % 2**63


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def host_rng(seed: int, stream: str) -> random.Random:
    return random.Random(stream_seed(seed, stream))


def weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter, float32, as views of one buffer drawn in one call:
    0.02 x a normal cut at 2 (weights, biases, earth biases), plus 1 on the
    LayerNorm scales."""
    shapes = param_shapes(m)
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator(seed, "weights", device), device=device)
    flat.clamp_(-2.0, 2.0).mul_(0.02)
    out = {}
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):
        t = part.view(shape)
        if ".norm" in name and name.endswith(".weight"):
            t.add_(1.0)
        out[name] = t
    return out


def constants(m: dict, train: dict, seed: int, device) -> Constants:
    """Normalization statistics around 0 with spreads in [1.5, 2.5], unit
    normal constant fields, and the configuration's loss weights."""
    g, gen = grid(m), generator(seed, "constants", device)
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


def states(m: dict, k: Constants, seed: int, device, count: int,
           batch: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``count`` physical states (upper (B, Vu, L, lat, lon), surface (B, Vs,
    lat, lon)): mean + std x a unit normal, drawn in one call each."""
    gen = generator(seed, "states", device)
    vu, vs, L, lat, lon = m["upper_vars"], m["surface_vars"], m["levels"], m["lat"], m["lon"]
    up = torch.randn((count, batch, vu, L, lat, lon), generator=gen, device=device)
    sf = torch.randn((count, batch, vs, lat, lon), generator=gen, device=device)
    up.mul_(k.upper_std).add_(k.upper_mean)
    sf.mul_(k.surface_std).add_(k.surface_mean)
    return list(zip(up.unbind(0), sf.unbind(0)))
