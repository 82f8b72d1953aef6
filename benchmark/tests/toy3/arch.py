"""A toy architecture that the harness's tests add as files: a state of
three fields (B, split[i], n), stepped by a small residual MLP over their
joined channels (``ToyNet``, plain torch, the program under test here), with
its plain reference in ``reference/toy3.py``. It keeps the contract's
forecast part and no training part."""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark import inputs
from benchmark.reference import toy3 as reference

TINY: dict = {}


class ToyNet(torch.nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        self.split = m["split"]
        self.fc1 = torch.nn.Linear(sum(m["split"]), m["hidden"])
        self.fc2 = torch.nn.Linear(m["hidden"], sum(m["split"]))

    def forward(self, *state):
        x = torch.cat(state, dim=1).transpose(1, 2)
        x = x + self.fc2(torch.tanh(self.fc1(x)))
        return tuple(x.transpose(1, 2).split(self.split, dim=1))


def build_kernels() -> None:
    """Nothing to build."""


def build_model(cell, seed: int, device):
    model = ToyNet(cell.config["model"]).to(device)
    model.load_state_dict(weights(cell.config, seed, device), strict=True)
    return None, model


def aux_constants(k):
    return k


def forecast_step(model, aux):
    @torch.no_grad()
    def step(*state):
        return model(*state)

    return step


def weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = reference.param_shapes(config["model"])
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=inputs.generator(seed, "weights", device),
                       device=device).mul_(0.3)
    return {n: part.view(s) for (n, s), part in zip(shapes.items(), flat.split(sizes))}


def constants(config: dict, seed: int, device):
    """A spread per field."""
    gen = inputs.generator(seed, "constants", device)
    return 0.5 + torch.rand(len(config["model"]["split"]), generator=gen, device=device)


def states(config: dict, k, seed: int, device, count: int, batch: int) -> list:
    m = config["model"]
    gen = inputs.generator(seed, "states", device)
    fields = [torch.randn((count, batch, c, m["n"]), generator=gen, device=device) * k[i]
              for i, c in enumerate(m["split"])]
    return list(zip(*(f.unbind(0) for f in fields)))


def reference_step(params: dict, config: dict, state: tuple, k, precision: str = "f32"):
    return reference.forward(params, config["model"], state, precision)


def to_state(out, k):
    return out


@torch.no_grad()
def forecast_gaps(state, out, k) -> Dict[str, float]:
    d = [(p - r).double() for p, r in zip(state, out)]
    num = sum(float(x.square().sum()) for x in d)
    den = sum(float(r.double().square().sum()) for r in out)
    return {"rel_rms": math.sqrt(num / den), "max_abs": max(float(x.abs().max()) for x in d)}


def forward_matmul_flops(config: dict, batch: int = 1) -> float:
    m = config["model"]
    return 2.0 * 2 * batch * m["n"] * sum(m["split"]) * m["hidden"]
