"""The only module that touches the program under test (``pangu_tpu_torch``),
through its public entry points: ``PanguModel``, ``AuxConstants``,
``make_forecast_step``, ``make_train_step`` and ``make_optimizer``. The
weights and constants it hands over are the benchmark's own.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark import inputs
from benchmark.harness import Cell, program_config
from benchmark.reference.pangu import Constants


def build_model(cell: Cell, seed: int, device):
    """(PanguConfig, the model on ``device`` holding the seed's weights)."""
    from pangu_tpu_torch.model import PanguModel

    cfg = program_config(cell.config)
    with torch.device(device):
        model = PanguModel(cfg.model)
    model.to(device)
    weights: Dict[str, torch.Tensor] = inputs.weights(cell.config["model"], seed, device)
    model.load_state_dict(weights, strict=True)
    del weights
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
