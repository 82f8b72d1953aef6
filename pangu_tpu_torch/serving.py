"""Serving artifacts (port of ``pangu_tpu/serving.py``; role of the
reference's onnxruntime inference engine).

The reference serves forecasts through ONNX graphs run by onnxruntime. The
port's artifact is a ``torch.export`` program of the forecast step (the
model forward, then ``norm_back_data``) with the weights and the aux
constants inside, saved with ``torch.export.save``: any process loads it and
runs it with no model code. The block kernel K1 is the operator
``pangu_tpu_torch::fused_earth_block`` and a bf16 Dense product on the card
the operator ``pangu_tpu_torch::dense``, so a kernel-route artifact calls the
hand-written kernels on the card (K1's plain version on the CPU), the same
launches in the same order as the eager step.

    # build once
    export_forecast_step(model, aux, "pangu24.pt2")

    # serve in any process (imports no model code)
    step = load_forecast_step("pangu24.pt2")
    upper_t1, surface_t1 = step(upper_t0, surface_t0)

An artifact holds its weights on the one device it was exported for and is
tied to the torch version that wrote it: export and load with the same
torch, on the same kind of device.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from pangu_tpu_torch.aux import AuxConstants, norm_back_data
from pangu_tpu_torch.ops import fused_block_attention as _fba

Fields = Tuple[torch.Tensor, torch.Tensor]

#: the devices an artifact can hold its weights on (``platforms``)
PLATFORMS = ("cuda", "cpu")
#: the names of the block kernel's operator and of the Dense product's in a graph
#: (importing them registers them)
K1_OP = _fba.FUSED_EARTH_BLOCK_OP.name()
DENSE_OP = _fba.DENSE_OP.name()


class ServingStep(nn.Module):
    """``(upper, surface) -> (upper', surface')`` in physical units: the
    model forward, then ``norm_back_data``. The aux constants are buffers, so
    ``torch.export`` keeps them in the artifact beside the weights."""

    def __init__(self, model: nn.Module, aux: AuxConstants):
        super().__init__()
        self.model = model
        self.aux_scalars = {}
        for field in dataclasses.fields(AuxConstants):
            value = getattr(aux, field.name)
            if isinstance(value, torch.Tensor) or value is None:
                self.register_buffer(field.name, value)
            else:
                self.aux_scalars[field.name] = value

    def aux(self) -> AuxConstants:
        return AuxConstants(**{f.name: (self.aux_scalars[f.name] if f.name in self.aux_scalars
                                        else getattr(self, f.name))
                               for f in dataclasses.fields(AuxConstants)})

    def forward(self, upper: torch.Tensor, surface: torch.Tensor) -> Fields:
        aux = self.aux()
        ou, os_ = self.model(upper, surface, aux)
        return norm_back_data(ou, os_, aux)


def make_serving_fn(model: nn.Module, aux: AuxConstants) -> ServingStep:
    """The forecast step as a module, in eval mode (the JAX package's
    ``deterministic=True``), holding ``model`` and ``aux``."""
    return ServingStep(model, aux).eval()


def export_device(model: nn.Module, platforms: Optional[Sequence[str]]) -> torch.device:
    """The one device the artifact holds its weights on: ``platforms``' one
    entry, else the model's device."""
    if not platforms:
        return next(model.parameters()).device
    if len(platforms) != 1:
        raise ValueError(
            f"platforms={list(platforms)}: a torch.export artifact holds its weights on one "
            f"device, so it serves one platform; export one artifact for each of {PLATFORMS}")
    if platforms[0] not in PLATFORMS:
        raise ValueError(f"platform {platforms[0]!r} is not one of {PLATFORMS}")
    return torch.device(platforms[0])


def export_forecast_step(
    model: nn.Module,
    aux: AuxConstants,
    path: str,
    batch: int = 1,
    platforms: Optional[Sequence[str]] = None,
) -> torch.export.ExportedProgram:
    """Export the forecast step at ``batch`` (static f32 inputs at the
    model's geometry) with ``torch.export`` under ``torch.no_grad`` -- the
    blocks' kernel route is chosen with autograd off -- and save it to
    ``path`` with the weights and aux constants inside. ``platforms`` names
    the one device the artifact holds its weights on (``cuda`` or ``cpu``;
    default: the model's). Returns the exported program."""
    device = export_device(model, platforms)
    serving = make_serving_fn(model, aux)
    if next(model.parameters()).device != device:
        serving = copy.deepcopy(serving).to(device)
    m = model.cfg
    upper = torch.zeros((batch, m.upper_vars, m.levels, m.lat, m.lon), device=device)
    surface = torch.zeros((batch, m.surface_vars, m.lat, m.lon), device=device)
    with torch.no_grad():
        program = torch.export.export(serving, (upper, surface), strict=False)
    program.example_inputs = None  # zero fields, not worth their bytes in the artifact
    torch.export.save(program, path)
    return program


class LoadedStep:
    """A loaded forecast step: ``step(upper, surface) -> (upper', surface')``
    under ``torch.inference_mode``; ``program`` is the exported program."""

    def __init__(self, program: torch.export.ExportedProgram):
        self.program = program
        self.module = program.module()

    def __call__(self, upper: torch.Tensor, surface: torch.Tensor) -> Fields:
        with torch.inference_mode():
            return tuple(self.module(upper, surface))


def load_forecast_step(path: str) -> LoadedStep:
    """Load an exported forecast step (:class:`LoadedStep`); needs no model
    code, only the kernel operator this module registers on import."""
    return LoadedStep(torch.export.load(path))


def graph_ops(program: torch.export.ExportedProgram) -> collections.Counter:
    """Calls of each operator (``namespace::name``, or a function's name)
    in the program's graph and every graph nested in it."""
    counts = collections.Counter()
    for gm in program.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            if node.op == "call_function":
                target = node.target
                counts[target.name() if isinstance(target, torch._ops.OpOverload)
                       else getattr(target, "__name__", str(target))] += 1
    return counts
