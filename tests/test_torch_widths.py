"""Where the model meets the card, the widths are checked before any launch
(CPU): ``check_kernel_widths`` takes the flagship widths and refuses, with
the widths in its message, a model that routes bf16 blocks to the CUDA
kernels at widths they do not take (``pangu_tiny``: C 16/32, head dim 8).
On the CPU the wrappers run their plain versions at any width, so the same
tiny model still runs its forecast step and a train step there."""

import dataclasses

import numpy as np
import pytest
import torch

from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.config import pangu_pretrain, pangu_tiny
from pangu_tpu_torch.interop.from_jax import init_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.model.pangu import check_kernel_widths
from pangu_tpu_torch.rollout import make_forecast_step
from pangu_tpu_torch.train import Batch, make_optimizer, make_train_step

KERNEL_ROUTE = dict(compute_dtype="bfloat16", use_pallas_attention=True)


@pytest.mark.parametrize("kw", [KERNEL_ROUTE, dict(compute_dtype="bfloat16"), {}])
def test_flagship_widths_pass(kw):
    check_kernel_widths(pangu_pretrain(24, **kw).model)


@pytest.mark.parametrize("change,words", [
    ({}, ["(16, 32, 32, 16)", "(8, 8, 8, 8)"]),
    (dict(dims=(192, 384, 384, 192), heads=(6, 12, 12, 6), window=(2, 6, 6)), ["72 tokens"]),
    (dict(dims=(192, 384, 384, 192), heads=(6, 12, 12, 6), mlp_ratio=2), ["MLP ratio 2"]),
])
def test_tiny_widths_on_the_kernel_route_raise_with_the_widths(change, words):
    m = dataclasses.replace(pangu_tiny(**KERNEL_ROUTE).model, **change)
    with pytest.raises(ValueError) as e:
        check_kernel_widths(m)
    for w in words + ["use_pallas_attention=False"]:
        assert w in str(e.value), w
    check_kernel_widths(dataclasses.replace(m, use_pallas_attention=False))  # plain route
    check_kernel_widths(dataclasses.replace(m, compute_dtype="float32"))


def test_tiny_kernel_route_still_runs_forward_and_backward_on_the_cpu():
    cfg = pangu_tiny(drop_path_max=0.2, remat=True, **KERNEL_ROUTE)
    m = cfg.model
    aux = synthetic_aux_constants(m, cfg.train, device="cpu")
    model = PanguModel(m)
    init_params(model, seed=0)
    rng = np.random.default_rng(3)
    upper = torch.from_numpy(rng.standard_normal(
        (1, m.upper_vars, m.levels, m.lat, m.lon)).astype(np.float32))
    surface = torch.from_numpy(rng.standard_normal(
        (1, m.surface_vars, m.lat, m.lon)).astype(np.float32))
    ou, os_ = make_forecast_step(model, aux)(upper, surface)
    assert ou.shape == upper.shape and os_.shape == surface.shape
    assert bool(torch.isfinite(ou).all()) and bool(torch.isfinite(os_).all())
    step = make_train_step(model, cfg, make_optimizer(model, cfg))
    loss = step(Batch(upper, surface, ou, os_), aux, torch.Generator().manual_seed(1))
    assert bool(torch.isfinite(loss))
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())
