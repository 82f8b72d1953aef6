"""The benchmark's plain reference against the program's plain route at a
tiny geometry on the CPU: the forward pass, the loss and one Adam step.
Both sides get the benchmark's seeded weights, constants and inputs."""

import pytest
import torch

from benchmark import inputs
from benchmark.arch import pangu
from benchmark.reference import pangu as reference
from benchmark.tests import tiny

CPU = torch.device("cpu")


def _f32_cell(name):
    return tiny.cell(name, compute_dtype="float32", use_pallas_attention=False)


def test_param_shapes_are_the_programs_state_dict():
    c = _f32_cell("forecast_b1")
    _, model = pangu.build_model(c, 3, CPU)
    shapes = reference.param_shapes(c.config["model"])
    assert sorted(shapes) == sorted(model.state_dict())
    assert all(tuple(model.state_dict()[n].shape) == s for n, s in shapes.items())


@pytest.mark.parametrize("batch", [1, 2])
def test_forward_matches_the_plain_route(batch):
    c = _f32_cell("forecast_b1")
    _, model = pangu.build_model(c, 3, CPU)
    k = pangu.constants(c.config, 3, CPU)
    (state,) = pangu.states(c.config, k, 3, CPU, 1, batch)
    out = pangu.forecast_step(model, pangu.aux_constants(k))(*state)
    with torch.no_grad():
        ref = pangu.reference_step(pangu.weights(c.config, 3, CPU), c.config, state, k)
    gaps = pangu.forecast_gaps(out, ref, k)
    assert gaps["rel_rms"] < 1e-5 and gaps["max_abs"] < 1e-4, gaps


def test_loss_and_adam_step_match_the_plain_route():
    c = _f32_cell("finetune_b1")
    cfg, model = pangu.build_model(c, 5, CPU)
    k = pangu.constants(c.config, 5, CPU)
    sample = pangu.pairs(c.config, k, 5, CPU, c.traffic)[0]
    step, optimizer = pangu.train_step(model, cfg, 1826)
    loss = float(step(pangu.batch(*sample), pangu.aux_constants(k),
                      inputs.generator(5, "drop_path", CPU)))
    ref = pangu.reference_steps(c.config, k, [sample], 5, CPU)
    assert abs(loss - ref["losses"][0]) <= 1e-6 * abs(ref["losses"][0])
    start = pangu.weights(c.config, 5, CPU)
    updated = reference_params_after_one_step(c, k, sample)
    for n, p in model.named_parameters():
        moved = (updated[n] - start[n]).norm()
        assert (p.detach() - updated[n]).norm() <= 1e-4 * moved + 1e-12, n


def reference_params_after_one_step(c, k, sample):
    m, tr = c.config["model"], c.config["train"]
    params = pangu.weights(c.config, 5, CPU)
    for p in params.values():
        p.requires_grad_(True)
    scales = reference.drop_path_scales(m, 1, inputs.generator(5, "drop_path", CPU), CPU)
    out = reference.forward(params, m, sample[0], sample[1], k, scales=scales, remat=True)
    loss = reference.loss(*out, sample[2], sample[3], k)
    grads = torch.autograd.grad(loss, list(params.values()))
    reference.Adam(params, tr["lr"], tr["weight_decay"]).step(dict(zip(params, grads)))
    return {n: p.detach() for n, p in params.items()}


def test_drop_path_draws_follow_the_program():
    """Rates ramp from 0 to 0.2 over the 16 blocks; rate-0 blocks draw nothing."""
    m = tiny.cell("finetune_b1").config["model"]
    rates = reference.drop_path_rates(m)
    assert rates[0][0] == 0.0 and rates[-1][-1] == m["drop_path_max"]
    from pangu_tpu_torch.config import ModelConfig
    from pangu_tpu_torch.model.pangu import drop_path_rates

    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in m.items()})
    assert [list(r) for r in drop_path_rates(cfg)] == rates


@pytest.mark.parametrize("precision", ["tf32", "fp8"])
def test_quantize_rounds_to_the_stated_precision(precision):
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    q = reference.quantize(x, precision)
    rel = ((q - x).abs() / x.abs().clamp_min(1e-3)).median()
    assert (2 ** -13 if precision == "tf32" else 2 ** -6) < rel < (2 ** -10 if precision == "tf32"
                                                                     else 2 ** -2)
    assert torch.equal(reference.quantize(q, precision), q)
