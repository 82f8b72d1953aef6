"""The comparison that decides ``correct``, at a tiny geometry on the CPU:
sound runs pass it, the control (the reference at the precision below the
configuration's) fails it, and so does a run whose timed path is broken
underneath, once for each fault a cell of one card can have."""

import pytest
import torch

from benchmark import control
from benchmark.arch import pangu
from benchmark.tests import tiny

CPU = torch.device("cpu")
CELLS = ["forecast_b1", "forecast_f32_b1", "finetune_b1"]


def _sound(name):
    """The cell at the tiny geometry; a train cell in f32 there, where bf16's
    gaps in the change of the parameters come near the flagship's limits
    (more of a tiny model's leaves are near Adam's round-off)."""
    if name.startswith("finetune"):
        return tiny.cell(name, compute_dtype="float32", use_pallas_attention=False)
    return tiny.cell(name)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    rec = tiny.run(_sound(name), seed=11)
    assert rec.compared >= 1 and rec.correct, rec.checks


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    c = tiny.cell(name)
    precision = "tf32" if c.config["model"]["compute_dtype"] == "float32" else "fp8"
    for seed in (1, 2, 3):
        (rec,) = control.verdicts(c, seed, CPU, precision).values()
        assert rec.compared >= 1 and not rec.correct, (seed, rec.checks)


def _unchanged_forecast(model, aux):
    return lambda u, s: (u.clone(), s.clone())


def _altered_forecast(model, aux):
    real = pangu.__dict__["_real_forecast_step"](model, aux)

    def step(u, s):
        u, s = real(u, s)
        s = s.clone()
        s[:, 0] += 0.25 * aux.surface_std[0, 0]
        return u, s

    return step


@pytest.mark.parametrize("name", ["forecast_b1", "forecast_f32_b1"])
@pytest.mark.parametrize("fault", [_unchanged_forecast, _altered_forecast])
def test_a_broken_forecast_is_not_correct(monkeypatch, name, fault):
    monkeypatch.setitem(pangu.__dict__, "_real_forecast_step", pangu.forecast_step)
    monkeypatch.setattr(pangu, "forecast_step", fault)
    rec = tiny.run(tiny.cell(name), seed=11)
    assert rec.compared >= 1 and not rec.correct, rec.checks


def _unchanged_train(model, cfg, steps_per_epoch):
    step, optimizer = pangu.__dict__["_real_train_step"](model, cfg, steps_per_epoch)

    def frozen(batch, aux, generator=None):
        before = [p.detach().clone() for p in model.parameters()]
        loss = step(batch, aux, generator)
        with torch.no_grad():
            for p, b in zip(model.parameters(), before):
                p.copy_(b)
        return loss

    return frozen, optimizer


def _altered_train(model, cfg, steps_per_epoch):
    """One parameter moved double by each update."""
    step, optimizer = pangu.__dict__["_real_train_step"](model, cfg, steps_per_epoch)
    leaf = next(model.parameters())

    def doubled(batch, aux, generator=None):
        before = leaf.detach().clone()
        loss = step(batch, aux, generator)
        with torch.no_grad():
            leaf.add_(leaf - before)
        return loss

    return doubled, optimizer


@pytest.mark.parametrize("fault", [_unchanged_train, _altered_train])
def test_a_broken_train_step_is_not_correct(monkeypatch, fault):
    monkeypatch.setitem(pangu.__dict__, "_real_train_step", pangu.train_step)
    monkeypatch.setattr(pangu, "train_step", fault)
    rec = tiny.run(_sound("finetune_b1"), seed=11)
    assert rec.compared == 1 and not rec.correct, rec.checks
