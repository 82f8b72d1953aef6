"""The port's Trainer, checkpoints and summary against the JAX package's
(CPU, tiny geometry, f32 plain path).

* ``Trainer.fit`` (drop path 0) beside the JAX ``Trainer`` from one JAX
  init on the same synthetic loaders: 3 epochs asked, the LR milestone 1
  with gamma 0, ``early_stop`` 1, so epoch 2 trains at LR 0, its
  validation loss does not improve and early stopping fires there. Epoch
  losses and validation losses within 1e-4 relative (the golden guard's f32
  bound, tests/test_golden_guard.py:67); the best epoch and the epochs run
  the same. (The parameters are not compared after several Adam updates:
  where a gradient is near 0, g / sqrt(v) turns last-bit differences into
  differences of the order of the LR; tests/test_torch_train.py compares
  one update);
* ``fit(2)`` against ``fit(1)`` + ``resume`` + epoch 2, bit for bit, with
  drop path and dropout on;
* the checkpoint layout and ``latest_epoch``, the best params read back,
  ``cli.load_model_and_params`` on ``best/`` and ``train_<n>/`` (and its
  refusal of any other directory, naming the ``.npz`` route), the loss
  brake, ``set_epoch`` driven with the running epoch, the val-time PNGs
  with the forecast step built once, and the profiler's trace;
* ``param_count`` equal to the JAX package's count, and the
  ``finetune`` script end to end on the synthetic store.
"""

import argparse
import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

import jax

from pangu_tpu.aux import synthetic_aux_constants as jax_aux
from pangu_tpu.config import DataConfig as JaxDataConfig
from pangu_tpu.config import pangu_tiny as jax_tiny
from pangu_tpu.data import make_loader as jax_make_loader
from pangu_tpu.model import PanguModel as JaxPanguModel
from pangu_tpu.train.trainer import Trainer as JaxTrainer
from pangu_tpu.train.trainer import init_train_state as jax_init_train_state
from pangu_tpu.utils.summary import param_count as jax_param_count
from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.cli import load_model_and_params
from pangu_tpu_torch.config import DataConfig, pangu_tiny
from pangu_tpu_torch.data import make_loader
from pangu_tpu_torch.interop.from_jax import init_params, load_jax_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.scripts import finetune
from pangu_tpu_torch.train import checkpoint as ckpt
from pangu_tpu_torch.train.trainer import Trainer, epoch_generator, init_train_state
from pangu_tpu_torch.utils.summary import param_count, summarize_params

RTOL = 1e-4
DATES = dict(train_start="20180101", train_end="20180104", train_freq="24h",
             val_start="20180105", val_end="20180107", val_freq="24h",
             test_start="20180108", test_end="20180110", test_freq="24h", prefetch=0)
TRAIN = dict(epochs=3, batch_size=1, lr=1e-3, lr_milestones=(1,), lr_gamma=0.0, early_stop=1)


class Record:
    """A writer and a logger in one: the scalars per epoch and the messages."""

    def __init__(self):
        self.scalars, self.messages = {}, []
        self.logger = logging.getLogger(f"record.{id(self)}")
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        self.logger.addHandler(self)
        self.level = logging.INFO

    # logging.Handler's interface
    def handle(self, record):
        self.messages.append(record.getMessage())

    def add_scalars(self, tag, values, epoch):
        self.scalars[epoch] = dict(values)

    def best_epochs(self):
        return [int(m.split(" at ")[1].split()[0]) for m in self.messages
                if m.startswith("current best model is saved")]

    def early_stopped(self):
        return any(m.startswith("No improvement") for m in self.messages)


def _configs(**model_kw):
    jcfg = jax_tiny(drop_path_max=0.0)
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, **TRAIN),
                        data=JaxDataConfig(**DATES))
    tcfg = pangu_tiny(drop_path_max=0.0, **model_kw)
    tcfg = tcfg.replace(train=dataclasses.replace(tcfg.train, **TRAIN), data=DataConfig(**DATES))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    jcfg, tcfg = _configs()
    m = jcfg.model
    aux = jax_aux(m, jcfg.train)
    jmodel = JaxPanguModel(m)
    rng = np.random.default_rng(0)
    upper = rng.standard_normal((1, m.upper_vars, m.levels, m.lat, m.lon)).astype(np.float32)
    surface = rng.standard_normal((1, m.surface_vars, m.lat, m.lon)).astype(np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), upper, surface, aux)
    tree = jax.tree_util.tree_map(np.asarray, params)  # the train step donates params
    n_params = jax_param_count(params)
    train = jax_make_loader(jcfg.data, m, "train", jcfg.horizon, 1)
    val = jax_make_loader(jcfg.data, m, "val", jcfg.horizon, 1)
    rec = Record()
    trainer = JaxTrainer(jcfg, jmodel, aux, str(tmp_path_factory.mktemp("jax")), writer=rec,
                         logger=rec.logger, steps_per_epoch=len(train))
    state = jax_init_train_state(jmodel, jcfg, aux, trainer.optimizer, params=params)
    _, state = trainer.fit(train, val, state=state)
    return dict(jcfg=jcfg, tcfg=tcfg, params=tree, rec=rec, n_params=n_params,
                steps=int(state.step), steps_per_epoch=len(train))


def _port_fit(tcfg, params, out, **fit_kw):
    model = PanguModel(tcfg.model)
    load_jax_params(model, tcfg.model, params)
    aux = synthetic_aux_constants(tcfg.model, tcfg.train, device="cpu")
    train = make_loader(tcfg.data, tcfg.model, "train", tcfg.horizon, 1)
    val = make_loader(tcfg.data, tcfg.model, "val", tcfg.horizon, 1)
    rec = Record()
    trainer = Trainer(tcfg, model, aux, str(out), writer=rec, logger=rec.logger,
                      steps_per_epoch=len(train))
    best, state = trainer.fit(train, val, **fit_kw)
    return rec, model, best, state


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def test_fit_matches_the_jax_trainer(jax_run, tmp_path):
    """Epoch and validation losses, the best epoch and the epoch where early
    stopping fires."""
    rec, model, best, state = _port_fit(jax_run["tcfg"], jax_run["params"], tmp_path)
    ref = jax_run["rec"]
    assert sorted(rec.scalars) == sorted(ref.scalars) == [1, 2]
    for epoch, want in ref.scalars.items():
        for k in ("train", "val"):
            assert _rel(rec.scalars[epoch][k], want[k]) < RTOL, (epoch, k)
    assert rec.best_epochs() == ref.best_epochs() == [1]
    assert rec.early_stopped() and ref.early_stopped()
    assert state.step == jax_run["steps"] == 2 * jax_run["steps_per_epoch"]
    # the best params are epoch 1's, read back from best/
    disk = ckpt.restore_params(os.path.join(tmp_path, "models"), state.params, "best")
    assert all(torch.equal(best[k], disk[k]) for k in best)
    first = torch.load(os.path.join(tmp_path, "models", "train_1", ckpt.STATE_FILE),
                       weights_only=True)
    assert all(torch.equal(best[k], first["model"][k]) for k in best)
    assert ckpt.latest_epoch(os.path.join(tmp_path, "models")) == 2


def test_param_count_matches_jax(jax_run):
    model = PanguModel(jax_run["tcfg"].model)
    assert param_count(model) == param_count(model.state_dict()) == jax_run["n_params"]
    text = summarize_params(model, max_depth=1)
    assert text.splitlines()[0] == f"total parameters: {jax_run['n_params']:,}"
    assert "  EarthSpecificLayer0:" in text


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_resume_gives_the_bits_of_an_uninterrupted_run(jax_run, tmp_path, dropout):
    """fit(2) == fit(1) + resume(train_1) + epoch 2, to the bit, drop path
    0.2 (and dropout 0.1): the masks are a function of (seed, epoch, step)."""
    _, tcfg = _configs(dropout_rate=dropout)
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, drop_path_max=0.2),
                        train=dataclasses.replace(tcfg.train, epochs=2, lr_milestones=(),
                                                  early_stop=20))
    rec_a, model_a, _, _ = _port_fit(tcfg, jax_run["params"], tmp_path / "a")

    one = tcfg.replace(train=dataclasses.replace(tcfg.train, epochs=1))
    _port_fit(one, jax_run["params"], tmp_path / "b")
    model = PanguModel(tcfg.model)
    init_params(model, 5)  # other weights: the resume must overwrite them
    aux = synthetic_aux_constants(tcfg.model, tcfg.train, device="cpu")
    train = make_loader(tcfg.data, tcfg.model, "train", tcfg.horizon, 1)
    val = make_loader(tcfg.data, tcfg.model, "val", tcfg.horizon, 1)
    rec = Record()
    trainer = Trainer(tcfg, model, aux, str(tmp_path / "b"), writer=rec, logger=rec.logger,
                      steps_per_epoch=len(train))
    state, start = trainer.resume()
    assert start == 2 and state.step == len(train)
    trainer.fit(train, val, start_epoch=start, state=state)
    assert rec.scalars[2] == rec_a.scalars[2]
    named = dict(model.named_parameters())
    for k, p in model_a.named_parameters():
        assert torch.equal(p, named[k]), k


def test_epoch_generator_is_a_function_of_seed_and_epoch():
    a = torch.rand(4, generator=epoch_generator(99, 3, "cpu"))
    assert torch.equal(a, torch.rand(4, generator=epoch_generator(99, 3, "cpu")))
    assert not torch.equal(a, torch.rand(4, generator=epoch_generator(99, 4, "cpu")))
    assert not torch.equal(a, torch.rand(4, generator=epoch_generator(98, 3, "cpu")))


@pytest.fixture
def small(tmp_path):
    _, tcfg = _configs()
    tcfg = tcfg.replace(train=dataclasses.replace(tcfg.train, epochs=1, lr_milestones=()))
    model = PanguModel(tcfg.model)
    init_params(model, 0)
    aux = synthetic_aux_constants(tcfg.model, tcfg.train, device="cpu")
    return tcfg, model, aux


def test_cli_loads_the_trainers_checkpoint_directories(small, tmp_path):
    tcfg, model, aux = small
    state = init_train_state(model, tcfg, aux, torch.optim.Adam(model.parameters()))
    d = str(tmp_path / "models")
    ckpt.save_train_state(d, 3, state)
    ckpt.save_params(d, state.params, "best")
    for name in ("train_3", "best"):
        args = argparse.Namespace(weights=os.path.join(d, name))
        got = load_model_and_params(tcfg, args, aux, device="cpu")
        assert all(torch.equal(v, model.state_dict()[k]) for k, v in got.state_dict().items())
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(FileNotFoundError, match=r"\.npz"):
        load_model_and_params(tcfg, argparse.Namespace(weights=str(orbax)), aux, device="cpu")


def test_restore_train_state_restores_params_and_adam(small, tmp_path):
    tcfg, model, aux = small
    trainer = Trainer(tcfg, model, aux, str(tmp_path))
    train = make_loader(tcfg.data, tcfg.model, "train", tcfg.horizon, 1)
    _, state = trainer.fit(train)
    saved = {k: v.clone() for k, v in state.params.items()}
    moments = {k: trainer.optimizer.state[p]["exp_avg"].clone() for k, p in state.params.items()}
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    restored, epoch = trainer.resume()
    assert epoch == 2 and restored.step == len(train)
    for k, p in restored.params.items():
        assert torch.equal(p, saved[k]), k
        assert torch.equal(trainer.optimizer.state[p]["exp_avg"], moments[k]), k


def test_non_finite_losses_stop_training(small, tmp_path):
    tcfg, model, aux = small
    train = make_loader(tcfg.data, tcfg.model, "train", tcfg.horizon, 1)
    batches = [(type(b)(b.upper * np.nan, *b[1:]), p) for b, p in train] * 2
    with pytest.raises(FloatingPointError, match="diverged"):
        Trainer(tcfg, model, aux, str(tmp_path)).fit(batches)


def test_fit_drives_set_epoch_with_the_running_epoch(small, tmp_path):
    tcfg, model, aux = small
    batch = next(iter(make_loader(tcfg.data, tcfg.model, "train", tcfg.horizon, 1)))

    class Recording(list):
        epochs = []

        def set_epoch(self, epoch):
            self.epochs.append(epoch)

    rec = Recording([batch])
    cfg6 = tcfg.replace(train=dataclasses.replace(tcfg.train, epochs=6, save_interval=10))
    Trainer(cfg6, model, aux, str(tmp_path)).fit(rec, start_epoch=5)
    assert rec.epochs == [5, 6]


def test_visualize_builds_the_forecast_once_and_writes_pngs(small, tmp_path, monkeypatch):
    from pangu_tpu_torch.rollout import autoregressive

    tcfg, model, aux = small
    tcfg = tcfg.replace(train=dataclasses.replace(tcfg.train, epochs=2))
    built = []
    real = autoregressive.make_forecast_step
    monkeypatch.setattr(autoregressive, "make_forecast_step",
                        lambda *a: built.append(1) or real(*a))
    train = make_loader(tcfg.data, tcfg.model, "train", tcfg.horizon, 1)
    val = make_loader(tcfg.data, tcfg.model, "val", tcfg.horizon, 1)
    trainer = Trainer(tcfg, model, aux, str(tmp_path), steps_per_epoch=len(train),
                      visualize=True, profile_dir=str(tmp_path / "prof"))
    trainer.fit(train, val)
    assert built == [1]
    png = tmp_path / "png_training"
    lvl = min(12, tcfg.model.levels - 1)
    for epoch in (1, 2):
        for name in (f"u_{lvl}_{epoch}.png", f"msl_{epoch}.png"):
            assert (png / name).stat().st_size > 0
    assert os.listdir(tmp_path / "prof") == ["epoch_1.trace.json"]


def test_finetune_script_runs_end_to_end_on_the_cpu(tmp_path):
    argv = ["--preset", "tiny", "--out", str(tmp_path), "--set", "data.store=synthetic",
            *[f"--set=data.{k}={v}" for k, v in DATES.items()],
            "--set", "train.epochs=2", "--set", "train.batch_size=1"]
    loss = finetune.main(argv, device="cpu")
    out = tmp_path / "finetune_fully" / "24"
    assert np.isfinite(loss)
    assert sorted(os.listdir(out / "models")) == ["best", "train_1", "train_2"]
    assert len(os.listdir(out / "csv")) == 14
    again = finetune.main(argv + ["--resume", "--set", "train.epochs=3"], device="cpu")
    assert np.isfinite(again) and (out / "models" / "train_3").is_dir()
    with pytest.raises(ValueError, match="one process per card"):
        finetune.main(argv + ["--set", "parallel.lat=2"], device="cpu")
    with pytest.raises(ValueError, match="one process per card"):
        finetune.main(argv + ["--set", "parallel.pipe=2"], device="cpu")


def test_finetune_scripts_run_without_pandas_or_matplotlib(tmp_path):
    """The card's machine has no matplotlib: ``finetune`` and ``lora_tune``
    (no --visualize) import neither pandas nor matplotlib, nor anything of
    jax or the JAX package."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = ["--preset", "tiny", "--out", str(tmp_path), "--set", "data.store=synthetic",
            *[f"--set=data.{k}={v}" for k, v in DATES.items()], "--set", "train.epochs=1",
            "--set", "train.batch_size=1"]
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import math\n"
        "from pangu_tpu_torch.scripts import finetune, lora_tune\n"
        f"assert math.isfinite(finetune.main({argv!r}, device='cpu'))\n"
        f"assert math.isfinite(lora_tune.main({argv!r} + ['--unmerged'], device='cpu'))\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None\n"
        "             and m.split('.')[0] in ('pandas', 'matplotlib', 'jax', 'pangu_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, check=True, timeout=300)
    assert (tmp_path / "lora" / "24" / "lora_best.npz").is_file()
