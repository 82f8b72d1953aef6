"""The port's scores, score tables and evaluation against the JAX package's.

* metrics: every function of ``pangu_tpu_torch.metrics`` against
  ``pangu_tpu.metrics`` on the same seeded inputs, rtol 1e-5 (both f32; only
  the order of the sums differs), and ``top_quantiles_error`` on an input
  above 2^24 elements, where ``torch.quantile`` refuses to run;
* CSV tables: the port's files (standard ``csv`` module) hold the bytes the
  JAX package's pandas writer writes, and parse back to the same index,
  columns and values with either reader;
* ``evaluate`` and the ``test`` script, both on a ``.npz`` the JAX package
  wrote: the same CSV tree, RMSE at rtol 1e-4 and ACC at atol 1e-4 (the
  golden guard's f32 bound, tests/test_golden_guard.py:67); the empty test
  window's loud NaN.

Tiny geometry, the f32 plain path, everything on the CPU.
"""

import dataclasses
import importlib.util
import logging
import os
import sys

import numpy as np
import pytest
import torch

import jax

from pangu_tpu import metrics as jm
from pangu_tpu.aux import synthetic_aux_constants as jax_aux
from pangu_tpu.config import DataConfig as JaxDataConfig
from pangu_tpu.config import pangu_tiny as jax_tiny
from pangu_tpu.data import make_loader as jax_make_loader
from pangu_tpu.eval import evaluate as jax_evaluate
from pangu_tpu.eval import csv_io as jcsv
from pangu_tpu.interop.npz_io import save_params_npz as jax_save_npz
from pangu_tpu.model import PanguModel as JaxPanguModel
from pangu_tpu_torch import metrics as tm
from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.config import DataConfig, pangu_tiny
from pangu_tpu_torch.data import make_loader
from pangu_tpu_torch.eval import csv_io as tcsv
from pangu_tpu_torch.eval import evaluate
from pangu_tpu_torch.eval.evaluate import make_score_step
from pangu_tpu_torch.cli import load_model_and_params
from pangu_tpu_torch.scripts import test as port_test_script
from pangu_tpu_torch.train.step import Batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATES = dict(test_start="20180101", test_end="20180105", test_freq="24h", prefetch=0)
RMSE_RTOL, ACC_ATOL = 1e-4, 1e-4


def assert_same_csv_tree(port_dir: str, jax_dir: str) -> int:
    """The same relative CSV paths under both directories; in each file the
    same index and columns, rmse_* values at rtol 1e-4, acc_* at atol 1e-4.
    Returns the number of files compared."""
    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, files in os.walk(root) for f in files if f.endswith(".csv"))

    files = tree(port_dir)
    assert files and files == tree(jax_dir)
    for rel in files:
        error, family = os.path.basename(rel)[:-4].split("_", 1)
        sub = os.path.dirname(rel)
        idx, cols, got = tcsv.load_error_scores(os.path.join(port_dir, sub), error, family)
        ref = jcsv.load_error_scores(os.path.join(jax_dir, sub), error, family)
        assert idx == [str(i) for i in ref.index], rel
        assert cols == list(ref.columns), rel
        assert np.isfinite(got).all(), rel
        if error == "rmse":
            np.testing.assert_allclose(got, ref.values, rtol=RMSE_RTOL, atol=0, err_msg=rel)
        else:
            np.testing.assert_allclose(got, ref.values, rtol=0, atol=ACC_ATOL, err_msg=rel)
    return len(files)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(0)
    shape = (2, 3, 33, 64)
    pred = rng.standard_normal(shape).astype(np.float32)
    target = (0.7 * pred + 0.5 * rng.standard_normal(shape)).astype(np.float32)
    mask = (rng.random(shape[-2:]) > 0.4).astype(np.float32)
    return pred, target, mask


PAIR_METRICS = ["weighted_rmse_channels", "weighted_acc_channels", "unweighted_acc_channels"]
MASKED_METRICS = ["weighted_rmse_channels_masked", "weighted_acc_masked_channels"]


@pytest.mark.parametrize("name", PAIR_METRICS + MASKED_METRICS + ["wind_speed"])
def test_metric_matches_jax(fields, name):
    pred, target, mask = fields
    extra = (mask,) if name in MASKED_METRICS else ()
    ref = np.asarray(getattr(jm, name)(pred, target, *extra))
    got = getattr(tm, name)(*(torch.from_numpy(a) for a in (pred, target, *extra)))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("num_lat", [33, 721])
def test_latitude_weights_match_jax(num_lat):
    np.testing.assert_allclose(tm.latitude_weights(num_lat).numpy(),
                               np.asarray(jm.latitude_weights(num_lat)), rtol=1e-5, atol=0)


def _check_top_quantiles(pred: np.ndarray, target: np.ndarray) -> None:
    """The result is a mean of differences of quantiles, so its tolerance
    is rtol times the quantiles' scale; the quantiles themselves are held
    to rtol 1e-5 elementwise."""
    ref = np.asarray(jm.top_quantiles_error(pred, target))
    got = tm.top_quantiles_error(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
    assert got.shape == ref.shape == pred.shape[:2]
    n, c = pred.shape[:2]
    flat = pred.reshape(n, c, -1)
    q = np.asarray(1.0 - jax.numpy.logspace(-3, -0.1, num=100))
    ref_q = np.asarray(jax.numpy.quantile(flat, q, axis=-1))
    got_q = tm._quantiles(torch.from_numpy(flat), torch.from_numpy(q.copy())).numpy()
    np.testing.assert_allclose(got_q, ref_q, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref_q).max())


def test_top_quantiles_error_matches_jax(fields):
    pred, target, _ = fields
    _check_top_quantiles(pred, target)


def test_top_quantiles_error_above_two_to_the_24_elements():
    """One (1, 1, 2049, 8193) field: 16.8M elements, past torch.quantile's
    2^24 limit (a full-geometry call holds 67M)."""
    shape = (1, 1, 2049, 8193)
    assert np.prod(shape) > 2 ** 24
    rng = np.random.default_rng(1)
    target = rng.standard_normal(shape, dtype=np.float32)
    pred = target + np.float32(0.1) * rng.standard_normal(shape, dtype=np.float32)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(torch.from_numpy(target).reshape(-1), 0.5)
    _check_top_quantiles(pred, target)


# ---------------------------------------------------------------------------
# CSV tables
# ---------------------------------------------------------------------------

def _scores(dtype):
    rng = np.random.default_rng(4)
    times = ["2018010100", "2018010200", "2018010300"]
    table = {
        "upper_z": {t: rng.standard_normal(13).astype(dtype) * 1e3 for t in times},
        "surface": {t: rng.standard_normal(4).astype(dtype) * 1e-6 for t in times},
        "surface_wind_speed": {t: np.array([rng.random()], dtype) for t in times},
        "upper_q": {},
        "upper_t": None,
    }
    table["upper_z"][times[1]][3] = np.nan
    table["surface"][times[2]][0] = np.inf
    return table


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_csv_files_match_jax(tmp_path, dtype):
    scores = _scores(dtype)
    jcsv.save_error_scores(str(tmp_path / "jax"), scores, "rmse")
    tcsv.save_error_scores(str(tmp_path / "port"), scores, "rmse")
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) == [
        "rmse_surface.csv", "rmse_surface_wind_speed.csv", "rmse_upper_q.csv",
        "rmse_upper_z.csv"]
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
        family = name[len("rmse_"):-4]
        idx, cols, values = tcsv.load_error_scores(str(tmp_path / "port"), "rmse", family)
        ref = jcsv.load_error_scores(str(tmp_path / "port"), "rmse", family)
        assert idx == [str(i) for i in ref.index] and cols == list(ref.columns)
        assert values.dtype == np.float32 and values.shape == ref.shape
        np.testing.assert_array_equal(values, ref.values.astype(np.float32))
        if scores[family]:
            np.testing.assert_array_equal(
                values, np.stack(list(scores[family].values())).astype(np.float32))


def test_csv_rejects_a_row_of_the_wrong_width(tmp_path):
    with pytest.raises(ValueError, match="columns"):
        tcsv.save_error_scores(str(tmp_path), {"surface": {"2018010100": np.zeros(5)}}, "rmse")


# ---------------------------------------------------------------------------
# evaluate and the test script
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX tiny model's PRNGKey(0) params, written by the JAX package to
    a .npz, and the port's model loaded from that file."""
    jcfg = jax_tiny()
    m = jcfg.model
    jaux = jax_aux(m, jcfg.train)
    jmodel = JaxPanguModel(m)
    u = np.zeros((1, m.upper_vars, m.levels, m.lat, m.lon), np.float32)
    s = np.zeros((1, m.surface_vars, m.lat, m.lon), np.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), u, s, jaux))
    path = str(tmp_path_factory.mktemp("weights") / "tiny.npz")
    jax_save_npz(path, params)
    cfg = pangu_tiny()
    aux = synthetic_aux_constants(cfg.model, cfg.train, device="cpu")
    args = type("Args", (), {"weights": path})()
    model = load_model_and_params(cfg, args, aux, device="cpu")
    return dict(jcfg=jcfg, jaux=jaux, jmodel=jmodel, params=params, path=path, cfg=cfg,
                aux=aux, model=model)


@pytest.mark.parametrize("batch_size", [1, 2])
def test_evaluate_matches_jax(setup, tmp_path, batch_size):
    """Three test samples; at batch 2 the tail batch holds one."""
    jcfg = setup["jcfg"].replace(data=JaxDataConfig(**DATES))
    jloader = jax_make_loader(jcfg.data, jcfg.model, "test", jcfg.horizon, batch_size)
    ref_loss = jax_evaluate(setup["jmodel"], setup["params"], jloader, setup["jaux"], jcfg,
                            str(tmp_path / "jax"))
    cfg = setup["cfg"].replace(data=DataConfig(**DATES))
    loader = make_loader(cfg.data, cfg.model, "test", cfg.horizon, batch_size)
    spans = {}
    loss = evaluate(setup["model"], loader, setup["aux"], cfg, str(tmp_path / "port"),
                    spans=spans)
    assert sorted(spans) == ["forecast", "h2d", "load", "score"]
    assert all(v >= 0 for v in spans.values())
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    assert assert_same_csv_tree(str(tmp_path / "port"), str(tmp_path / "jax")) == 14
    idx, _, _ = tcsv.load_error_scores(str(tmp_path / "port" / "csv"), "rmse", "upper_z")
    assert idx == ["2018010200", "2018010300", "2018010400"]


def test_score_step_scores_every_sample_like_single_calls(setup):
    """The batched score step's rows equal single-sample calls (the JAX
    step vmaps the single-sample scorer)."""
    cfg, aux, m = setup["cfg"], setup["aux"], setup["cfg"].model
    rng = np.random.default_rng(6)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    up = (2, m.upper_vars, m.levels, m.lat, m.lon)
    sf = (2, m.surface_vars, m.lat, m.lon)
    batch = Batch(draw(*up), draw(*sf), draw(*up), draw(*sf))
    step = make_score_step(setup["model"], cfg, return_fields=True)
    both = step(batch, aux)
    assert tuple(both["output_upper"].shape) == up
    for i in range(2):
        one = step(Batch(*(t[i:i + 1] for t in batch)), aux)
        for k, v in one.items():
            if k != "loss":
                torch.testing.assert_close(both[k][i:i + 1], v, rtol=1e-5, atol=1e-6)


def test_evaluate_empty_window_is_loud_nan(setup, tmp_path, caplog):
    cfg = setup["cfg"].replace(data=DataConfig(test_start="20180101", test_end="20180102",
                                               test_freq="24h", prefetch=0))
    loader = make_loader(cfg.data, cfg.model, "test", cfg.horizon, 1)
    assert len(loader) == 0
    with caplog.at_level(logging.WARNING):
        loss = evaluate(setup["model"], loader, setup["aux"], cfg, str(tmp_path))
    assert np.isnan(loss)
    assert "ZERO scoreable samples" in caplog.text
    _, cols, values = tcsv.load_error_scores(str(tmp_path / "csv"), "rmse", "surface")
    assert cols == ["msl", "u10", "v10", "t2m"] and values.shape == (0, 4)


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}_script", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPT_DATES = ["--set", "data.test_start=20180101 00:00:00",
                "--set", "data.test_end=20180105 00:00:00", "--set", "data.prefetch=0"]


def test_test_script_matches_jax(setup, tmp_path, monkeypatch):
    argv = ["--preset", "tiny", "--weights", setup["path"], *SCRIPT_DATES]
    monkeypatch.setattr(sys, "argv", ["test.py", *argv, "--out", str(tmp_path / "jax")])
    _jax_script("test").main()
    loss = port_test_script.main([*argv, "--out", str(tmp_path / "port")], device="cpu")
    assert np.isfinite(loss)
    assert assert_same_csv_tree(str(tmp_path / "port" / "test"),
                                str(tmp_path / "jax" / "test")) == 14


def test_test_script_visualize_writes_pngs(setup, tmp_path):
    port_test_script.main(["--preset", "tiny", "--weights", setup["path"], *SCRIPT_DATES,
                           "--out", str(tmp_path), "--visualize"], device="cpu")
    pngs = os.listdir(tmp_path / "test" / "24" / "png")
    assert len([p for p in pngs if p.endswith(".png")]) == 6


def test_scripts_refuse_to_run_without_a_card_unless_asked(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_test_script.main(["--preset", "tiny", "--out", str(tmp_path)])
    args = type("Args", (), {"weights": None})()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model_and_params(setup["cfg"], args, setup["aux"])


def test_lora_weights_are_refused_with_the_roadmap_item(setup, tmp_path):
    """LoRA is ported (ROADMAP queue 1, item 7): ``--lora-weights`` now
    merges a tree (tests/test_torch_lora.py), and a file that is not there
    is refused before any scoring."""
    with pytest.raises(FileNotFoundError, match="x.npz"):
        port_test_script.main(["--preset", "tiny", "--out", str(tmp_path),
                               "--lora-weights", str(tmp_path / "x.npz")], device="cpu")
    assert not (tmp_path / "test" / "24" / "csv").exists()


def test_masked_scores_match_jax(setup):
    """With ``use_custom_mask`` both RMSE and ACC go through the region."""
    from pangu_tpu.eval.evaluate import make_field_scorer as jax_scorer
    from pangu_tpu_torch.eval.evaluate import make_field_scorer

    rng = np.random.default_rng(8)
    m = setup["cfg"].model
    mask = (rng.random((m.lat, m.lon)) > 0.5).astype(np.float32)
    up, sf = (m.upper_vars, m.levels, m.lat, m.lon), (m.surface_vars, m.lat, m.lon)
    fields = [rng.standard_normal(s).astype(np.float32) for s in (up, sf, up, sf)]
    jcfg = setup["jcfg"].replace(train=dataclasses.replace(setup["jcfg"].train,
                                                           use_custom_mask=True))
    cfg = setup["cfg"].replace(train=dataclasses.replace(setup["cfg"].train,
                                                         use_custom_mask=True))
    ref = jax_scorer(jcfg)(*fields, dataclasses.replace(setup["jaux"], custom_mask=mask))
    aux = dataclasses.replace(setup["aux"], custom_mask=torch.from_numpy(mask))
    got = make_field_scorer(cfg)(*(torch.from_numpy(f) for f in fields), aux)
    unmasked = make_field_scorer(setup["cfg"])(*(torch.from_numpy(f) for f in fields), aux)
    assert sorted(got) == sorted(ref)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        assert not torch.allclose(got[k], unmasked[k]), k
