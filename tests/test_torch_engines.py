"""The port's rollout engines and rollout script against the JAX package's.

Each engine runs in both packages on the same tiny model (the JAX PRNGKey
params loaded into the port), the same synthetic store and the same dates;
the CSV trees must hold the same files, index and columns, RMSE at rtol
1e-4 and ACC at atol 1e-4 (the golden guard's f32 bound), and forecast
frames agree to max|d| / max|ref| < 1e-4. Covered: ``single_output_eval``
(one and two steps, batch 2, the lead-time-quirk warning),
``multi_output_rollout`` (base model, ``mix24_rule`` with a second model,
``score_bundle``, strict alignment), ``hierarchical_forecast`` with spill
(the same spill files, lazily loaded), ``iterative_eval``, and
``scripts/rollout.py`` in every mode.
"""

import importlib.util
import logging
import os
import sys
from datetime import datetime

import numpy as np
import pytest

import jax

from pangu_tpu.aux import synthetic_aux_constants as jax_aux
from pangu_tpu.config import DataConfig as JaxDataConfig
from pangu_tpu.config import pangu_tiny as jax_tiny
from pangu_tpu.data import Era5Dataset as JaxDataset
from pangu_tpu.data import SyntheticStore as JaxStore
from pangu_tpu.data import make_loader as jax_make_loader
from pangu_tpu.interop.npz_io import save_params_npz as jax_save_npz
from pangu_tpu.model import PanguModel as JaxPanguModel
from pangu_tpu.rollout import engines as je
from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.config import DataConfig, pangu_tiny
from pangu_tpu_torch.data import Era5Dataset, SyntheticStore, make_loader
from pangu_tpu_torch.interop.from_jax import load_jax_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.rollout import engines as te
from pangu_tpu_torch.scripts import rollout as port_rollout

from test_torch_eval import assert_same_csv_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Three JAX param sets (PRNGKey 0, 1, 2), their port models, .npz files
    of each, and the inputs of one ladder."""
    jcfg, cfg = jax_tiny(), pangu_tiny()
    m = jcfg.model
    jaux = jax_aux(m, jcfg.train)
    aux = synthetic_aux_constants(cfg.model, cfg.train, device="cpu")
    jmodel = JaxPanguModel(m)
    rng = np.random.default_rng(0)
    upper = rng.standard_normal((1, m.upper_vars, m.levels, m.lat, m.lon)).astype(np.float32)
    surface = rng.standard_normal((1, m.surface_vars, m.lat, m.lon)).astype(np.float32)
    init = jax.jit(jmodel.init)
    root = tmp_path_factory.mktemp("weights")
    params, models, paths = [], [], []
    for seed in range(3):
        p = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed), upper, surface,
                                                    jaux))
        model = PanguModel(cfg.model).eval()
        load_jax_params(model, cfg.model, p)
        path = str(root / f"w{seed}.npz")
        jax_save_npz(path, p)
        params.append(p)
        models.append(model)
        paths.append(path)
    return dict(jcfg=jcfg, cfg=cfg, jaux=jaux, aux=aux, jmodel=jmodel, params=params,
                models=models, paths=paths, upper=upper, surface=surface)


def _bundles(setup, which):
    """{horizon: param set} -> (JAX bundles, port bundles)."""
    jb = {h: je.ModelBundle(setup["jmodel"], setup["params"][i], setup["jaux"], h)
          for h, i in which.items()}
    tb = {h: te.ModelBundle(setup["models"][i], setup["aux"], h) for h, i in which.items()}
    return jb, tb


def _datasets(setup, start, end, freq, horizon=24):
    return (JaxDataset(JaxStore(setup["jcfg"].model), start, end, freq, horizon),
            Era5Dataset(SyntheticStore(setup["cfg"].model), start, end, freq, horizon))


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("freq, steps, batch_size", [("24h", 1, 1), ("24h", 1, 2),
                                                     ("12h", 2, 1)])
def test_single_output_eval_matches_jax(setup, tmp_path, caplog, freq, steps, batch_size):
    dates = dict(test_start="20180101", test_end="20180104", test_freq=freq, prefetch=0)
    jcfg = setup["jcfg"].replace(data=JaxDataConfig(**dates))
    cfg = setup["cfg"].replace(data=DataConfig(**dates))
    jb, tb = _bundles(setup, {24: 0})
    je.single_output_eval(jb[24], jax_make_loader(jcfg.data, jcfg.model, "test", 24, batch_size),
                          jcfg, str(tmp_path / "jax"), steps=steps)
    with caplog.at_level(logging.WARNING, logger="pangu_tpu_torch.rollout"):
        te.single_output_eval(tb[24], make_loader(cfg.data, cfg.model, "test", 24, batch_size),
                              cfg, str(tmp_path / "port"), steps=steps)
    quirk = [r.message for r in caplog.records
             if r.name == "pangu_tpu_torch.rollout" and "lead-time quirk" in r.message]
    assert len(quirk) == (steps > 1)
    if steps > 1:
        assert "48h" in quirk[0] and "t+24h label" in quirk[0]
    assert assert_same_csv_tree(str(tmp_path / "port"), str(tmp_path / "jax")) == 14


def test_multi_output_rollout_matches_jax(setup, tmp_path):
    jds, tds = _datasets(setup, "20180101", "20180106", "24h")
    jb, tb = _bundles(setup, {24: 0})
    je.multi_output_rollout(jb, jds, setup["jcfg"], str(tmp_path / "jax"), 24, lead_days=2)
    te.multi_output_rollout(tb, tds, setup["cfg"], str(tmp_path / "port"), 24, lead_days=2)
    assert sorted(os.listdir(tmp_path / "port")) == ["2018010100", "2018010200",
                                                      "2018010300", "2018010400"]
    assert assert_same_csv_tree(str(tmp_path / "port"), str(tmp_path / "jax")) == 4 * 14


def test_mix24_rollout_with_score_bundle_matches_jax(setup, tmp_path):
    """Base 6h model (params 0) and a 24h model (params 1) under mix24's
    rule, a third model (params 2) scored beside the chain."""
    jds, tds = _datasets(setup, "20180101", "20180103", "6h", horizon=6)
    jb, tb = _bundles(setup, {6: 0, 24: 1})
    jsb, tsb = (b[6] for b in _bundles(setup, {6: 2}))
    for name, scored in (("plain", False), ("scored", True)):
        je.multi_output_rollout(jb, jds, setup["jcfg"], str(tmp_path / name / "jax"), 6,
                                lead_days=1, choose_horizon=je.mix24_rule(6),
                                score_bundle=jsb if scored else None)
        te.multi_output_rollout(tb, tds, setup["cfg"], str(tmp_path / name / "port"), 6,
                                lead_days=1, choose_horizon=te.mix24_rule(6),
                                score_bundle=tsb if scored else None)
        assert assert_same_csv_tree(str(tmp_path / name / "port"),
                                    str(tmp_path / name / "jax")) == 2 * 14
    from pangu_tpu_torch.eval.csv_io import load_error_scores

    plain = load_error_scores(str(tmp_path / "plain" / "port" / "2018010100" / "csv"), "rmse",
                              "surface")
    scored = load_error_scores(str(tmp_path / "scored" / "port" / "2018010100" / "csv"), "rmse",
                               "surface")
    assert plain[0] == scored[0] == ["2018010106", "2018010112", "2018010118", "2018010200"]
    assert not np.allclose(plain[2], scored[2])


def test_multi_output_rollout_strict_alignment(setup, tmp_path):
    _, tb = _bundles(setup, {24: 0})
    _, sparse = _datasets(setup, "20180101", "20180109", "48h")
    with pytest.raises(ValueError, match="no ground truth"):
        te.multi_output_rollout(tb, sparse, setup["cfg"], str(tmp_path / "s"), 24, lead_days=2)


@pytest.mark.parametrize("hour", range(0, 24, 3))
def test_mix24_rule_matches_jax(hour):
    t = datetime(2018, 1, 2, hour)
    for base in (1, 3, 6, 24):
        assert te.mix24_rule(base)(t) == je.mix24_rule(base)(t)


def test_hierarchical_forecast_with_spill_matches_jax(setup, tmp_path):
    jb, tb = _bundles(setup, {24: 0, 6: 1, 3: 2, 1: 0})
    t0 = datetime(2018, 1, 1)
    u, s = setup["upper"][0], setup["surface"][0]
    ref = je.hierarchical_forecast(jb, t0, u, s, spill_dir=str(tmp_path / "jax"))
    got = te.hierarchical_forecast(tb, t0, u, s, spill_dir=str(tmp_path / "port"))
    assert list(got) == list(ref) == list(range(24, 49))
    assert all(isinstance(v, str) for v in got._entries.values())  # lazy: paths until read

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(tmp_path / "port") == files(tmp_path / "jax")
    for h in got:
        (gu, gs), (ru, rs) = got[h], ref[h]
        assert _rel(gu, ru) < 1e-4 and _rel(gs, rs) < 1e-4, h


def test_hierarchical_forecast_chains_a_missing_rung_like_jax(setup):
    jb, tb = _bundles(setup, {6: 0})
    t0 = datetime(2018, 1, 1)
    ref = je.hierarchical_forecast(jb, t0, setup["upper"], setup["surface"], hours=(24, 30))
    got = te.hierarchical_forecast(tb, t0, setup["upper"], setup["surface"], hours=(24, 30))
    assert sorted(got) == sorted(ref) == [24, 30]
    for h in got:
        assert _rel(got[h][0], ref[h][0]) < 1e-4


def test_iterative_eval_matches_jax(setup, tmp_path):
    jds, tds = _datasets(setup, "20180101", "20180105", "24h")
    jb, tb = _bundles(setup, {24: 0, 6: 1})
    je.iterative_eval(jb, jds, setup["jcfg"], str(tmp_path / "jax"),
                      spill_dir=str(tmp_path / "jax_spill"))
    te.iterative_eval(tb, tds, setup["cfg"], str(tmp_path / "port"),
                      spill_dir=str(tmp_path / "port_spill"))
    assert assert_same_csv_tree(str(tmp_path / "port"), str(tmp_path / "jax")) == 3 * 14
    with pytest.raises(ValueError, match="no qualifying init"):
        te.iterative_eval(tb, tds, setup["cfg"], str(tmp_path / "none"), starts_at_hour=6)


def _jax_rollout(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_rollout_script", os.path.join(REPO, "scripts", "rollout.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["rollout.py", *argv])
    mod.main()


SCRIPT_DATES = ["--set", "data.test_start=20180101", "--set", "data.test_end=20180104",
                "--set", "data.prefetch=0"]


@pytest.mark.parametrize("mode, extra", [
    ("single", []),
    ("multi", ["--lead-days", "2", "--aggregate"]),
    ("mix24", ["--horizon", "6", "--lead-days", "1", "--set", "data.test_freq=6h",
               "--weights-24", 1]),
    ("iterative", ["--weights-6", 1]),
])
def test_rollout_script_matches_jax(setup, tmp_path, monkeypatch, mode, extra):
    extra = [setup["paths"][x] if isinstance(x, int) else x for x in extra]
    argv = ["--preset", "tiny", "--mode", mode, "--weights", setup["paths"][0], *SCRIPT_DATES,
            *extra]
    _jax_rollout([*argv, "--out", str(tmp_path / "jax")], monkeypatch)
    out = port_rollout.main([*argv, "--out", str(tmp_path / "port")], device="cpu")
    horizon = "6" if mode == "mix24" else "24"
    assert out == os.path.join(str(tmp_path / "port"), f"rollout_{mode}", horizon)
    jax_out = os.path.join(str(tmp_path / "jax"), f"rollout_{mode}", horizon)
    assert assert_same_csv_tree(out, jax_out) >= 14
    if mode == "multi":
        import pandas as pd

        for name in ("rmse_surface_wind_speed_by_hour.csv", "rmse_surface_wind_speed_pivot.csv"):
            a = pd.read_csv(os.path.join(out, "agg", name))
            b = pd.read_csv(os.path.join(jax_out, "agg", name))
            assert list(a.columns) == list(b.columns)
            np.testing.assert_allclose(a.values, b.values, rtol=1e-4, err_msg=name)
        assert os.path.exists(os.path.join(out, "agg", "rmse_surface_wind_speed_by_hour.png"))


def test_rollout_script_mix24_needs_the_24h_weights(setup, tmp_path):
    with pytest.raises(SystemExit, match="needs weights for horizons"):
        port_rollout.main(["--preset", "tiny", "--mode", "mix24", "--horizon", "6",
                           "--out", str(tmp_path), *SCRIPT_DATES], device="cpu")


def test_test_script_csvs_hold_the_score_steps_scores(setup, tmp_path):
    """What the deleted on-card smoke script's forecast-and-score phase held
    of the ``test`` script, at the tiny preset on the CPU: over 3 samples
    the 8 ``rmse_*`` and 6 ``acc_*`` CSVs hold one row per target time and
    exactly the float32 scores that the score step gives on the same
    weights and samples."""
    import torch

    from pangu_tpu_torch.eval.csv_io import load_error_scores
    from pangu_tpu_torch.eval.evaluate import ACC_FAMILIES, RMSE_FAMILIES, make_score_step
    from pangu_tpu_torch.scripts import test as port_test
    from pangu_tpu_torch.train import Batch

    dates = dict(store="synthetic", test_start="20240101", test_end="20240105",
                 test_freq="24h")
    port_test.main(["--preset", "tiny", "--weights", setup["paths"][0], "--out",
                    str(tmp_path), *[f"--set=data.{k}={v}" for k, v in dates.items()]],
                   device="cpu")
    csv_dir = tmp_path / "test" / "24" / "csv"
    files = [(e, f) for e, fams in (("rmse", RMSE_FAMILIES), ("acc", ACC_FAMILIES))
             for f in fams]
    assert sorted(os.listdir(csv_dir)) == sorted(f"{e}_{f}.csv" for e, f in files)
    tables = {f"{e}_{f}": load_error_scores(str(csv_dir), e, f) for e, f in files}
    cfg = setup["cfg"].replace(data=DataConfig(**dates))
    step = make_score_step(setup["models"][0], cfg)
    rows = []
    for host, periods in make_loader(cfg.data, cfg.model, "test", cfg.horizon, 1):
        scores = step(Batch(*(torch.from_numpy(x) for x in host)), setup["aux"])
        rows.append(periods[0][1])
        for k, (index, _, values) in tables.items():
            np.testing.assert_array_equal(values[index.index(periods[0][1])],
                                          scores[k][0].numpy().astype(np.float32), err_msg=k)
    assert rows == ["2024010200", "2024010300", "2024010400"]
    assert all(index == rows for index, _, _ in tables.values())
