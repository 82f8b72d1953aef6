"""The port's ETL and dataset statistics against the JAX package's.

Exact equality throughout (numpy and file bytes on both sides):
``convert_pt_to_npy`` and ``convert_range`` write the same files, bytes
included, with the same skip-if-written and overwrite rule (the port's
timestamps from its ``date_range``, the JAX package's from pandas);
``convert_netcdf_to_npy`` raises as the JAX one does on a host without
xarray; ``analyze_dataset`` writes the same ``stats_<tag>.txt`` bytes and
``.npz`` arrays; ``compute_normalization_stats`` gives the same arrays; the
``convert_data`` and ``stats`` scripts' ``main`` against the JAX scripts on a
tiny store.
"""

import importlib.util
import os
import sys
from datetime import datetime

import numpy as np
import pytest
import torch

from pangu_tpu.config import pangu_tiny as jax_tiny
from pangu_tpu.data import convert as jconv
from pangu_tpu.data import dataset as jds
from pangu_tpu.data import stats as jstats
from pangu_tpu_torch.config import pangu_tiny
from pangu_tpu_torch.data import convert as tconv
from pangu_tpu_torch.data import dataset as tds
from pangu_tpu_torch.data import stats as tstats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START, END, FREQ = "20180101 00:00:00", "20180103 12:00:00", "12h"


@pytest.fixture(scope="module")
def pt_root(tmp_path_factory):
    """A reference-layout .pt store over START..END at 12 h: seeded f32 upper
    fields, f64 surface fields (the converter casts)."""
    root = tmp_path_factory.mktemp("pt")
    m = pangu_tiny().model
    rng = np.random.default_rng(0)
    for kind in ("upper", "surface"):
        (root / kind).mkdir()
    for t in tds.date_range(START, END, FREQ):
        s = tds.time_str(t)
        torch.save(torch.from_numpy(rng.standard_normal(
            (m.upper_vars, m.levels, m.lat, m.lon)).astype(np.float32)),
            root / "upper" / f"upper_{s}.pt")
        torch.save(torch.from_numpy(rng.standard_normal((m.surface_vars, m.lat, m.lon))),
                   root / "surface" / f"surface_{s}.pt")
    return str(root)


def _files(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_convert_pt_to_npy_writes_the_jax_files(pt_root, tmp_path):
    got = tconv.convert_pt_to_npy(pt_root, str(tmp_path / "port"), START, END, FREQ, workers=3)
    ref = jconv.convert_pt_to_npy(pt_root, str(tmp_path / "jax"), START, END, FREQ, workers=3)
    assert got == ref == 6
    port, jax = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(jax) and len(port) == 12
    assert port == jax
    m = pangu_tiny().model
    u, s = tds.NpyStore(str(tmp_path / "port")).load(datetime(2018, 1, 2, 12))
    assert u.dtype == s.dtype == np.float32 and s.shape == (m.surface_vars, m.lat, m.lon)


@pytest.mark.parametrize("overwrite", [False, True])
def test_skip_and_overwrite_rule_matches_jax(pt_root, tmp_path, overwrite):
    """A frame whose upper file exists is skipped (both of its files kept)
    unless ``overwrite``; the count is of frames written."""
    for name, mod, store in (("port", tconv, tds.PtStore), ("jax", jconv, jds.PtStore)):
        dst = str(tmp_path / name)
        mod.convert_range(store(pt_root), dst, START, "20180101 12:00:00", FREQ, workers=2,
                          log=None)
        np.save(os.path.join(dst, "upper", "upper_2018010100.npy"), np.zeros(3, np.float32))
    counts = [mod.convert_range(store(pt_root), str(tmp_path / name), START, END, FREQ,
                                workers=2, overwrite=overwrite, log=None)
              for name, mod, store in (("port", tconv, tds.PtStore),
                                       ("jax", jconv, jds.PtStore))]
    assert counts == ([6, 6] if overwrite else [4, 4])
    port, jax = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert port == jax and len(port) == 12
    m = pangu_tiny().model
    kept = np.load(tmp_path / "port" / "upper" / "upper_2018010100.npy")
    assert kept.shape == ((m.upper_vars, m.levels, m.lat, m.lon) if overwrite else (3,))


def test_convert_range_from_the_synthetic_store_matches_jax(tmp_path):
    logs = {"port": [], "jax": []}
    tconv.convert_range(tds.SyntheticStore(pangu_tiny().model, 3), str(tmp_path / "port"),
                        "20180101", "20180102", "6h", workers=4, log=logs["port"].append)
    jconv.convert_range(jds.SyntheticStore(jax_tiny().model, 3), str(tmp_path / "jax"),
                        "20180101", "20180102", "6h", workers=4, log=logs["jax"].append)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert logs["port"] == logs["jax"] == ["converted 1/5"]


def test_convert_netcdf_raises_like_jax(tmp_path):
    for mod in (tconv, jconv):
        with pytest.raises(ImportError, match="NetCDFStore requires xarray"):
            mod.convert_netcdf_to_npy(str(tmp_path / "nc"), str(tmp_path / "npy"), START, END)
    assert not (tmp_path / "npy").exists()


def test_retry_matches_jax(monkeypatch):
    for mod in (tconv, jconv):
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
        calls = []

        def flaky(x):
            calls.append(x)
            if len(calls) < 3:
                raise OSError("transient")
            return x * 2

        assert mod._with_retry(flaky)(4) == 8 and calls == [4, 4, 4]
        with pytest.raises(OSError, match="transient"):
            mod._with_retry(lambda: (_ for _ in ()).throw(OSError("transient")), attempts=2)()


def _datasets(kind, root=None):
    """The port's and the JAX package's Era5Dataset over the same data."""
    if kind == "synthetic":
        stores = tds.SyntheticStore(pangu_tiny().model, 1), jds.SyntheticStore(jax_tiny().model, 1)
        args = ("20180101", "20180112", "24h", 24)
    else:
        stores = tds.NpyStore(root), jds.NpyStore(root)
        args = (START, END, FREQ, 24)
    return tds.Era5Dataset(stores[0], *args), jds.Era5Dataset(stores[1], *args)


@pytest.mark.parametrize("kind,limit", [("synthetic", None), ("synthetic", 3), ("npy", None)])
def test_analyze_dataset_writes_the_jax_report(pt_root, tmp_path, kind, limit):
    root = str(tmp_path / "npy")
    tconv.convert_pt_to_npy(pt_root, root, START, END, FREQ, workers=2)
    port_ds, jax_ds = _datasets(kind, root)
    got = tstats.analyze_dataset(port_ds, str(tmp_path / "port"), "t", limit=limit)
    ref = jstats.analyze_dataset(jax_ds, str(tmp_path / "jax"), "t", limit=limit)
    assert os.path.basename(got) == os.path.basename(ref) == "stats_t.txt"
    with open(got, "rb") as a, open(ref, "rb") as b:
        text = a.read()
        assert text == b.read()
    assert f"{limit or len(port_ds)} samples".encode() in text
    a, b = np.load(tmp_path / "port" / "stats_t.npz"), np.load(tmp_path / "jax" / "stats_t.npz")
    assert sorted(a.files) == sorted(b.files) == sorted(
        ["upper_mean", "upper_std", "surface_mean", "surface_std", "lat_wind", "lon_wind"])
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("limit", [None, 2])
def test_compute_normalization_stats_matches_jax(limit):
    port_ds, jax_ds = _datasets("synthetic")
    got = tstats.compute_normalization_stats(port_ds, limit)
    ref = jstats.compute_normalization_stats(jax_ds, limit)
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_reservoir_matches_jax():
    rng = np.random.default_rng(5)
    frames = [(rng.standard_normal((1, 1, 8, 16)).astype(np.float32),
               rng.standard_normal((4, 8, 16)).astype(np.float32) * 9) for _ in range(10)]
    results = []
    for mod in (tstats, jstats):
        class Small(mod.ComprehensiveStats):
            RESERVOIR_SIZE = 64

        st = Small(upper_vars=1, surface_vars=4, levels=1, lat=8, lon=16)
        for i, (u, s) in enumerate(frames):
            st.update(u, s, datetime(2018, 1 + i, 1))
        results.append((st.wind_reservoir.copy(), st.wind_seen, st.results()))
    (ra, na, a), (rb, nb, b) = results
    np.testing.assert_array_equal(ra, rb)
    assert na == nb == 10 * 8 * 16
    assert a["wind_percentiles"] == b["wind_percentiles"]
    assert a["seasonal_wind"] == b["seasonal_wind"] and a["extreme_counts"] == b["extreme_counts"]


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}_etl_script", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_convert_data_script_matches_jax(pt_root, tmp_path, monkeypatch, capsys):
    from pangu_tpu_torch.scripts import convert_data

    args = ["--src", pt_root, "--format", "pt", "--start", START, "--end", END, "--freq", FREQ,
            "--workers", "2"]
    assert convert_data.main([*args, "--dst", str(tmp_path / "port")]) == 6
    monkeypatch.setattr(sys, "argv", ["convert_data.py", *args, "--dst", str(tmp_path / "jax")])
    _jax_script("convert_data").main()
    out = capsys.readouterr().out.splitlines()
    assert out == [line for name in ("port", "jax")
                   for line in ("converted 1/6", f"converted 6 timestamps into {tmp_path / name}")]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


@pytest.mark.parametrize("split,extra", [("test", ["--limit", "2"]),
                                         ("train", ["--tag", "mine"])])
def test_stats_script_matches_jax(pt_root, tmp_path, monkeypatch, split, extra):
    from pangu_tpu_torch.scripts import stats

    root = str(tmp_path / "npy")
    tconv.convert_pt_to_npy(pt_root, root, START, END, FREQ, workers=2)
    args = ["--preset", "tiny", "--set", "data.store=npy", "--set", f"data.root={root}",
            "--set", f"data.{split}_start={START}", "--set", f"data.{split}_end={END}",
            "--set", f"data.{split}_freq={FREQ}", "--split", split, *extra]
    got = stats.main([*args, "--out", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["stats.py", *args, "--out", str(tmp_path / "jax")])
    _jax_script("stats").main()
    tag = "mine" if "--tag" in extra else f"{split}_2018"
    assert got == os.path.join(str(tmp_path / "port"), f"stats_{tag}.txt")
    port, jax = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(jax) == [f"stats_{tag}.npz", f"stats_{tag}.txt"]
    assert port[f"stats_{tag}.txt"] == jax[f"stats_{tag}.txt"]


# ---- an npy store written by convert_range, read by the native reader ------------------

#: the synthetic store's frames written to the npy store (7 at 24 h), its scored range (3
#: samples) and train range (2 samples: 2 steps an epoch at batch 1)
DATA_RANGE = ("20240101", "20240107", "24h")
SCORE_RANGE = dict(test_start="20240101", test_end="20240105", test_freq="24h")
TRAIN_RANGE = dict(train_start="20240101", train_end="20240104", train_freq="24h")


@pytest.fixture(scope="module")
def npy_from_synthetic(tmp_path_factory):
    """The tiny synthetic store's DATA_RANGE written through the port's
    ``convert_range`` into an npy store (the native reader built first)."""
    from test_torch_native_loader import build_locked

    build_locked()
    root = str(tmp_path_factory.mktemp("from_synthetic"))
    store = tds.SyntheticStore(pangu_tiny().model, pangu_tiny().data.seed)
    assert tconv.convert_range(store, root, *DATA_RANGE, log=None) == 7
    return root


def _fit_losses(data: dict, out: str) -> list:
    """Each step's loss of one ``Trainer.fit`` epoch of the tiny preset, batch
    1, seeded weights, over the train range of ``data``'s store."""
    import dataclasses

    from pangu_tpu_torch.aux import synthetic_aux_constants
    from pangu_tpu_torch.config import DataConfig
    from pangu_tpu_torch.data import make_loader
    from pangu_tpu_torch.interop.from_jax import init_params
    from pangu_tpu_torch.model import PanguModel
    from pangu_tpu_torch.train.trainer import Trainer

    cfg = pangu_tiny()
    cfg = cfg.replace(data=DataConfig(**TRAIN_RANGE, **data),
                      train=dataclasses.replace(cfg.train, epochs=1, batch_size=1))
    model = PanguModel(cfg.model)
    init_params(model, seed=0)
    train = make_loader(cfg.data, cfg.model, "train", cfg.horizon, 1)
    trainer = Trainer(cfg, model, synthetic_aux_constants(cfg.model, cfg.train, device="cpu"),
                      out, steps_per_epoch=len(train))
    losses, step = [], trainer.train_step

    def recorded(batch, aux, gen):
        loss = step(batch, aux, gen)
        losses.append(loss.item())
        return loss

    trainer.train_step = recorded
    trainer.fit(train)
    return losses


@pytest.mark.parametrize("reader", ["load_batch", "test_script", "fit_epoch"])
def test_an_npy_store_from_convert_range_feeds_the_synthetic_stores_bits(npy_from_synthetic,
                                                                         tmp_path, reader):
    """What the deleted on-card smoke script's data phase held, at the tiny
    preset on the CPU: the synthetic store written through
    ``convert_range`` and read back by the native batch reader, never the
    per-sample path (``BATCH_READS``), gives the synthetic store's own bits
    to ``load_batch``, the same score CSVs (bytes) to the ``test`` script,
    and the same step losses to a ``Trainer.fit`` epoch."""
    from pangu_tpu_torch.scripts import test as test_script
    from test_torch_data import _reads

    npy = dict(store="npy", root=npy_from_synthetic)
    if reader == "load_batch":
        ds = tds.Era5Dataset(tds.NpyStore(npy_from_synthetic), *DATA_RANGE, 24)
        indices = [len(ds) - 1, 0]
        (got, periods), reads = _reads(lambda: ds.load_batch(indices))
        ref, ref_periods = tds.Era5Dataset(
            tds.SyntheticStore(pangu_tiny().model, pangu_tiny().data.seed), *DATA_RANGE,
            24).load_batch(indices)
        assert reads == {"native": 1, "per_sample": 0} and periods == ref_periods
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    elif reader == "test_script":
        csvs, reads = {}, {}
        for name, data in (("synthetic", dict(store="synthetic")), ("npy", npy)):
            out = str(tmp_path / name)
            argv = ["--preset", "tiny", "--out", out,
                    *[f"--set=data.{k}={v}" for k, v in {**SCORE_RANGE, **data}.items()]]
            _, reads[name] = _reads(lambda: test_script.main(argv, device="cpu"))
            csvs[name] = _files(os.path.join(out, "test", "24", "csv"))
        batches = -(-3 // pangu_tiny().eval.batch_size)
        assert reads["npy"] == {"native": batches, "per_sample": 0}
        assert len(csvs["npy"]) == 14 and csvs["npy"] == csvs["synthetic"]
    else:
        got, reads = _reads(lambda: _fit_losses(npy, str(tmp_path / "npy")))
        assert reads == {"native": 2, "per_sample": 0}
        assert len(got) == 2 and got == _fit_losses(dict(store="synthetic"),
                                                    str(tmp_path / "synthetic"))
