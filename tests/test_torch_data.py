"""The port's data stores, dataset and loader against the JAX package's.

Exact equality throughout (numpy on both sides): ``SyntheticStore`` arrays
bit for bit; ``Era5Dataset`` keys and lengths for each date format
("YYYYMMDD", "YYYYMMDD HH:MM:SS") and frequency ("1h" ... "48h") the config
and its tests use, with ``datetime`` arithmetic in place of
``pd.date_range``; the loader's batches and periods with shuffling,
sharding, accumulation and prefetching; the npy store across packages.
"""

import threading
import time
from datetime import datetime

import numpy as np
import pytest

from pangu_tpu.config import DataConfig as JaxDataConfig
from pangu_tpu.config import pangu_tiny as jax_tiny
from pangu_tpu.data import dataset as jds
from pangu_tpu_torch.config import DataConfig, pangu_tiny
from pangu_tpu_torch.data import dataset as tds

DATE_FORMATS = {"day": "%Y%m%d", "day_time": "%Y%m%d %H:%M:%S"}
FREQS = ["1h", "6h", "12h", "24h", "48h"]


@pytest.fixture(scope="module")
def models():
    return jax_tiny().model, pangu_tiny().model


@pytest.mark.parametrize("seed", [0, 99])
def test_synthetic_store_is_bit_equal(models, seed):
    jstore, tstore = jds.SyntheticStore(models[0], seed), tds.SyntheticStore(models[1], seed)
    for t in (datetime(2018, 1, 1), datetime(2020, 5, 1, 13), datetime(2024, 12, 31, 23)):
        for a, b in zip(tstore.load(t), jstore.load(t)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("freq", FREQS)
@pytest.mark.parametrize("fmt", sorted(DATE_FORMATS))
def test_dataset_keys_and_length_match(models, fmt, freq):
    start = datetime(2018, 1, 1, 6).strftime(DATE_FORMATS[fmt])
    end = datetime(2018, 1, 9, 18).strftime(DATE_FORMATS[fmt])
    store = tds.SyntheticStore(models[1])
    for horizon in (1, 24):
        ref = jds.Era5Dataset(jds.SyntheticStore(models[0]), start, end, freq, horizon)
        got = tds.Era5Dataset(store, start, end, freq, horizon)
        assert got.keys == ref.keys and len(got) == len(ref)
    assert tds._freq_hours(freq) == jds._freq_hours(freq)
    assert tds._freq_hours(freq.upper()) == jds._freq_hours(freq.upper())


@pytest.mark.parametrize("bad", ["2018-01-01", "20180101 06:00", "2018010106", "01/01/2018"])
def test_other_date_formats_raise(models, bad):
    with pytest.raises(ValueError, match="YYYYMMDD"):
        tds.Era5Dataset(tds.SyntheticStore(models[1]), bad, "20180105", "24h", 24)


@pytest.mark.parametrize("bad", ["1d", "30min", "h", "6 hours", "0h"])
def test_other_frequencies_raise(models, bad):
    with pytest.raises(ValueError):
        tds.Era5Dataset(tds.SyntheticStore(models[1]), "20180101", "20180105", bad, 24)


def test_too_short_range_raises(models):
    with pytest.raises(ValueError, match="too short"):
        tds.Era5Dataset(tds.SyntheticStore(models[1]), "20180101", "20180101", "24h", 48)


def test_samples_match(models):
    ref = jds.Era5Dataset(jds.SyntheticStore(models[0]), "20180101", "20180110", "12h", 24)
    got = tds.Era5Dataset(tds.SyntheticStore(models[1]), "20180101", "20180110", "12h", 24)
    for i in (0, len(got) - 1):
        a, b = got[i], ref[i]
        assert a[4] == b[4]
        for x, y in zip(a[:4], b[:4]):
            np.testing.assert_array_equal(x, y)


LOADERS = {
    "plain": dict(batch_size=2),
    "shuffled": dict(batch_size=2, shuffle=True, seed=5),
    "tail": dict(batch_size=4, drop_last=False),
    "sharded": dict(batch_size=1, shuffle=True, seed=7, num_shards=3, shard=1),
    "accumulation": dict(batch_size=2, accumulation=3),
    "prefetch": dict(batch_size=2, shuffle=True, seed=1, prefetch=2),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_batches_match(models, name):
    kw = {"prefetch": 0, **LOADERS[name]}
    ref_ds = jds.Era5Dataset(jds.SyntheticStore(models[0]), "20180101", "20180122", "24h", 24)
    got_ds = tds.Era5Dataset(tds.SyntheticStore(models[1]), "20180101", "20180122", "24h", 24)
    ref, got = jds.BatchLoader(ref_ds, **kw), tds.BatchLoader(got_ds, **kw)
    assert len(got) == len(ref) > 0
    for epoch in range(2):
        got_batches, ref_batches = list(got), list(ref)
        assert len(got_batches) == len(ref_batches) == len(ref)
        for (gb, gp), (rb, rp) in zip(got_batches, ref_batches):
            assert gp == rp, epoch
            assert type(gb).__name__ == "Batch"
            for x, y in zip(gb, rb):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_make_loader_matches(models, split):
    dates = dict(train_start="20180101", train_end="20180115", val_start="20180201",
                 val_end="20180205", test_start="20180210 00:00:00",
                 test_end="20180214 00:00:00", prefetch=0)
    ref = jds.make_loader(JaxDataConfig(**dates), models[0], split, 24, 2)
    got = tds.make_loader(DataConfig(**dates), models[1], split, 24, 2)
    assert len(got) == len(ref)
    assert [p for _, p in got] == [p for _, p in ref]


def test_make_store_kinds(models, tmp_path):
    m = models[1]
    assert isinstance(tds.make_store(DataConfig(), m), tds.SyntheticStore)
    assert isinstance(tds.make_store(DataConfig(root=str(tmp_path), store="npy"), m),
                      tds.NpyStore)
    assert isinstance(tds.make_store(DataConfig(root=str(tmp_path), store="pt"), m), tds.PtStore)
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        tds.make_store(DataConfig(root=str(tmp_path), store="netcdf"), m)
    with pytest.raises(ValueError, match="unknown store"):
        tds.make_store(DataConfig(root=str(tmp_path), store="zarr"), m)


def test_npy_store_reads_what_the_jax_store_wrote(tmp_path):
    t = datetime(2018, 1, 1, 6)
    rng = np.random.default_rng(0)
    u = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    s = rng.standard_normal((2, 4, 5)).astype(np.float32)
    jds.NpyStore(str(tmp_path / "a")).save(t, u, s)
    for a, b in zip(tds.NpyStore(str(tmp_path / "a")).load(t), (u, s)):
        np.testing.assert_array_equal(a, b)
    tds.NpyStore(str(tmp_path / "b")).save(t, u, s)
    for a, b in zip(jds.NpyStore(str(tmp_path / "b")).load(t), (u, s)):
        np.testing.assert_array_equal(a, b)


def test_pt_store_reads_reference_tensors(tmp_path):
    import torch

    t = datetime(2018, 1, 1, 6)
    for kind, shape in (("upper", (2, 3, 4, 5)), ("surface", (2, 4, 5))):
        (tmp_path / kind).mkdir()
        torch.save(torch.full(shape, 1.5, dtype=torch.float64),
                   tmp_path / kind / f"{kind}_2018010106.pt")
    u, s = tds.PtStore(str(tmp_path)).load(t)
    assert u.dtype == s.dtype == np.float32 and u.shape == (2, 3, 4, 5)
    assert float(u.max()) == float(s.min()) == 1.5


def test_prefetch_early_exit_does_not_hang(models):
    ds = tds.Era5Dataset(tds.SyntheticStore(models[1]), "20180101", "20180301", "24h", 24)
    loader = tds.BatchLoader(ds, batch_size=1, prefetch=2)
    before = threading.active_count()
    it = iter(loader)
    next(it)
    it.close()  # abandon mid-iteration
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_prefetch_surfaces_loader_errors(models):
    class Broken(tds.SyntheticStore):
        def load(self, t):
            if t.day == 3:
                raise OSError("unreadable")
            return super().load(t)

    ds = tds.Era5Dataset(Broken(models[1]), "20180101", "20180110", "24h", 24)
    with pytest.raises(OSError, match="unreadable"):
        list(tds.BatchLoader(ds, batch_size=1, prefetch=2))
