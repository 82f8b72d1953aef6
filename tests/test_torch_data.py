"""The port's data stores, dataset and loader against the JAX package's.

Exact equality throughout (numpy on both sides): ``SyntheticStore`` arrays
bit for bit; ``Era5Dataset`` keys and lengths for each date format
("YYYYMMDD", "YYYYMMDD HH:MM:SS") and frequency ("1h" ... "48h") the config
and its tests use, with ``datetime`` arithmetic in place of
``pd.date_range``; the loader's batches and periods with shuffling,
sharding, accumulation and prefetching; the npy store across packages; the
native batch reader's ``load_batch`` against the per-sample path and the
JAX ``load_batch`` (``BATCH_READS`` says which reader ran). ``NetCDFStore``
with fake handles (xarray is on neither machine): the twins of
``tests/test_data.py``'s expver and LRU tests, a load whose handle another
thread's open evicts mid-read (the JAX store reads a closed handle there,
the port's holds the lock over the read, so the open waits), and a
threaded stress run of the handle cache.
"""

import sys
import threading
import time
from datetime import datetime, timedelta

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


@pytest.mark.parametrize("samples,shards", [(1, 4), (2, 8), (3, 7)])
def test_sharded_loader_gives_every_shard_the_same_count(models, samples, shards):
    """More shards than twice the samples: the wrap-padding repeats the
    samples as often as it takes (torch's DistributedSampler), so every
    shard gets the same number of batches and the whole range; unequal
    counts leave the ranks of a data-parallel validation waiting in
    different collectives. (The JAX loader wraps once and comes up short
    here, so there is no JAX side to compare.)"""
    end = (np.datetime64("2018-01-01") + np.timedelta64(samples + 1, "D")).astype(str)
    ds = tds.Era5Dataset(tds.SyntheticStore(models[1]), "20180101", end.replace("-", ""),
                         "24h", 24)
    assert len(ds) == samples
    loaders = [tds.BatchLoader(ds, 1, drop_last=False, num_shards=shards, shard=r, prefetch=0)
               for r in range(shards)]
    per = -(-samples // shards)
    assert [len(ld) for ld in loaders] == [per] * shards
    seen = [p for ld in loaders for _, p in ld]
    assert len(seen) == per * shards and {tuple(p) for p in seen} == {
        tuple(p) for _, p in tds.BatchLoader(ds, 1, drop_last=False, prefetch=0)}


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
    with pytest.raises(ImportError, match="requires xarray") as ref:
        jds.make_store(JaxDataConfig(root=str(tmp_path), store="netcdf"), models[0])
    with pytest.raises(ImportError, match="requires xarray") as got:
        tds.make_store(DataConfig(root=str(tmp_path), store="netcdf"), m)
    assert str(got.value) == str(ref.value)
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


# ---------------------------------------------------------------------------
# The native batch reader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def npy_root(tmp_path_factory):
    """Eight days at 24 h of seeded fields, written by the JAX store."""
    from test_torch_native_loader import build_locked

    build_locked()
    root = str(tmp_path_factory.mktemp("npy"))
    rng = np.random.default_rng(4)
    for d in range(8):
        jds.NpyStore(root).save(datetime(2018, 1, 1) + timedelta(days=d),
                                rng.standard_normal((2, 3, 8, 16)).astype(np.float32),
                                rng.standard_normal((3, 8, 16)).astype(np.float32))
    return root


def _reads(fn):
    before = dict(tds.BATCH_READS)
    out = fn()
    return out, {k: tds.BATCH_READS[k] - before[k] for k in before}


@pytest.mark.parametrize("indices", [[0], [1, 2], [4, 0, 2], [5, 3, 1, 0]])
def test_native_load_batch_matches_per_sample_and_jax(npy_root, monkeypatch, indices):
    ds = tds.Era5Dataset(tds.NpyStore(npy_root), "20180101", "20180108", "24h", 24)
    (arrs, periods), reads = _reads(lambda: ds.load_batch(np.asarray(indices)))
    assert reads == {"native": 1, "per_sample": 0}
    ref_arrs, ref_periods = jds.Era5Dataset(jds.NpyStore(npy_root), "20180101", "20180108",
                                            "24h", 24).load_batch(indices)
    with monkeypatch.context() as mp:
        mp.setattr(tds.native_loader, "native_available", lambda: False)
        (slow, slow_periods), slow_reads = _reads(lambda: ds.load_batch(indices))
    assert slow_reads == {"native": 0, "per_sample": 1}
    assert periods == ref_periods == slow_periods
    assert periods == tuple((f"201801{i + 1:02d}00", f"201801{i + 2:02d}00") for i in indices)
    for a, b, c in zip(arrs, ref_arrs, slow):
        assert a.dtype == np.float32 and a.shape[0] == len(indices)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("name", ["shuffled", "prefetch", "accumulation"])
def test_loader_over_an_npy_store_matches_jax(npy_root, name):
    kw = {"prefetch": 0, **LOADERS[name]}
    ref = jds.BatchLoader(jds.Era5Dataset(jds.NpyStore(npy_root), "20180101", "20180108",
                                          "24h", 24), **kw)
    got = tds.BatchLoader(tds.Era5Dataset(tds.NpyStore(npy_root), "20180101", "20180108",
                                          "24h", 24), **kw)
    batches, reads = _reads(lambda: list(got))
    assert reads == {"native": len(batches), "per_sample": 0} and len(batches) == len(ref)
    for (gb, gp), (rb, rp) in zip(batches, list(ref)):
        assert gp == rp
        for x, y in zip(gb, rb):
            np.testing.assert_array_equal(x, y)


def test_other_stores_read_sample_by_sample(models):
    ds = tds.Era5Dataset(tds.SyntheticStore(models[1]), "20180101", "20180105", "24h", 24)
    (arrs, _), reads = _reads(lambda: ds.load_batch([0, 1]))
    assert reads == {"native": 0, "per_sample": 1}
    np.testing.assert_array_equal(arrs[0][1], ds[1][0])


# ---------------------------------------------------------------------------
# NetCDF, with fake handles
# ---------------------------------------------------------------------------

def test_netcdf_expver_resolution():
    """_sel_time picks the expver slice with finite data (the reference
    hardcodes expver=5, silently returning NaN for finalized months)."""
    from pangu_tpu_torch.data.dataset import NetCDFStore

    class FakeVar:
        def __init__(self, values):
            self.values = np.asarray(values)

    class FakeDs:
        def __init__(self, by_expver):
            self._by = by_expver  # {expver: field}
            self.dims = ("time", "expver")
            self.coords = ("time", "expver")

        def __contains__(self, k):
            return k == "expver"

        def __getitem__(self, k):
            assert k == "expver"
            return FakeVar(sorted(self._by))

        def sel(self, time=None, expver=None):
            class Sub:
                def __init__(s, field):
                    s.data_vars = {"msl": FakeVar(field)}
            return Sub(self._by[expver])

    finite = np.ones((4, 4))
    nans = np.full((4, 4), np.nan)
    # finalized month: data in expver=1, NaN in 5 -> must pick 1
    sub = NetCDFStore._sel_time(FakeDs({1: finite, 5: nans}), None)
    assert np.isfinite(sub.data_vars["msl"].values).all()
    # preliminary month: data in expver=5 -> must pick 5
    sub = NetCDFStore._sel_time(FakeDs({1: nans, 5: finite}), None)
    assert np.isfinite(sub.data_vars["msl"].values).all()


def test_netcdf_lru_handle_cache():
    """NetCDFStore opens each .nc file once per cache residency: a month of
    hourly loads hits the monthly surface file's cached handle instead of
    reopening it per sample (the reference reopens both files every load,
    utils_data.py:146-149). Eviction closes the stalest handle; a re-touch
    refreshes recency."""
    from pangu_tpu_torch.data.dataset import NetCDFStore

    opens, closes = [], []

    class FakeVar:
        def __init__(self, values):
            self.values = np.asarray(values)

    class FakeDs:
        def __init__(self, path):
            self.path = path
            self.dims, self.coords = ("time",), ("time",)

        def __contains__(self, k):
            return False

        def sel(self, time=None):
            f = np.ones((2, 3, 4), np.float32)
            vars_ = {v: FakeVar(f) for v in ("z", "q", "t", "u", "v",
                                             "msl", "u10", "v10", "t2m")}

            class Sub:
                data_vars = vars_

                def __getitem__(s, k):
                    return vars_[k]
            return Sub()

        def close(self):
            closes.append(self.path)

    store = NetCDFStore.__new__(NetCDFStore)  # skip the xarray gate
    store._init_state("/era5", cache_size=2)
    store._open_dataset = lambda path: (opens.append(path), FakeDs(path))[1]

    # 3 hourly loads in one month/day: 2 files opened ONCE, not 6 times
    for h in range(3):
        u, s = store.load(datetime(2023, 1, 5, h))
        assert u.shape == (5, 2, 3, 4) and s.shape == (4, 2, 3, 4)
    assert len(opens) == 2 and not closes

    # next day: new upper file evicts the stalest handle (the old upper —
    # the surface handle was re-touched more recently)
    store.load(datetime(2023, 1, 6, 0))
    assert len(opens) == 3
    assert closes == ["/era5/upper/upper_20230105.nc"]

    # back to day 5: its upper handle was evicted -> reopened (and the
    # day-6 handle, now stalest, is evicted + closed in turn)
    store.load(datetime(2023, 1, 5, 3))
    assert len(opens) == 4
    assert closes[1] == "/era5/upper/upper_20230106.nc"

    store.close()  # the 2 resident handles
    assert len(closes) == 4 and not store._cache


class _Handles:
    """Fake NetCDF handles that refuse a read after close, count closes, and
    can stop one path's first read until released (a read in flight)."""

    FIELD = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)

    def __init__(self, block_path=None):
        self.block_path = block_path
        self.reading, self.go = threading.Event(), threading.Event()
        self.opened, self.closed, self.closed_reads = [], [], []
        self.lock = threading.Lock()

    def open(self, path):
        handles = self

        class Var:
            def __init__(self, ds):
                self.ds = ds

            @property
            def values(self):
                if self.ds.path == handles.block_path and not handles.reading.is_set():
                    handles.reading.set()
                    assert handles.go.wait(10)
                if self.ds.is_closed:
                    with handles.lock:
                        handles.closed_reads.append(self.ds.path)
                    raise RuntimeError(f"read of the closed handle {self.ds.path}")
                return handles.FIELD

        class Ds:
            dims, coords = ("time",), ("time",)

            def __init__(self):
                self.path, self.is_closed = path, False

            def __contains__(self, k):
                return False

            def sel(self, time=None):
                ds = self

                class Sub:
                    data_vars = {}

                    def __getitem__(self, k):
                        return Var(ds)
                return Sub()

            def close(self):
                with handles.lock:
                    assert not self.is_closed, f"{self.path} closed twice"
                    self.is_closed = True
                    handles.closed.append(self.path)

        with self.lock:
            self.opened.append(path)
        return Ds()


def _fake_store(cls, handles, cache_size):
    store = cls.__new__(cls)  # skip the xarray gate
    store._init_state("/era5", cache_size=cache_size)
    store._open_dataset = handles.open
    return store


def _evict_mid_read(cls, b_waits):
    """Thread A loads 2023-01-05 and stops inside its upper read; thread B
    loads 2023-01-06, whose upper file evicts A's handle (cache of 2); then A
    reads on. ``b_waits``: B must still be waiting when A reads on (the
    store serializes the open behind A's read), else B must have ended.
    Returns (handles, A's result or exception, the handles closed before A
    read on, the store)."""
    handles = _Handles(block_path="/era5/upper/upper_20230105.nc")
    store = _fake_store(cls, handles, cache_size=2)
    box = {}

    def run(key, t):
        try:
            box[key] = store.load(t)
        except Exception as e:  # recorded for the assertions
            box[key] = e

    a = threading.Thread(target=run, args=("a", datetime(2023, 1, 5)))
    a.start()
    assert handles.reading.wait(10)
    b = threading.Thread(target=run, args=("b", datetime(2023, 1, 6)))
    b.start()
    # B's load touches no disk: half a second is ample for it to end unless
    # the store makes it wait for A
    b.join(0.5 if b_waits else 10)
    assert b.is_alive() == b_waits
    evicted_before_a_ended = list(handles.closed)
    handles.go.set()
    a.join(10)
    b.join(10)
    assert not a.is_alive() and not b.is_alive()
    assert not isinstance(box["b"], Exception), box["b"]
    return handles, box["a"], evicted_before_a_ended, store


def test_netcdf_load_survives_eviction_of_its_handle():
    """The repair of the JAX store's race: its ``_open`` returns the handle
    and ``load`` reads ``.values`` outside the lock, so another loader
    thread's open can close it mid-read. The port's load reads under the
    lock, so the other open waits: the load neither fails nor reads a closed
    handle, and the evicted handle is closed after the load ends. The arrays
    are the JAX store's."""
    handles, got, closed_early, store = _evict_mid_read(tds.NetCDFStore, b_waits=True)
    assert not isinstance(got, Exception), got
    assert handles.closed_reads == [] and closed_early == []
    assert handles.closed == ["/era5/upper/upper_20230105.nc"]
    store.close()
    assert sorted(handles.closed) == sorted(handles.opened)

    jax_handles, jax_got, jax_closed_early, _ = _evict_mid_read(jds.NetCDFStore, b_waits=False)
    assert jax_closed_early == ["/era5/upper/upper_20230105.nc"]
    assert isinstance(jax_got, RuntimeError) and jax_handles.closed_reads

    ref = _fake_store(jds.NetCDFStore, _Handles(), 2).load(datetime(2023, 1, 5))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_netcdf_handles_hold_under_threaded_loads():
    """16 threads load 12 days through a cache of 2 handles, with the
    interpreter switching threads as often as it can: no read of a closed
    handle, no handle closed twice, and after ``close`` every handle opened
    is closed."""
    handles = _Handles()
    store = _fake_store(tds.NetCDFStore, handles, cache_size=2)
    errors = []

    def worker(k):
        try:
            for i in range(30):
                store.load(datetime(2023, 1, 1) + timedelta(days=(k + i) % 12, hours=i % 3))
        except Exception as e:  # recorded for the assertion
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and handles.closed_reads == []
    store.close()
    assert sorted(handles.closed) == sorted(handles.opened) and not store._cache
