"""ERA5 data pipeline: time-keyed stores + date-range dataset + batch loader
(port of ``pangu_tpu/data/dataset.py``).

  * A *store* maps a timestamp to the (upper, surface) field pair. Backends:
    per-hour ``.npy`` pairs (the native store), the reference's per-hour
    ``.pt`` tensors (PTDataset parity) and a deterministic synthetic
    generator (numpy only: the JAX package's arrays for the same seed). The
    NetCDF store is not ported yet (ROADMAP queue 1, item 5).
  * ``Era5Dataset`` pairs input time t with target time t+horizon over a
    date range (both ends inclusive; ``datetime`` arithmetic in place of
    ``pd.date_range``), with the reference's length rule
    ``len(keys) - horizon // freq_hours - 1`` (era5_data/utils_data.py:106).
  * ``BatchLoader`` shards the key space across data-parallel processes,
    shuffles per epoch, and prefetches batches on a background thread that
    touches numpy only, never CUDA: the consumer moves a batch to the card.

Everything yields numpy; devices are the step function's concern.
"""

from __future__ import annotations

import os
import queue
import re
import threading
from datetime import datetime, timedelta
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from pangu_tpu_torch.config import DataConfig, ModelConfig
from pangu_tpu_torch.train.step import Batch

Periods = Tuple[str, ...]

_TIME_FMT = "%Y%m%d%H"
#: the date formats of the config and its tests
_DATE_FORMATS = ("%Y%m%d", "%Y%m%d %H:%M:%S")
_FREQ = re.compile(r"(\d+)h", re.IGNORECASE)


def time_str(t: datetime) -> str:
    return t.strftime(_TIME_FMT)


def parse_date(s: str) -> datetime:
    """"YYYYMMDD" or "YYYYMMDD HH:MM:SS"; any other text raises ValueError."""
    for fmt in _DATE_FORMATS:
        try:
            return datetime.strptime(str(s), fmt)
        except ValueError:
            continue
    raise ValueError(f"date {s!r} is neither YYYYMMDD nor 'YYYYMMDD HH:MM:SS'")


# ---------------------------------------------------------------------------
# Stores
# ---------------------------------------------------------------------------

class NpyStore:
    """Per-hour ``{root}/upper/upper_YYYYMMDDHH.npy`` + ``{root}/surface/...``
    pairs — the framework's native tensor store (role of the reference's
    converted ``.pt`` store)."""

    def __init__(self, root: str):
        self.root = root

    def load(self, t: datetime) -> Tuple[np.ndarray, np.ndarray]:
        s = time_str(t)
        upper = np.load(os.path.join(self.root, "upper", f"upper_{s}.npy"))
        surface = np.load(os.path.join(self.root, "surface", f"surface_{s}.npy"))
        return upper.astype(np.float32), surface.astype(np.float32)

    def save(self, t: datetime, upper: np.ndarray, surface: np.ndarray) -> None:
        s = time_str(t)
        os.makedirs(os.path.join(self.root, "upper"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "surface"), exist_ok=True)
        np.save(os.path.join(self.root, "upper", f"upper_{s}.npy"), upper)
        np.save(os.path.join(self.root, "surface", f"surface_{s}.npy"), surface)


class PtStore:
    """Reads the reference's per-hour ``.pt`` tensors
    (reference era5_data/utils_data.py:344-362) so existing converted
    datasets work unchanged."""

    def __init__(self, root: str):
        self.root = root

    def load(self, t: datetime) -> Tuple[np.ndarray, np.ndarray]:
        import torch

        s = time_str(t)
        upper = torch.load(
            os.path.join(self.root, "upper", f"upper_{s}.pt"),
            weights_only=False, map_location="cpu",
        )
        surface = torch.load(
            os.path.join(self.root, "surface", f"surface_{s}.pt"),
            weights_only=False, map_location="cpu",
        )
        return (
            np.asarray(upper, dtype=np.float32),
            np.asarray(surface, dtype=np.float32),
        )


class SyntheticStore:
    """Deterministic pseudo-weather keyed by timestamp: smooth fields with a
    time-dependent phase so consecutive hours correlate (enables meaningful
    loss-decreases in tests without any data on disk)."""

    def __init__(self, model_cfg: ModelConfig, seed: int = 0):
        self.cfg = model_cfg
        self.seed = seed
        m = model_cfg
        rng = np.random.default_rng(seed)
        ky = rng.integers(1, 4, size=(8,))
        kx = rng.integers(1, 4, size=(8,))
        self._modes = (ky, kx)
        lat = np.linspace(0, np.pi, m.lat, dtype=np.float32)[:, None]
        lon = np.linspace(0, 2 * np.pi, m.lon, endpoint=False, dtype=np.float32)[None, :]
        self._lat, self._lon = lat, lon

    def load(self, t: datetime) -> Tuple[np.ndarray, np.ndarray]:
        m = self.cfg
        # timezone-free epoch hours: naive-naive arithmetic, unlike
        # .timestamp() which shifts with the host timezone
        hours = (t - datetime(1970, 1, 1)).total_seconds() / 3600.0
        phase = 2 * np.pi * (hours % 240.0) / 240.0
        ky, kx = self._modes

        def field(i: int) -> np.ndarray:
            return np.sin(ky[i % 8] * self._lat + phase + i) * np.cos(
                kx[i % 8] * self._lon - 0.5 * phase
            )

        upper = np.stack(
            [
                np.stack([field(v * m.levels + l) * (1 + 0.1 * l)
                          for l in range(m.levels)])
                for v in range(m.upper_vars)
            ]
        ).astype(np.float32)
        surface = np.stack([field(100 + v) for v in range(m.surface_vars)]).astype(
            np.float32
        )
        return upper, surface


def make_store(cfg: DataConfig, model_cfg: ModelConfig):
    kind = cfg.store if cfg.root else "synthetic"
    if kind == "synthetic":
        return SyntheticStore(model_cfg, cfg.seed)
    if kind == "npy":
        return NpyStore(cfg.root)
    if kind == "pt":
        return PtStore(cfg.root)
    if kind == "netcdf":
        raise NotImplementedError(
            "the NetCDF store is not ported yet (ROADMAP queue 1, item 5): convert the "
            "files to the npy store with the JAX package's scripts/convert_data.py")
    raise ValueError(f"unknown store kind {kind!r}")


# ---------------------------------------------------------------------------
# Dataset + loader
# ---------------------------------------------------------------------------

def _freq_hours(freq: str) -> int:
    """Whole hours of a frequency such as "1h", "6h" or "24h"."""
    match = _FREQ.fullmatch(freq.strip())
    if match is None:
        raise ValueError(f"frequency {freq!r} is not '<hours>h'")
    return int(match.group(1))


def date_range(start: str, end: str, freq: str) -> List[datetime]:
    """Every ``freq`` from ``start`` to ``end``, both ends inclusive
    (``pd.date_range(start, end, freq)``)."""
    t, stop = parse_date(start), parse_date(end)
    step = timedelta(hours=_freq_hours(freq))
    if not step:
        raise ValueError(f"frequency {freq!r} is zero")
    keys = []
    while t <= stop:
        keys.append(t)
        t += step
    return keys


class Era5Dataset:
    """(input_t, surface_t, upper_{t+h}, surface_{t+h}, (t_str, t+h_str))
    samples over a date range (reference era5_data/utils_data.py:60-392)."""

    def __init__(self, store, start: str, end: str, freq: str, horizon: int):
        self.store = store
        self.horizon = horizon
        self.freq = freq
        self.keys: List[datetime] = date_range(start, end, freq)
        # reference length rule (era5_data/utils_data.py:106)
        self.length = len(self.keys) - horizon // _freq_hours(freq) - 1
        if self.length < 0:
            raise ValueError(
                f"date range {start}..{end} too short for horizon {horizon}h"
            )

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int):
        t = self.keys[idx]
        t_end = t + timedelta(hours=self.horizon)
        upper, surface = self.store.load(t)
        tgt_upper, tgt_surface = self.store.load(t_end)
        return upper, surface, tgt_upper, tgt_surface, (time_str(t), time_str(t_end))

    def load_batch(self, indices):
        """Assemble a batch sample by sample (the JAX package's fallback; its
        native C++ batch reader is not ported yet, ROADMAP queue 1, item 5)."""
        samples = [self[int(i)] for i in indices]
        arrs = tuple(np.stack([s[j] for s in samples]) for j in range(4))
        periods = tuple(s[4] for s in samples)
        return arrs, periods


class BatchLoader:
    """Shuffling, process-sharding, prefetching batch iterator.

    Yields (Batch, periods) where periods is a tuple of (start, end) string
    pairs and the Batch holds numpy arrays. ``num_shards``/``shard`` play the
    DistributedSampler role; with ``accumulation`` > 1 batches gain a leading
    microbatch axis.
    """

    def __init__(
        self,
        dataset: Era5Dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        num_shards: int = 1,
        shard: int = 0,
        accumulation: int = 1,
        prefetch: int = 2,
    ):
        if accumulation > 1 and not drop_last:
            # a trailing partial chunk cannot be reshaped to the
            # (accumulation, batch_size) microbatch axes — fail at
            # construction, not at the last batch of the epoch
            raise ValueError("accumulation > 1 requires drop_last=True")
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard = shard
        self.accumulation = accumulation
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.num_shards > 1:
            # pad to a multiple of num_shards by wrapping (torch
            # DistributedSampler semantics) so every process sees the same
            # number of batches — unequal counts deadlock collectives at
            # epoch end
            per = -(-len(idx) // self.num_shards)
            pad = per * self.num_shards - len(idx)
            if pad:
                idx = np.concatenate([idx, idx[:pad]])
        return idx[self.shard :: self.num_shards]

    def __len__(self) -> int:
        per = self.batch_size * self.accumulation
        n = len(self._indices())
        return n // per if self.drop_last else -(-n // per)

    def _assemble(self, indices: Sequence[int]):
        arrs, periods = self.ds.load_batch(indices)
        arrs = list(arrs)
        if self.accumulation > 1:
            arrs = [
                a.reshape((self.accumulation, self.batch_size) + a.shape[1:])
                for a in arrs
            ]
        return Batch(*arrs), periods

    def _batches(self) -> Iterator:
        idx = self._indices()
        per = self.batch_size * self.accumulation
        stop = len(idx) - (len(idx) % per) if self.drop_last else len(idx)
        for i in range(0, stop, per):
            yield self._assemble(idx[i : i + per])

    def __iter__(self) -> Iterator:
        if self.prefetch <= 0:
            yield from self._batches()
            self.epoch += 1
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        errbox = []
        stop = threading.Event()

        def worker():
            try:
                for item in self._batches():
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as e:  # surface loader errors on the main thread
                errbox.append(e)
            finally:
                # The sentinel MUST land: a non-blocking put while the queue
                # is full drops it and strands the consumer's blocking get()
                # forever (exactly the case when the producer outruns the
                # consumer). Block with the same stop-aware loop as item puts.
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # consumer may abandon the generator early (exception in the
            # training loop) — unblock and drain so batches don't pin RAM
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=10)
        if errbox:
            raise errbox[0]
        self.epoch += 1


def make_loader(
    cfg: DataConfig,
    model_cfg: ModelConfig,
    split: str,
    horizon: int,
    batch_size: int,
    accumulation: int = 1,
    num_shards: int = 1,
    shard: int = 0,
) -> BatchLoader:
    store = make_store(cfg, model_cfg)
    ranges = {
        "train": (cfg.train_start, cfg.train_end, cfg.train_freq, True),
        "val": (cfg.val_start, cfg.val_end, cfg.val_freq, False),
        "test": (cfg.test_start, cfg.test_end, cfg.test_freq, False),
    }
    start, end, freq, shuffle = ranges[split]
    ds = Era5Dataset(store, start, end, freq, horizon)
    # train keeps drop_last=True; val/test must score EVERY sample — a
    # dropped tail batch would silently bias the CSVs whenever batch_size
    # does not divide the range
    return BatchLoader(
        ds,
        batch_size,
        shuffle=shuffle,
        seed=cfg.seed,
        drop_last=split == "train",
        num_shards=num_shards,
        shard=shard,
        accumulation=accumulation,
        prefetch=cfg.prefetch,
    )
