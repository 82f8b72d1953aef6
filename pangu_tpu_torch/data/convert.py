"""Offline ETL: NetCDF / reference-.pt archives -> the per-hour .npy store
(port of ``pangu_tpu/data/convert.py``; reference convert_era5.py:1-196).

The reference opens monthly ``surface_YYYYMM.nc`` and daily ``upper_YYYYMMDD
.nc`` files (locally or from S3 via s5cmd/s3fs, download_era5.sh), slices 13
pressure levels, and writes per-hour tensors with a 60-way process pool.
This version converts to the framework's .npy store with a thread pool
(IO-bound) and retry-with-backoff on reads; S3 sources work through any
fsspec-mounted path. ``convert_range`` takes any store with ``.load``, the
synthetic one included. The timestamps come from the port's ``date_range``
(both ends inclusive, ``<n>h`` frequencies), so nothing here imports pandas.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import time
from datetime import datetime
from typing import Callable, Optional

import numpy as np

from pangu_tpu_torch.data.dataset import NetCDFStore, NpyStore, PtStore, date_range, time_str


def _with_retry(fn: Callable, attempts: int = 5, base_delay: float = 1.0):
    """Exponential-backoff retry (role of tenacity in convert_era5.py:34-39)."""
    def wrapped(*args, **kwargs):
        for i in range(attempts):
            try:
                return fn(*args, **kwargs)
            except Exception:
                if i == attempts - 1:
                    raise
                time.sleep(base_delay * 2**i)
    return wrapped


def convert_range(
    src_store,
    dst_root: str,
    start: str,
    end: str,
    freq: str = "1h",
    workers: int = 16,
    overwrite: bool = False,
    log: Optional[Callable[[str], None]] = print,
) -> int:
    """Copy every timestamp in [start, end] at ``freq`` into an NpyStore;
    returns the frames written (a frame whose upper file exists is skipped
    unless ``overwrite``)."""
    dst = NpyStore(dst_root)
    times = date_range(start, end, freq)
    load = _with_retry(src_store.load)

    def one(t: datetime) -> bool:
        s = time_str(t)
        out_u = os.path.join(dst_root, "upper", f"upper_{s}.npy")
        if not overwrite and os.path.exists(out_u):
            return False
        upper, surface = load(t)
        dst.save(t, upper.astype(np.float32), surface.astype(np.float32))
        return True

    done = 0
    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        for i, wrote in enumerate(pool.map(one, times)):
            done += int(wrote)
            if log and i % 100 == 0:
                log(f"converted {i + 1}/{len(times)}")
    return done


def convert_netcdf_to_npy(nc_root: str, dst_root: str, start: str, end: str,
                          freq: str = "1h", workers: int = 16) -> int:
    return convert_range(NetCDFStore(nc_root), dst_root, start, end, freq, workers)


def convert_pt_to_npy(pt_root: str, dst_root: str, start: str, end: str,
                      freq: str = "1h", workers: int = 16) -> int:
    return convert_range(PtStore(pt_root), dst_root, start, end, freq, workers)
