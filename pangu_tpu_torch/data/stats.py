"""Dataset statistics tool (reference stat.py:25-266, ComprehensiveStats); a
copy of ``pangu_tpu/data/stats.py``.

Streams a dataset and accumulates:
  * per-channel mean/std for upper and surface fields,
  * surface wind-speed distribution (percentiles, skewness, kurtosis, max),
  * monthly/seasonal wind-speed means,
  * latitude/longitude mean wind profiles,
  * extreme-wind counts above thresholds.

Writes a ``stats_{tag}.txt`` report (and the raw aggregates as .npz).
Also provides ``compute_normalization_stats`` — the online mean/std
alternative to ONNX-extracted statistics (reference era5_data/utils_data.py:
476-495).
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Dict, Optional

import numpy as np


class ComprehensiveStats:
    EXTREME_THRESHOLDS = (15.0, 20.0, 25.0, 30.0)  # m/s
    PERCENTILES = (1, 5, 25, 50, 75, 95, 99)

    def __init__(self, upper_vars: int, surface_vars: int, levels: int,
                 lat: int, lon: int):
        self.n = 0
        self.upper_sum = np.zeros((upper_vars, levels), np.float64)
        self.upper_sq = np.zeros((upper_vars, levels), np.float64)
        self.surface_sum = np.zeros((surface_vars,), np.float64)
        self.surface_sq = np.zeros((surface_vars,), np.float64)
        self.lat_wind = np.zeros((lat,), np.float64)
        self.lon_wind = np.zeros((lon,), np.float64)
        self.month_wind: Dict[int, list] = {m: [] for m in range(1, 13)}
        self.extreme_counts = {t: 0 for t in self.EXTREME_THRESHOLDS}
        # fixed-size reservoir for the wind distribution: appending a 20k
        # subsample per frame (the reference stat.py accumulates FULL
        # fields, stat.py:97-98) grows unboundedly — ~700 MB over a year of
        # hourly frames; a reservoir keeps memory constant with the same
        # percentile/moment accuracy
        self.wind_reservoir = np.empty(self.RESERVOIR_SIZE, np.float32)
        self.wind_filled = 0  # valid prefix of the reservoir
        self.wind_seen = 0  # candidate points offered so far
        self.wind_max = 0.0
        self._px = lat * lon

    RESERVOIR_SIZE = 200_000

    def _offer_wind(self, vals: np.ndarray, rng) -> None:
        """Vectorized reservoir sampling (Algorithm R): constant memory,
        each offered point ends up retained with equal probability."""
        r = self.wind_reservoir
        if self.wind_filled < r.size:
            take = min(r.size - self.wind_filled, vals.size)
            r[self.wind_filled:self.wind_filled + take] = vals[:take]
            self.wind_filled += take
            self.wind_seen += take
            vals = vals[take:]
        if vals.size:
            slots = rng.integers(0, self.wind_seen + vals.size, size=vals.size)
            keep = slots < r.size
            r[slots[keep]] = vals[keep]
            self.wind_seen += vals.size

    def update(self, upper: np.ndarray, surface: np.ndarray,
               when: Optional[datetime] = None) -> None:
        """upper (Vu, L, lat, lon); surface (Vs, lat, lon), physical units."""
        self.n += 1
        self.upper_sum += upper.mean(axis=(-1, -2))
        self.upper_sq += (upper.astype(np.float64) ** 2).mean(axis=(-1, -2))
        self.surface_sum += surface.mean(axis=(-1, -2))
        self.surface_sq += (surface.astype(np.float64) ** 2).mean(axis=(-1, -2))

        ws = np.sqrt(surface[1] ** 2 + surface[2] ** 2)  # u10/v10
        self.lat_wind += ws.mean(axis=-1)
        self.lon_wind += ws.mean(axis=-2)
        self.wind_max = max(self.wind_max, float(ws.max()))
        for t in self.EXTREME_THRESHOLDS:
            self.extreme_counts[t] += int((ws > t).sum())
        # subsample for distribution stats (full fields are ~1M points each)
        flat = ws.ravel()
        rng = np.random.default_rng(self.n)
        idx = rng.choice(flat.size, size=min(20000, flat.size), replace=False)
        self._offer_wind(flat[idx].astype(np.float32), rng)
        if when is not None:
            self.month_wind[when.month].append(float(ws.mean()))

    # ------------------------------------------------------------------
    def results(self) -> Dict[str, object]:
        from scipy import stats as sps

        n = max(1, self.n)
        upper_mean = self.upper_sum / n
        upper_std = np.sqrt(np.maximum(self.upper_sq / n - upper_mean**2, 0))
        surface_mean = self.surface_sum / n
        surface_std = np.sqrt(np.maximum(self.surface_sq / n - surface_mean**2, 0))
        wind = (self.wind_reservoir[: self.wind_filled]
                if self.wind_filled else np.zeros(1, np.float32))

        seasons = {
            "DJF": [12, 1, 2], "MAM": [3, 4, 5], "JJA": [6, 7, 8], "SON": [9, 10, 11],
        }
        seasonal = {
            s: float(np.mean(sum((self.month_wind[m] for m in ms), []) or [np.nan]))
            for s, ms in seasons.items()
        }
        return {
            "samples": self.n,
            "upper_mean": upper_mean,
            "upper_std": upper_std,
            "surface_mean": surface_mean,
            "surface_std": surface_std,
            "wind_percentiles": {
                p: float(np.percentile(wind, p)) for p in self.PERCENTILES
            },
            "wind_mean": float(wind.mean()),
            "wind_std": float(wind.std()),
            "wind_skew": float(sps.skew(wind)),
            "wind_kurtosis": float(sps.kurtosis(wind)),
            "wind_max": self.wind_max,
            "seasonal_wind": seasonal,
            "lat_wind_profile": self.lat_wind / n,
            "lon_wind_profile": self.lon_wind / n,
            "extreme_counts": dict(self.extreme_counts),
        }

    def write_report(self, out_dir: str, tag: str) -> str:
        os.makedirs(out_dir, exist_ok=True)
        r = self.results()
        path = os.path.join(out_dir, f"stats_{tag}.txt")
        with open(path, "w") as f:
            f.write(f"Dataset statistics ({tag}), {r['samples']} samples\n\n")
            f.write("Surface channel mean/std:\n")
            for i, (m, s) in enumerate(zip(r["surface_mean"], r["surface_std"])):
                f.write(f"  ch{i}: mean={m:.4f} std={s:.4f}\n")
            f.write("\nUpper channel mean/std (per level):\n")
            for v in range(r["upper_mean"].shape[0]):
                f.write(f"  var{v}: " + " ".join(
                    f"{x:.3f}" for x in r["upper_mean"][v]) + "\n")
            f.write("\nSurface wind speed:\n")
            f.write(f"  mean={r['wind_mean']:.3f} std={r['wind_std']:.3f} "
                    f"skew={r['wind_skew']:.3f} kurtosis={r['wind_kurtosis']:.3f} "
                    f"max={r['wind_max']:.3f}\n")
            for p, v in r["wind_percentiles"].items():
                f.write(f"  p{p}: {v:.3f}\n")
            f.write("\nSeasonal mean wind: " + str(r["seasonal_wind"]) + "\n")
            f.write("Extreme wind counts: " + str(r["extreme_counts"]) + "\n")
        np.savez(
            os.path.join(out_dir, f"stats_{tag}.npz"),
            upper_mean=r["upper_mean"], upper_std=r["upper_std"],
            surface_mean=r["surface_mean"], surface_std=r["surface_std"],
            lat_wind=r["lat_wind_profile"], lon_wind=r["lon_wind_profile"],
        )
        return path


def analyze_dataset(dataset, out_dir: str, tag: str, limit: Optional[int] = None) -> str:
    """Stream an Era5Dataset and write the report (reference stat.py
    analyze_year_data)."""
    first_u, first_s, *_ = dataset[0]
    cs = ComprehensiveStats(
        first_u.shape[0], first_s.shape[0], first_u.shape[1],
        first_u.shape[2], first_u.shape[3],
    )
    n = len(dataset) if limit is None else min(limit, len(dataset))
    for i in range(n):
        u, s, _, _, periods = dataset[i]
        when = datetime.strptime(periods[0], "%Y%m%d%H")
        cs.update(np.asarray(u), np.asarray(s), when)
    return cs.write_report(out_dir, tag)


def compute_normalization_stats(dataset, limit: Optional[int] = None):
    """Online per-channel mean/std in the canonical aux orientation
    (reference computeStatistics, era5_data/utils_data.py:476-495)."""
    n = len(dataset) if limit is None else min(limit, len(dataset))
    su = sq_u = ss = sq_s = None
    for i in range(n):
        u, s, _, _, _ = dataset[i]
        u, s = np.asarray(u, np.float64), np.asarray(s, np.float64)
        mu = u.mean(axis=(-1, -2), keepdims=True)
        ms = s.mean(axis=(-1, -2), keepdims=True)
        vu = u.var(axis=(-1, -2), keepdims=True)
        vs = s.var(axis=(-1, -2), keepdims=True)
        if su is None:
            su, sq_u, ss, sq_s = mu, vu + mu**2, ms, vs + ms**2
        else:
            su += mu
            sq_u += vu + mu**2
            ss += ms
            sq_s += vs + ms**2
    upper_mean = (su / n)[None]
    upper_std = np.sqrt(np.maximum(sq_u / n - (su / n) ** 2, 1e-12))[None]
    surface_mean = (ss / n)[None, :, 0]
    surface_std = np.sqrt(np.maximum(sq_s / n - (ss / n) ** 2, 1e-12))[None, :, 0]
    return (
        surface_mean.astype(np.float32).reshape(1, -1, 1, 1),
        surface_std.astype(np.float32).reshape(1, -1, 1, 1),
        upper_mean.astype(np.float32),
        upper_std.astype(np.float32),
    )
