"""Score CSV sinks, format-compatible with the reference
(save_errorScores, era5_data/utils.py:179-216): one CSV per variable family,
rows indexed by target time, columns = pressure levels / surface variables.

Port of ``pangu_tpu/eval/csv_io.py`` on the standard ``csv`` module: the
files are those pandas writes there (same names, header row, index column,
column names and number text: ``str`` of the array's numpy scalar, an empty
field for NaN), and ``load_error_scores`` returns ``(index, columns, values)``
with float32 values in place of a DataFrame.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from pangu_tpu_torch.config import ERA5_SURFACE_VARIABLES, ERA5_UPPER_LEVELS


def _cell(v) -> str:
    return "" if np.isnan(v) else str(v)


def save_error_scores(
    csv_path: str,
    scores: Mapping[str, Dict[str, np.ndarray]],
    error: str,
    upper_levels: Sequence[str] = ERA5_UPPER_LEVELS,
    surface_vars: Sequence[str] = ERA5_SURFACE_VARIABLES,
) -> None:
    """scores maps family name -> {target_time: per-channel array}.

    Families: upper_z/q/t/u/v, upper_wind_speed (level columns),
    surface (surface-variable columns), surface_wind_speed.
    """
    os.makedirs(csv_path, exist_ok=True)
    for family, d in scores.items():
        if d is None:
            continue
        if family == "surface":
            cols: Sequence[str] = surface_vars
        elif family == "surface_wind_speed":
            cols = ["wind_speed"]
        else:
            cols = upper_levels
        with open(os.path.join(csv_path, f"{error}_{family}.csv"), "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["", *cols])
            for key, v in d.items():
                row = np.atleast_1d(np.asarray(v)).ravel()
                if row.size != len(cols):
                    raise ValueError(f"{family} {key}: {row.size} values for {len(cols)} columns")
                w.writerow([key, *(_cell(x) for x in row)])


def load_error_scores(csv_path: str, error: str,
                      family: str) -> Tuple[List[str], List[str], np.ndarray]:
    """(row keys, column names, float32 values of shape (rows, columns));
    an empty field reads as NaN."""
    with open(os.path.join(csv_path, f"{error}_{family}.csv"), newline="") as f:
        rows = list(csv.reader(f))
    columns = rows[0][1:]
    index = [r[0] for r in rows[1:]]
    values = np.array([[float(x) if x else np.nan for x in r[1:]] for r in rows[1:]],
                      dtype=np.float32).reshape(len(index), len(columns))
    return index, columns, values
