"""Post-hoc aggregation of per-init-time rollout scores
(reference inference/calculate_avg_rmse.py and _upper.py:1-151).

Reads the per-init-time CSV directories written by ``multi_output_rollout``,
bins wind-speed RMSE by forecast hour, and writes mean/std/count pivot CSVs
plus (optionally) an error-bar plot and an init-time x forecast-hour heatmap.

The port's own copy of ``pangu_tpu/rollout/aggregate.py`` (the port imports nothing of the
JAX package); tests/test_torch_port_modules.py holds it to the original.
It imports pandas, so ``pangu_tpu_torch.rollout`` does not import it: only
``scripts/rollout.py --aggregate`` does.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import List, Optional

import pandas as pd


def collect_rollout_scores(
    res_path: str,
    family: str = "surface_wind_speed",
    error: str = "rmse",
    column: Optional[str] = None,
) -> pd.DataFrame:
    """Long dataframe: init_time, target_time, forecast_hour, value."""
    rows: List[dict] = []
    for init_str in sorted(os.listdir(res_path)):
        csv = os.path.join(res_path, init_str, "csv", f"{error}_{family}.csv")
        if not os.path.isfile(csv):
            continue
        init_time = datetime.strptime(init_str, "%Y%m%d%H")
        df = pd.read_csv(csv, index_col=0)
        col = column or df.columns[0]
        for target_str, value in df[col].items():
            target_time = datetime.strptime(str(target_str), "%Y%m%d%H")
            hour = int((target_time - init_time).total_seconds() // 3600)
            rows.append({
                "init_time": init_str,
                "target_time": str(target_str),
                "forecast_hour": hour,
                "value": float(value),
            })
    return pd.DataFrame(rows)


def aggregate_by_forecast_hour(df: pd.DataFrame) -> pd.DataFrame:
    """mean/std/count per forecast hour (reference calculate_avg_rmse.py:84-110)."""
    return (
        df.groupby("forecast_hour")["value"]
        .agg(["mean", "std", "count"])
        .reset_index()
    )


def write_aggregates(
    res_path: str,
    out_dir: str,
    family: str = "surface_wind_speed",
    error: str = "rmse",
    column: Optional[str] = None,
    plot: bool = False,
) -> pd.DataFrame:
    os.makedirs(out_dir, exist_ok=True)
    df = collect_rollout_scores(res_path, family, error, column)
    if df.empty:
        raise FileNotFoundError(f"no rollout score CSVs under {res_path}")
    agg = aggregate_by_forecast_hour(df)
    agg.to_csv(os.path.join(out_dir, f"{error}_{family}_by_hour.csv"), index=False)

    pivot = df.pivot_table(index="init_time", columns="forecast_hour",
                           values="value")
    pivot.to_csv(os.path.join(out_dir, f"{error}_{family}_pivot.csv"))

    if plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 4))
        ax.errorbar(agg["forecast_hour"], agg["mean"], yerr=agg["std"].fillna(0),
                    marker="o", capsize=3)
        ax.set_xlabel("forecast hour")
        ax.set_ylabel(f"{error} {family}")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"{error}_{family}_by_hour.png"), dpi=100)
        plt.close(fig)

        fig, ax = plt.subplots(figsize=(8, 4))
        im = ax.imshow(pivot.values, aspect="auto", cmap="viridis")
        ax.set_xlabel("forecast hour index")
        ax.set_ylabel("init time index")
        fig.colorbar(im, ax=ax)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"{error}_{family}_heatmap.png"), dpi=100)
        plt.close(fig)

    return agg
