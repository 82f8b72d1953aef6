"""Evaluation engine (port of ``pangu_tpu/eval/evaluate.py``; reference test(),
models/pangu_sample.py:391-581).

Per test sample: forward -> weighted loss on normalized fields ->
de-normalize -> latitude-weighted RMSE for z/q/t/u/v (13 levels each),
upper wind speed, surface (4 vars), surface wind speed -> anomaly ACC
against the climatological mean for the same families -> CSV score tables.

The forward is the model in eval mode under ``torch.inference_mode``, as in
``make_forecast_step``, so a bf16 model with ``use_pallas_attention`` runs
the block kernel on the card. The host loop moves each numpy batch to the
model's device (pinned host memory, non-blocking copies) and collects numpy
scores keyed by target time.
"""

from __future__ import annotations

import logging
import os
import time
from functools import partial
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from pangu_tpu_torch.aux import AuxConstants, norm_back_data, norm_data
from pangu_tpu_torch.config import (ERA5_SURFACE_VARIABLES, ERA5_UPPER_LEVELS,
                                    ERA5_UPPER_VARIABLES, PanguConfig)
from pangu_tpu_torch.eval.csv_io import save_error_scores
from pangu_tpu_torch.metrics import (
    weighted_acc_channels,
    weighted_acc_masked_channels,
    weighted_rmse_channels,
    weighted_rmse_channels_masked,
    wind_speed,
)
from pangu_tpu_torch.train.loss import weighted_l1_loss
from pangu_tpu_torch.train.step import Batch, make_forward


def to_device(x, device: torch.device) -> torch.Tensor:
    """A numpy array (or tensor) on ``device``: to the card through pinned
    host memory with a non-blocking copy."""
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    if device.type == "cuda" and not t.is_cuda:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_field_scorer(cfg: PanguConfig) -> Callable:
    """(out_upper, out_surface, tgt_upper, tgt_surface, aux) -> score dict.

    Physical-unit scoring shared by evaluate() and the rollout engines
    (reference models/pangu_sample.py:531-570). Fields are (..., Vu, L, H, W)
    and (..., Vs, H, W): leading axes (a batch) carry through to the scores,
    so one call scores every sample."""

    use_mask = cfg.train.use_custom_mask

    @torch.inference_mode()
    def score_fields(ou, os_, tu, ts, aux: AuxConstants) -> Dict[str, torch.Tensor]:
        ws_o = wind_speed(ou.select(-4, 3), ou.select(-4, 4))
        ws_t = wind_speed(tu.select(-4, 3), tu.select(-4, 4))
        ws_os = wind_speed(os_.select(-3, 1), os_.select(-3, 2))
        ws_ts = wind_speed(ts.select(-3, 1), ts.select(-3, 2))

        if use_mask and aux.custom_mask is not None:
            rmse = partial(weighted_rmse_channels_masked, mask=aux.custom_mask)
            # ACC must honor the same region (reference
            # era5_data/score.py:46-61 weighted_acc_masked) — a masked RMSE
            # next to a GLOBAL ACC silently mixes region and global scores
            acc = partial(weighted_acc_masked_channels, mask=aux.custom_mask)
        else:
            rmse = weighted_rmse_channels
            acc = weighted_acc_channels

        out: Dict[str, torch.Tensor] = {}
        for i, var in enumerate("zqtuv"):
            out[f"rmse_upper_{var}"] = rmse(ou.select(-4, i), tu.select(-4, i))
        out["rmse_upper_wind_speed"] = rmse(ws_o, ws_t)
        out["rmse_surface"] = rmse(os_, ts)
        out["rmse_surface_wind_speed"] = rmse(ws_os.unsqueeze(-3), ws_ts.unsqueeze(-3))

        # anomalies vs climatological mean (reference models/pangu_sample.py:550-570)
        um = aux.upper_mean[0]
        sm = aux.surface_mean[0]
        ou_a, tu_a = ou - um, tu - um
        os_a, ts_a = os_ - sm, ts - sm
        for i, var in enumerate("zqtuv"):
            out[f"acc_upper_{var}"] = acc(ou_a.select(-4, i), tu_a.select(-4, i))
        out["acc_surface"] = acc(os_a, ts_a)
        return out

    return score_fields


RMSE_FAMILIES = [
    "upper_z", "upper_q", "upper_t", "upper_u", "upper_v",
    "upper_wind_speed", "surface", "surface_wind_speed",
]
ACC_FAMILIES = ["upper_z", "upper_q", "upper_t", "upper_u", "upper_v", "surface"]


def score_columns(cfg: PanguConfig):
    levels = [str(l) for l in range(cfg.model.levels)]
    svars = [str(v) for v in range(cfg.model.surface_vars)]
    if cfg.model.levels == len(ERA5_UPPER_LEVELS):
        levels = list(ERA5_UPPER_LEVELS)
    if cfg.model.surface_vars == len(ERA5_SURFACE_VARIABLES):
        svars = list(ERA5_SURFACE_VARIABLES)
    return levels, svars


def write_score_tables(csv_path: str, rmse_scores, acc_scores, cfg: PanguConfig):
    levels, svars = score_columns(cfg)
    save_error_scores(csv_path, rmse_scores, "rmse",
                      upper_levels=levels, surface_vars=svars)
    save_error_scores(csv_path, acc_scores, "acc",
                      upper_levels=levels, surface_vars=svars)


def _make_batch_scorer(cfg: PanguConfig, return_fields: bool) -> Callable:
    """(normalized model outputs, batch on the device, aux) -> score dict."""
    use_mask = cfg.train.use_custom_mask
    score_fields = make_field_scorer(cfg)

    @torch.inference_mode()
    def score(out_u, out_s, batch: Batch, aux: AuxConstants) -> Dict[str, torch.Tensor]:
        tgt_u_n, tgt_s_n = norm_data(batch.target_upper, batch.target_surface, aux)
        loss = weighted_l1_loss(
            out_u, out_s, tgt_u_n, tgt_s_n, aux,
            only_wind_speed=cfg.train.only_wind_speed_loss,
            mask=aux.custom_mask if use_mask else None,
        )
        # physical units for scoring (reference models/pangu_sample.py:479-480)
        out_u, out_s = norm_back_data(out_u, out_s, aux)
        # score EVERY batch sample (leading axis = batch): the reference only
        # ever runs this at batch 1, but a larger eval batch must not
        # silently drop samples 1..B-1
        out = {"loss": loss}
        out.update(score_fields(out_u, out_s, batch.target_upper, batch.target_surface, aux))
        if return_fields:
            out["output_upper"] = out_u
            out["output_surface"] = out_s
        return out

    return score


def make_score_step(model: nn.Module, cfg: PanguConfig,
                    return_fields: bool = False) -> Callable:
    """(batch, aux) -> score dict, the batch's tensors on the model's device;
    every score has a leading batch axis (one row per sample), ``loss`` is
    the batch-mean scalar.

    ``return_fields`` additionally returns the de-normalized predicted fields
    (for visualization)."""
    forward = make_forward(model)
    scorer = _make_batch_scorer(cfg, return_fields)

    def score(batch: Batch, aux: AuxConstants) -> Dict[str, torch.Tensor]:
        out_u, out_s = forward(batch.upper, batch.surface, aux)
        return scorer(out_u, out_s, batch, aux)

    return score


class Spans:
    """Wall seconds by span, summed over the loop; each mark waits for the
    device, so a span holds the work queued in it."""

    def __init__(self, totals: Optional[Dict[str, float]], device: torch.device):
        self.totals, self.device = totals, device
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.totals is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.totals[name] = self.totals.get(name, 0.0) + now - self.t
        self.t = now


def evaluate(
    model: nn.Module,
    loader: Iterable,
    aux: AuxConstants,
    cfg: PanguConfig,
    res_path: str,
    visualize: bool = False,
    logger=None,
    spans: Optional[Dict[str, float]] = None,
) -> float:
    """Run the full scoring pass; write rmse_*/acc_* CSVs; return mean loss.

    The model's weights and ``aux`` live on one device; batches move there.
    ``spans``, when given, gains the wall seconds of the loop's phases
    summed over the batches: ``load`` (waiting for the loader), ``h2d``,
    ``forecast`` (the model forward), ``score`` (loss, scores and their
    copy to the host) and, with ``visualize``, ``visualize``; each phase
    then waits for the device at its end."""
    device = model_device(model)
    forward = make_forward(model)
    scorer = _make_batch_scorer(cfg, return_fields=visualize)

    rmse_scores: Dict[str, Dict[str, np.ndarray]] = {f: {} for f in RMSE_FAMILIES}
    acc_scores: Dict[str, Dict[str, np.ndarray]] = {f: {} for f in ACC_FAMILIES}

    total_loss, n = 0.0, 0
    timer = Spans(spans, device)
    for host_batch, periods in loader:
        timer.mark("load")
        batch = Batch(*(to_device(x, device) for x in host_batch))
        timer.mark("h2d")
        out_u, out_s = forward(batch.upper, batch.surface, aux)
        timer.mark("forecast")
        out = {k: v.cpu().numpy() for k, v in scorer(out_u, out_s, batch, aux).items()}
        timer.mark("score")
        total_loss += float(out["loss"])
        n += 1
        # one score row PER SAMPLE, keyed by that sample's target time
        for i, (_, target_time) in enumerate(periods):
            for f in RMSE_FAMILIES:
                rmse_scores[f][target_time] = out[f"rmse_{f}"][i]
            for f in ACC_FAMILIES:
                acc_scores[f][target_time] = out[f"acc_{f}"][i]

        if visualize:
            from pangu_tpu_torch.eval import visualize as viz

            png_path = os.path.join(res_path, "png")
            names_u = (
                list(ERA5_UPPER_VARIABLES)
                if cfg.model.upper_vars == len(ERA5_UPPER_VARIABLES)
                else [str(i) for i in range(cfg.model.upper_vars)]
            )
            names_s = (
                list(ERA5_SURFACE_VARIABLES)
                if cfg.model.surface_vars == len(ERA5_SURFACE_VARIABLES)
                else [str(i) for i in range(cfg.model.surface_vars)]
            )
            viz.plot_upper(
                out["output_upper"][0], np.asarray(host_batch.target_upper[0]),
                np.asarray(host_batch.upper[0]), names_u[-1], cfg.model.levels // 2,
                periods[0][1], png_path, var_names=names_u,
            )
            viz.plot_surface(
                out["output_surface"][0], np.asarray(host_batch.target_surface[0]),
                np.asarray(host_batch.surface[0]), names_s[1], periods[0][1],
                png_path, var_names=names_s,
            )
            timer.mark("visualize")

    csv_path = os.path.join(res_path, "csv")
    write_score_tables(csv_path, rmse_scores, acc_scores, cfg)

    if n == 0:
        # a too-narrow test window (shorter than one horizon, so no sample
        # has a verifying target) silently read as a perfect 0.0 test loss
        msg = ("evaluate(): the test range produced ZERO scoreable samples "
               "(every sample needs a target one horizon ahead inside the "
               "range) — widen data.test_start/test_end")
        if logger:
            logger.warning(msg)
        else:
            logging.getLogger("pangu_tpu_torch.eval").warning(msg)
        return float("nan")

    mean_loss = total_loss / n
    if logger:
        logger.info("test_loss: %.6f", mean_loss)
    return mean_loss
