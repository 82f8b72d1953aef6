"""Rollout inference engines (port of ``pangu_tpu/rollout/engines.py``;
reference inference/*.py family).

Engines:
  * ``single_output_eval``   — single-model horizon forecast over a test
    range, one CSV set (reference inference_singleOutput.py).
  * ``multi_output_rollout`` — N-day autoregressive rollout from 00Z starts,
    every frame scored against re-fetched ground truth, per-init-time CSV
    dirs (reference inference_multiOutput.py). A ``choose_horizon`` rule
    generalizes the hour-based model mixing of the mix24 variants
    (inference_multiOutput-{3,6}-mix24.py): each specialized model keeps its
    own input chain, the base chain absorbs every emitted frame.
  * ``hierarchical_forecast`` — the paper's greedy horizon decomposition:
    fill hours 24..48 with the 24h -> 6h -> 3h -> 1h models, each step
    starting from the latest stored prediction (inference_iterative.py:145-200),
    with optional compressed on-disk spill of intermediate frames.

Every forecast goes through the port's ``make_forecast_step``: on the card,
a bf16 model with ``use_pallas_attention`` runs the block kernel. A bundle's
weights and aux constants live on its model's device; fields read from a
store move there before a step and scores come back as numpy.
"""

from __future__ import annotations

import logging
import os
from collections.abc import Mapping
from dataclasses import dataclass
from datetime import datetime, timedelta
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from pangu_tpu_torch.aux import AuxConstants
from pangu_tpu_torch.config import PanguConfig
from pangu_tpu_torch.eval.evaluate import (
    ACC_FAMILIES,
    RMSE_FAMILIES,
    make_field_scorer,
    model_device,
    to_device,
    write_score_tables,
)
from pangu_tpu_torch.rollout.autoregressive import make_forecast_step

_log = logging.getLogger("pangu_tpu_torch.rollout")


@dataclass
class ModelBundle:
    """One horizon model: the model with its weights, its aux constants (the
    reference keys ONNX sessions and constantMask{h} files by horizon), both
    on the model's device, and the horizon in hours."""

    model: nn.Module
    aux: AuxConstants
    horizon: int

    @property
    def device(self) -> torch.device:
        return model_device(self.model)

    def forecast_step(self):
        if not hasattr(self, "_step"):
            self._step = make_forecast_step(self.model, self.aux)
        return self._step

    def step(self, upper, surface):
        """One forecast step from numpy arrays or tensors, on the model's device."""
        return self.forecast_step()(to_device(upper, self.device),
                                    to_device(surface, self.device))


def _warn_lead_time_quirk(steps: int, horizon: int) -> None:
    """Warn when the reference's lead-time mislabeling is selected: with
    ``test_freq < horizon`` (steps > 1) every scored frame is recorded under
    the dataset's t+{horizon}h label while its physical lead is
    steps x horizon hours (reference inference_singleOutput.py:135-153
    proceeds silently)."""
    if steps > 1:
        _log.warning(
            "lead-time quirk: %d applications of the %dh model advance the "
            "state %dh, but scores are recorded under the t+%dh label "
            "(reference inference_singleOutput.py:135-153 bookkeeping, "
            "preserved for parity). Use test_freq == horizon for "
            "physically-labeled scores.",
            steps, horizon, steps * horizon, horizon,
        )


def _new_score_dicts():
    return (
        {f: {} for f in RMSE_FAMILIES},
        {f: {} for f in ACC_FAMILIES},
    )


def _record(rmse_scores, acc_scores, scores, key: str, i: Optional[int] = None):
    """Store one sample's scores (row ``i`` of batched scores) under ``key``."""
    def row(name):
        v = scores[name] if i is None else scores[name][i]
        return v.cpu().numpy()

    for f in RMSE_FAMILIES:
        rmse_scores[f][key] = row(f"rmse_{f}")
    for f in ACC_FAMILIES:
        acc_scores[f][key] = row(f"acc_{f}")


def _score(scorer, bundle: ModelBundle, u, s, gt_upper, gt_surface, aux: AuxConstants):
    dev = bundle.device
    return scorer(to_device(u, dev), to_device(s, dev), to_device(gt_upper, dev),
                  to_device(gt_surface, dev), aux)


def single_output_eval(
    bundle: ModelBundle,
    loader,
    cfg: PanguConfig,
    res_path: str,
    steps: int = 1,
) -> None:
    """Forecast each test sample with ``steps`` autoregressive applications
    of one model and score the final frame; one CSV set for the run.

    ``steps`` reproduces the reference's time bookkeeping EXACTLY
    (inference_singleOutput.py:135-153): ``spaces = horizon // test_freq``
    applications of the horizon model, scored against the dataset's
    ``t + horizon`` target. Note the reference quirk this preserves: when
    ``test_freq < horizon`` the model still advances ``horizon`` hours per
    application, so the final frame's physical lead is
    ``steps * horizon``. Use ``test_freq == horizon`` (1 step) for
    physically-labeled scores. Selecting the misleading configuration logs a
    loud warning — the reference proceeds silently."""
    _warn_lead_time_quirk(steps, bundle.horizon)
    scorer = make_field_scorer(cfg)
    rmse_scores, acc_scores = _new_score_dicts()

    for batch, periods in loader:
        u, s = batch.upper, batch.surface
        for _ in range(steps):
            u, s = bundle.step(u, s)
        # score EVERY sample of the batch (the reference only ever runs
        # batch 1 here; with a larger loader batch, scoring only element 0
        # would silently drop the rest)
        scores = _score(scorer, bundle, u, s, batch.target_upper, batch.target_surface,
                        bundle.aux)
        for i, (_, target_time) in enumerate(periods):
            _record(rmse_scores, acc_scores, scores, target_time, i)

    write_score_tables(os.path.join(res_path, "csv"), rmse_scores, acc_scores, cfg)


def multi_output_rollout(
    bundles: Dict[int, ModelBundle],
    dataset,
    cfg: PanguConfig,
    res_path: str,
    base_horizon: int,
    lead_days: int = 10,
    choose_horizon: Optional[Callable[[datetime], int]] = None,
    starts_at_hour: int = 0,
    score_bundle: Optional[ModelBundle] = None,
) -> None:
    """N-day rollout from each ``starts_at_hour``Z init in the dataset.

    ``choose_horizon(current_time)`` picks which model advances this step
    (default: always the base model). Per-init-time CSV directories under
    ``res_path/<init_time>/csv`` (reference inference_multiOutput.py:320-327).

    ``score_bundle`` evaluates a *different* model side-by-side: the chain
    state is driven by ``bundles`` while each step's scored output comes from
    ``score_bundle`` applied to the same input (reference
    inference_mix_multiOutput.py:211-216,239-240 — pretrained ONNX drives,
    the finetuned model is what gets scored).
    """
    choose_horizon = choose_horizon or (lambda t: base_horizon)
    scorer = make_field_scorer(cfg)
    base = bundles[base_horizon]
    spaces = lead_days * 24 // base_horizon
    key_set = set(dataset.keys)
    last_key = max(dataset.keys)

    for idx in range(len(dataset)):
        # decide BEFORE touching the store: dataset[idx] would also load
        # the t+horizon target pair (~300 MB at flagship geometry) that a
        # rollout never uses — and pay it even for skipped non-00Z inits
        init_time = dataset.keys[idx]
        init_str = init_time.strftime("%Y%m%d%H")
        if init_time.hour != starts_at_hour:
            continue
        if init_time + timedelta(hours=base_horizon * spaces) > last_key:
            # the full rollout window runs past the test range: no ground
            # truth to score against — skip the init loudly rather than emit
            # a truncated CSV dir.
            _log.warning(
                "init %s skipped: %d-day rollout extends past test range end %s",
                init_str, lead_days, last_key.strftime("%Y%m%d%H"),
            )
            continue

        upper, surface = dataset.store.load(init_time)
        upper, surface = to_device(upper[None], base.device), to_device(surface[None], base.device)
        # per-model input chains (reference mix24 state logic,
        # inference_multiOutput-3-mix24.py:164-165,183-203). Preserved
        # reference quirk: a specialized chain advances ONLY when its model
        # is selected and never absorbs the others' frames (only the base
        # chain does) — e.g. with base 3h, the 6h chain's frame at +30h is
        # physically +24h; the base chain inherits that lag for the rest of
        # the rollout, exactly as the reference does.
        chains: Dict[int, Tuple] = {h: (upper, surface) for h in bundles}

        rmse_scores, acc_scores = _new_score_dicts()
        for space in range(spaces):
            current = init_time + timedelta(hours=base_horizon * (space + 1))
            h = choose_horizon(current)
            b = bundles[h]
            u_in, s_in = chains[h]
            u_out, s_out = b.step(u_in, s_in)
            chains[h] = (u_out, s_out)
            if h != base_horizon:
                chains[base_horizon] = (u_out, s_out)

            if score_bundle is not None:
                u_sc, s_sc = score_bundle.step(u_in, s_in)
            else:
                u_sc, s_sc = u_out, s_out

            # re-fetch ground truth at `current` from the dataset — the
            # predicted frame and the dataset key must line up exactly
            # (reference time-alignment assert, inference_multiOutput.py:197)
            if current not in key_set:
                raise ValueError(
                    f"rollout frame {current:%Y%m%d%H} has no ground truth in "
                    f"the test range ({min(dataset.keys):%Y%m%d%H}.."
                    f"{last_key:%Y%m%d%H} @ {dataset.freq}): the dataset "
                    f"frequency ({dataset.freq}h) must divide the frame "
                    f"cadence (base horizon {base_horizon}h)"
                )
            gt_upper, gt_surface = dataset.store.load(current)
            # score with the SCORED model's aux: ACC anomalies subtract its
            # climatological mean, which may differ from the driving
            # bundle's (e.g. a finetuned model with rebuilt statistics)
            sb = score_bundle if score_bundle is not None else b
            scores = _score(scorer, sb, u_sc[0], s_sc[0], gt_upper, gt_surface, sb.aux)
            _record(rmse_scores, acc_scores, scores, current.strftime("%Y%m%d%H"))

        csv_dir = os.path.join(res_path, init_str, "csv")
        write_score_tables(csv_dir, rmse_scores, acc_scores, cfg)


def mix24_rule(base_horizon: int) -> Callable[[datetime], int]:
    """Hour-based model selection of the mix24 variants: 00Z -> 24h model;
    (3h base) 06/12/18Z -> 6h model; otherwise the base model."""

    def rule(t: datetime) -> int:
        if t.hour == 0:
            return 24
        if base_horizon == 3 and t.hour in (6, 12, 18):
            return 6
        return base_horizon

    return rule


def hierarchical_forecast(
    bundles: Dict[int, ModelBundle],
    init_time: datetime,
    upper: np.ndarray,
    surface: np.ndarray,
    spill_dir: Optional[str] = None,
    hours: Tuple[int, int] = (24, 48),
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Greedy horizon decomposition for hours 24..48
    (reference inference_iterative.py:145-200):

      24h model -> hours 24/48; 6h -> 30/36/42; 3h -> 27/33/39/45;
      1h -> the rest; each hour is filled from the latest prediction whose
      gap the model bridges exactly. Hour 0 is the (given) analysis state.
      Deliberate divergence: the reference hardcodes hour 48 to the 6h
      model (inference_iterative.py:159) — four 6h applications on top of
      the hour-24 frame; the greedy ladder reaches it with one more 24h
      application (fewer error-accumulating steps). Missing bundles are
      tolerated: shorter models chain as many exact applications as the
      gap needs instead of mislabeling a single application.

    Returns a {hour: (upper, surface)} Mapping of numpy frames. With
    ``spill_dir``, frames live as compressed .npz on disk (reference
    save/load_prediction, inference_iterative.py:95-128) and the mapping
    loads each hour LAZILY on access — iterating scores one frame in memory
    at a time instead of pulling the whole ladder back at once.
    """
    lo, hi = hours
    # normalize shapes at the boundary: frames are stored un-batched
    upper, surface = np.asarray(upper), np.asarray(surface)
    if upper.ndim == 5:
        upper = upper[0]
    if surface.ndim == 4:
        surface = surface[0]
    preds: Dict[int, object] = {0: (upper, surface)}

    def store(h: int, u, s):
        if spill_dir:
            t = init_time + timedelta(hours=h)
            date_dir = os.path.join(spill_dir, t.strftime("%Y%m%d"))
            os.makedirs(date_dir, exist_ok=True)
            path = os.path.join(date_dir, t.strftime("%Y%m%d_%H") + ".npz")
            np.savez_compressed(path, output=u, output_surface=s, hour=h)
            preds[h] = path
        else:
            preds[h] = (u, s)

    def load(h: int):
        item = preds[h]
        if isinstance(item, str):
            data = np.load(item)
            return data["output"], data["output_surface"]
        return item

    def run(model_h: int, target_hours: Sequence[int]):
        if model_h not in bundles:
            return
        b = bundles[model_h]
        for h in target_hours:
            if h in preds:
                continue
            # start only from states whose gap to h the model bridges
            # EXACTLY, chaining applications when the gap is a multiple
            # (the reference applies once from max(x <= h - model_h),
            # inference_iterative.py:163-177 — with its fixed 24/6/3/1
            # bundle set the gap is always exactly one application, but a
            # missing bundle would make the single application store a
            # physically earlier frame under label h)
            cands = [x for x in preds
                     if x <= h - model_h and (h - x) % model_h == 0]
            if not cands:
                continue  # a shorter-horizon model may still fill h
            cur = max(cands)
            u_in, s_in = load(cur)
            while cur < h:
                u, s = b.step(u_in[None], s_in[None])
                cur += model_h
                u_in, s_in = u[0].cpu().numpy(), s[0].cpu().numpy()
                store(cur, u_in, s_in)

    run(24, [h for h in range(lo, hi + 1) if h % 24 == 0])
    run(6, [h for h in range(lo, hi + 1) if h % 6 == 0])
    run(3, [h for h in range(lo, hi + 1) if h % 3 == 0])
    if 1 in bundles:
        run(1, list(range(lo, hi + 1)))

    # LAZY mapping: spilled frames stay on disk until the consumer asks
    # for that hour (eagerly np.load-ing every frame here would pull the
    # whole ~GB-scale ladder back into host memory at once and defeat the
    # spill). In-memory entries pass through unchanged.
    return _FrameMap({h: preds[h] for h in sorted(preds) if lo <= h <= hi})


class _FrameMap(Mapping):
    """{hour: (upper, surface)} view over mixed in-memory frames and
    spilled .npz paths; paths load on access, one frame at a time."""

    def __init__(self, entries: Dict[int, object]):
        self._entries = entries

    def __getitem__(self, h: int):
        item = self._entries[h]
        if isinstance(item, str):
            data = np.load(item)
            return data["output"], data["output_surface"]
        return item

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)


def iterative_eval(
    bundles: Dict[int, ModelBundle],
    dataset,
    cfg: PanguConfig,
    res_path: str,
    hours: Tuple[int, int] = (24, 48),
    starts_at_hour: int = 0,
    spill_dir: Optional[str] = None,
) -> None:
    """Run the greedy ladder from every qualifying init in the dataset and
    score each produced hour against ground truth; per-init-time CSV dirs
    (the scoring role the reference leaves to the per-frame CSVs of
    inference_multiOutput.py, applied to the inference_iterative.py ladder).

    Frames are scored at every hour the dataset can verify; hours the ladder
    produced but the test range has no key for (e.g. hourly frames against a
    24h-cadence dataset) are reported once per run, not silently dropped.
    """
    scorer = make_field_scorer(cfg)
    key_set = set(dataset.keys)
    last_key = max(dataset.keys)
    lo, hi = hours
    unverifiable: set = set()
    n_inits = 0
    # one scoring bundle for the whole run (statistics/climatology are
    # shared across horizon models; reference scores with the single
    # cfg-level statistics)
    sb = bundles[max(bundles)]

    for idx in range(len(dataset)):
        # same reasoning as multi_output_rollout: never load the unused
        # t+horizon target pair, and skip non-qualifying inits before
        # touching the store at all
        init_time = dataset.keys[idx]
        init_str = init_time.strftime("%Y%m%d%H")
        if init_time.hour != starts_at_hour:
            continue
        if init_time + timedelta(hours=hi) > last_key:
            _log.warning(
                "init %s skipped: ladder window +%dh extends past test "
                "range end %s", init_str, hi, last_key.strftime("%Y%m%d%H"),
            )
            continue
        n_inits += 1

        upper, surface = dataset.store.load(init_time)
        preds = hierarchical_forecast(
            bundles, init_time, upper, surface,
            spill_dir=os.path.join(spill_dir, init_str) if spill_dir else None,
            hours=hours,
        )

        rmse_scores, acc_scores = _new_score_dicts()
        scored = 0
        for h, (u, s) in preds.items():
            current = init_time + timedelta(hours=h)
            if current not in key_set:
                unverifiable.add(h)
                continue
            gt_upper, gt_surface = dataset.store.load(current)
            scores = _score(scorer, sb, u, s, gt_upper, gt_surface, sb.aux)
            _record(rmse_scores, acc_scores, scores, current.strftime("%Y%m%d%H"))
            scored += 1
        if scored == 0:
            raise ValueError(
                f"no ladder frame of init {init_str} aligns with a dataset "
                f"key ({dataset.freq} cadence): nothing to score"
            )
        write_score_tables(os.path.join(res_path, init_str, "csv"),
                           rmse_scores, acc_scores, cfg)

    if unverifiable:
        _log.warning(
            "ladder hours %s have no ground truth at the %s test cadence and "
            "were not scored", sorted(unverifiable), dataset.freq,
        )
    if n_inits == 0:
        raise ValueError("no qualifying init times in the test range")
