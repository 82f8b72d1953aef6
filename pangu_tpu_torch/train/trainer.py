"""Training engine (port of ``pangu_tpu/train/trainer.py``; reference
train(), models/pangu_sample.py:96-388).

Epoch loop with: the train step (accumulate and update, in place), the
per-epoch MultiStep LR (a function of Adam's update count, inside the
step), periodic checkpointing, validation with scalar logging, best-model
tracking on disk and early stopping.

The loader contract is any iterable of (Batch of numpy arrays, periods) with
``__len__``, as the port's loaders and plain lists in tests give. Batches move
to the model's device through pinned memory (``eval.evaluate.to_device``).

Under an active mesh (one process per card) each rank's loaders hold the
shard of the samples of its data coordinate (``make_loader(..., num_shards,
shard)``; the spatial peers of a data replica load the same samples and run
its slabs), the step averages over the data axis, and so does validation:
every rank holds the same train and validation losses, so early stopping and the loss brake decide
alike everywhere (a rank that broke out alone would leave the others
waiting in the next collective). Every rank joins each checkpoint save;
rank 0 writes it. Log lines, the writer and ``visualize`` (a mesh of one
rank at most) are rank 0's.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from pangu_tpu_torch.aux import AuxConstants
from pangu_tpu_torch.config import PanguConfig
from pangu_tpu_torch.eval.evaluate import Spans, model_device, to_device
from pangu_tpu_torch.parallel.mesh import active_mesh, is_main
from pangu_tpu_torch.parallel.sharding import all_reduce_mean, zero_shard_opt_state
from pangu_tpu_torch.train import checkpoint as ckpt
from pangu_tpu_torch.train.step import (
    Batch,
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from pangu_tpu_torch.utils.logger import get_logger


def sharded_val_stats(eval_step: Callable, val_loader: Iterable, aux: AuxConstants,
                      device: torch.device, count: int = 1,
                      last_batch_box: Optional[dict] = None) -> Tuple[float, int]:
    """(loss_sum, n_batches) over the validation set, one
    ``eval_step(batch, aux)`` per batch. With ``count`` > 1 data replicas (an
    active mesh) each rank's ``val_loader`` holds its data coordinate's
    wrap-padded shard (equal counts) and each batch's loss is averaged over
    the data axis: the
    mean over the global batch, as the JAX function's lockstep launch gives,
    the same sums on every rank. ``last_batch_box``, when given, receives
    the last host batch under key "batch" (the reference visualizes the
    last val batch, models/pangu_sample.py:332-358)."""
    loss_sum, n = 0.0, 0
    for host_batch, _periods in val_loader:
        batch = Batch(*(to_device(x, device) for x in host_batch))
        loss = eval_step(batch, aux)
        if count > 1:
            loss = all_reduce_mean(loss.clone())
        loss_sum += float(loss)
        n += 1
        if last_batch_box is not None:
            last_batch_box["batch"] = host_batch
    return loss_sum, n


def _global_val_loss(loss_sum: float, n: int) -> float:
    """Validation loss from the lockstep stats: every rank holds the same
    sums, so no gather."""
    return loss_sum / max(1, n)


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The drop-path and dropout generator of one epoch, seeded from (seed,
    epoch) and advanced by each step's draws: the masks are a function of
    (seed, epoch, step), so a run resumed at epoch N draws what an
    uninterrupted run draws at epoch N. It is the same on every rank of a
    mesh (drop path keeps the rank's rows of the global draw; dropout folds
    the rank into its seeds). (The bits differ from the JAX package's
    ``fold_in``/``split`` stream, which torch cannot reproduce.)"""
    mixed = int(np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device=device).manual_seed(mixed)


def init_train_state(model: nn.Module, cfg: PanguConfig, aux: AuxConstants,
                     optimizer: torch.optim.Optimizer,
                     params: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
    """A fresh train state over the model's parameters: ``params`` (a state
    dict), when given, is loaded into the model first; without it the model
    keeps its weights (the port's modules are built with theirs: seed them
    with ``interop.from_jax.init_params``). The optimizer's state is reset."""
    if params is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    optimizer.state.clear()
    return TrainState(dict(model.named_parameters()), optimizer)


class Trainer:
    """One engine for full finetuning AND parameter-efficient (LoRA) tuning:
    pass ``train_step_fn``/``eval_step_fn`` built over a different trainable
    tree (e.g. ``train.lora.make_lora_train_step``) and every feature --
    val / early-stop / best-model / checkpoint-resume -- applies to it, the way
    the reference routes LoRA through the same train() engine
    (finetune/lora_tune.py:250 -> models/pangu_sample.py:278-381)."""

    def __init__(
        self,
        cfg: PanguConfig,
        model: nn.Module,
        aux: AuxConstants,
        out_dir: str,
        writer=None,
        logger=None,
        steps_per_epoch: int = 1,
        profile_dir: Optional[str] = None,
        train_step_fn: Optional[Callable] = None,
        eval_step_fn: Optional[Callable] = None,
        optimizer: Optional[torch.optim.Optimizer] = None,
        visualize: bool = False,
    ):
        """``optimizer`` defaults to Adam over the model's parameters,
        sharded by ``zero_shard_opt_state`` under an active mesh when
        ``cfg.parallel.zero_opt_state``; a LoRA run passes its own over the
        trainable tree (plain, so its adapters train replicated). ``train_step_fn``
        is a builder ``optimizer -> step(batch, aux, generator) -> loss``
        (so a custom trainable tree shares the Trainer's optimizer);
        ``eval_step_fn`` is the eval step itself, ``(batch, aux) -> loss``.
        ``visualize`` renders the reference's val-time triptych PNGs
        (pangu_sample.py:332-358) of the last validation batch into
        ``{out_dir}/png_training`` after every validation pass (matplotlib
        is imported only then). ``profile_dir``: the first epoch of ``fit``
        runs under ``torch.profiler``, its trace written there."""
        self.profile_dir = profile_dir
        self.visualize = visualize
        self.cfg = cfg
        self.model = model
        self.aux = aux
        self.device = model_device(model)
        self.out_dir = out_dir
        self.writer = writer
        self.logger = logger or get_logger("pangu_tpu_torch.train")
        self.mesh = active_mesh()
        # data replicas: the validation losses average over the data axis
        self.count = self.mesh.data if self.mesh is not None else 1
        self.is_main = is_main()
        if optimizer is None:
            optimizer = make_optimizer(model, cfg)
            if self.mesh is not None:
                optimizer = zero_shard_opt_state(optimizer, self.mesh, cfg.parallel.zero_opt_state)
        self.optimizer = optimizer
        self.train_step = (train_step_fn(self.optimizer) if train_step_fn
                           else make_train_step(model, cfg, self.optimizer, steps_per_epoch))
        self.eval_step = eval_step_fn or make_eval_step(model, cfg)
        self._forecast = None  # the visualization's forecast step, built once

    # ------------------------------------------------------------------
    def fit(
        self,
        train_loader: Iterable,
        val_loader: Optional[Iterable] = None,
        start_epoch: int = 1,
        state: Optional[TrainState] = None,
        spans: Optional[Dict[str, float]] = None,
    ) -> Tuple[Dict[str, torch.Tensor], TrainState]:
        """Returns (best_params, final_state); the best params are new
        tensors read back from ``best/``, the final state's are the live ones.
        ``spans``, when given, gains the wall seconds of the train loop's
        phases summed over its batches: ``load`` (waiting for the loader),
        ``h2d`` and ``step``, and of the train-state checkpoints, ``save``;
        each phase then waits for the device at its end (which also makes the
        loss brake below read each step at once)."""
        cfg = self.cfg
        if state is None:
            state = init_train_state(self.model, cfg, self.aux, self.optimizer)

        best_loss = float("inf")
        # The best params live on DISK (the `best` checkpoint), not as a
        # device copy: a full clone would pin ~1.1 GB at flagship f32 on top
        # of params and moments. They are restored once, after the loop.
        have_best = False
        stale_epochs = 0

        bad_steps = 0
        for epoch in range(start_epoch, cfg.train.epochs + 1):
            # Pin the shuffle schedule to the trainer's epoch number, so a
            # RESUMED run continues the sample-order sequence.
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            # The drop-path / dropout stream is a function of (seed, epoch,
            # step), not of how many epochs this process has run.
            gen = epoch_generator(cfg.train.seed, epoch, self.device)
            profiler = None
            if self.profile_dir and epoch == start_epoch:
                profiler = self._start_profile()
            t0 = time.time()
            epoch_loss, n_batches = 0.0, 0

            def consume(device_loss, step_no):
                # failure brake: a non-finite loss poisons the params
                # irrecoverably -- fail fast with a pointer to the last good
                # checkpoint instead of training garbage.
                nonlocal epoch_loss, bad_steps
                lf = float(device_loss)
                if not math.isfinite(lf):
                    bad_steps += 1
                    self._log("non-finite loss at epoch %d step %d", epoch, step_no,
                              level="warning")
                    if bad_steps >= 3:
                        raise FloatingPointError(
                            f"training diverged (non-finite loss x{bad_steps}); "
                            f"resume from the last checkpoint under {self.out_dir}/models")
                else:
                    bad_steps = 0
                epoch_loss += lf

            # loss.item() of step i runs only AFTER step i+1 is dispatched, so
            # the card never idles waiting on the brake check (the brake
            # fires at most one step late)
            pending = None
            timer = Spans(spans, self.device)
            for host_batch, _periods in train_loader:
                timer.mark("load")
                batch = Batch(*(to_device(x, self.device) for x in host_batch))
                timer.mark("h2d")
                loss = self.train_step(batch, self.aux, gen)
                timer.mark("step")
                if pending is not None:
                    consume(pending, n_batches - 1)
                pending = loss
                n_batches += 1
            if pending is not None:
                consume(pending, n_batches - 1)
            epoch_loss /= max(1, n_batches)
            self._log("Epoch %d: loss=%.6f, time=%.3f", epoch, epoch_loss, time.time() - t0)
            if profiler is not None:
                self._stop_profile(profiler, epoch)

            if epoch % cfg.train.save_interval == 0:
                # every rank joins: the sharded moments are gathered for rank 0 to write
                saving = Spans(spans, self.device)
                ckpt.save_train_state(f"{self.out_dir}/models", epoch, state)
                saving.mark("save")

            if val_loader is not None and epoch % cfg.train.val_interval == 0:
                viz_box = ({} if self.visualize and (self.mesh is None or self.mesh.size == 1)
                           else None)
                loss_sum, n_val = sharded_val_stats(self.eval_step, val_loader, self.aux,
                                                    self.device, self.count,
                                                    last_batch_box=viz_box)
                val_loss = _global_val_loss(loss_sum, n_val)
                self._log("Validate at Epoch %d : %.6f", epoch, val_loss)
                if viz_box is not None and viz_box.get("batch") is not None and self.is_main:
                    self._visualize_val(viz_box["batch"], epoch)
                if self.writer is not None and self.is_main:
                    self.writer.add_scalars("Loss", {"train": epoch_loss, "val": val_loss},
                                            epoch)
                if val_loss < best_loss:
                    best_loss = val_loss
                    ckpt.save_params(f"{self.out_dir}/models", state.params, "best")
                    have_best = True
                    self._log("current best model is saved at %d epoch.", epoch)
                    stale_epochs = 0
                else:
                    stale_epochs += 1
                    if stale_epochs >= cfg.train.early_stop:
                        self._log("No improvement in validation loss for %d epochs, "
                                  "terminating training.", stale_epochs)
                        break

        if not have_best:
            return state.params, state
        best_params = ckpt.restore_params(f"{self.out_dir}/models", state.params, "best")
        return best_params, state

    def _log(self, msg: str, *args, level: str = "info") -> None:
        """A log line of rank 0."""
        if self.is_main:
            getattr(self.logger, level)(msg, *args)

    # ------------------------------------------------------------------
    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler, epoch: int) -> None:
        profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        rank = "" if self.mesh is None else f".rank{self.mesh.rank}"  # the global rank
        path = os.path.join(self.profile_dir, f"epoch_{epoch}{rank}.trace.json")
        profiler.export_chrome_trace(path)
        self._log("profile written to %s", path)

    # ------------------------------------------------------------------
    def _visualize_val(self, batch: Batch, epoch: int) -> None:
        """Reference val-time triptychs (models/pangu_sample.py:332-358):
        de-normalized prediction vs ground truth vs input for upper 'u' at
        level 12 and surface 'msl', PNGs under {out_dir}/png_training keyed
        by epoch. ``batch`` is the host batch. The forecast step is built on
        the first call and kept. Failures degrade to a warning -- a plot must
        never kill a training run."""
        try:
            from pangu_tpu_torch.config import ERA5_SURFACE_VARIABLES, ERA5_UPPER_VARIABLES
            from pangu_tpu_torch.eval.visualize import plot_surface, plot_upper
            from pangu_tpu_torch.rollout.autoregressive import make_forecast_step

            u_in, s_in, t_u, t_s = (np.asarray(a) for a in batch)
            if u_in.ndim == 6:  # leading grad-accumulation microbatch axis
                u_in, s_in, t_u, t_s = u_in[0], s_in[0], t_u[0], t_s[0]
            if self._forecast is None:
                self._forecast = make_forecast_step(self.model, self.aux)
            out_u, out_s = self._forecast(to_device(u_in, self.device),
                                          to_device(s_in, self.device))
            out_u, out_s = out_u.float().cpu().numpy(), out_s.float().cpu().numpy()

            m = self.cfg.model
            up_names = [ERA5_UPPER_VARIABLES[i] if i < len(ERA5_UPPER_VARIABLES) else f"u{i}"
                        for i in range(m.upper_vars)]
            sf_names = [ERA5_SURFACE_VARIABLES[i] if i < len(ERA5_SURFACE_VARIABLES)
                        else f"s{i}" for i in range(m.surface_vars)]
            png = os.path.join(self.out_dir, "png_training")
            plot_upper(out_u[0], t_u[0], u_in[0], var="u" if "u" in up_names else up_names[0],
                       level=min(12, m.levels - 1), step=epoch, path=png,
                       var_names=up_names)
            plot_surface(out_s[0], t_s[0], s_in[0],
                         var="msl" if "msl" in sf_names else sf_names[0],
                         step=epoch, path=png, var_names=sf_names)
        except Exception as e:  # noqa: BLE001 -- viz is best-effort
            self.logger.warning("val-time visualization failed at epoch %d: %s: %s",
                                epoch, type(e).__name__, e, exc_info=True)

    # ------------------------------------------------------------------
    def resume(self, epoch: Optional[int] = None,
               template: Optional[TrainState] = None) -> Tuple[TrainState, int]:
        """Restore a train_{epoch} checkpoint (latest if epoch is None) into
        ``template`` (default: the model's parameters and the Trainer's
        optimizer); returns (state, the epoch to start at).

        ``template`` supplies the trainable tensors when they are not the
        model's parameters (e.g. a LoRA tree)."""
        d = f"{self.out_dir}/models"
        epoch = epoch if epoch is not None else ckpt.latest_epoch(d)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {d}")
        if template is None:
            template = init_train_state(self.model, self.cfg, self.aux, self.optimizer)
        state, saved_epoch = ckpt.restore_train_state(d, epoch, template)
        return state, saved_epoch + 1
