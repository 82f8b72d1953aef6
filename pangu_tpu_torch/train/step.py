"""Train and eval steps (port of ``pangu_tpu/train/step.py``).

The optimizer is ``torch.optim.Adam(lr, weight_decay=wd)``: L2 decay added
to the gradient before the moments and eps outside the square root, which
is optax's ``add_decayed_weights -> scale_by_adam -> scale_by_learning_rate``
(not AdamW). The LR follows ``multistep_lr`` of the optimizer's own step
count, set before every update, as optax indexes its schedule by the
update count. Gradient accumulation runs the microbatches of a leading axis
one after the other and averages loss and gradients before the one update.

The JAX step's ZeRO sharding constraints have no counterpart on one card.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from pangu_tpu_torch.config import PanguConfig
from pangu_tpu_torch.aux import AuxConstants, norm_data
from pangu_tpu_torch.model.pangu import check_kernel_widths
from pangu_tpu_torch.train.loss import weighted_l1_loss
from pangu_tpu_torch.train.schedule import multistep_lr


class Batch(NamedTuple):
    """One training sample pair in physical units.

    upper: (B, Vu, L, lat, lon); surface: (B, Vs, lat, lon); targets same.
    With gradient accumulation, a leading microbatch axis (A, B, ...) is added.
    """

    upper: torch.Tensor
    surface: torch.Tensor
    target_upper: torch.Tensor
    target_surface: torch.Tensor


class TrainState(NamedTuple):
    """What a train step updates, in place: the trainable tensors by name
    (``model.named_parameters()`` for full finetuning, the flattened LoRA
    tree for LoRA) and the optimizer over them, whose Adam state holds the
    moments and the update count ``step`` the LR schedule reads."""

    params: Dict[str, torch.Tensor]
    opt_state: torch.optim.Optimizer

    @property
    def step(self) -> int:
        return optimizer_step_count(self.opt_state)


def make_optimizer(params: Union[nn.Module, Iterable[torch.Tensor]],
                   cfg: PanguConfig) -> torch.optim.Adam:
    """Adam with coupled L2 weight decay over the trainable tensors: every
    parameter of a module that requires a gradient, or the tensors given."""
    if isinstance(params, nn.Module):
        params = [p for p in params.parameters() if p.requires_grad]
    return torch.optim.Adam(params, lr=cfg.train.lr, weight_decay=cfg.train.weight_decay)


def optimizer_step_count(optimizer: torch.optim.Optimizer) -> int:
    """Updates taken so far (Adam's per-parameter ``step``; 0 before the first)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:
                return int(state["step"])
    return 0


def loss_fn(model: nn.Module, batch: Batch, aux: AuxConstants, cfg: PanguConfig,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The loss of one batch, in the model's current mode; ``generator``
    draws the drop paths and dropout masks in training."""
    out_u, out_s = model(batch.upper, batch.surface, aux, generator)
    tgt_u, tgt_s = norm_data(batch.target_upper, batch.target_surface, aux)
    mask = aux.custom_mask if cfg.train.use_custom_mask else None
    return weighted_l1_loss(out_u, out_s, tgt_u, tgt_s, aux,
                            only_wind_speed=cfg.train.only_wind_speed_loss, mask=mask)


def make_train_step(model: nn.Module, cfg: PanguConfig, optimizer: torch.optim.Optimizer,
                    steps_per_epoch: int = 1) -> Callable[..., torch.Tensor]:
    """Returns ``step(batch, aux, generator=None) -> loss``: one optimizer
    update in place, the gradients it used left in ``.grad``.

    If ``cfg.train.accumulation_steps > 1`` the batch carries a leading
    microbatch axis of that length; loss and gradients are averaged over it.
    On the card it first checks that the kernels take the model's widths
    (``check_kernel_widths``).
    """
    if next(model.parameters()).is_cuda:
        check_kernel_widths(cfg.model)
    if cfg.model.grads_dtype != "float32":
        raise NotImplementedError(f"grads_dtype={cfg.model.grads_dtype!r} is not ported")
    accum = cfg.train.accumulation_steps
    schedule = multistep_lr(cfg.train.lr, cfg.train.lr_milestones, cfg.train.lr_gamma,
                            steps_per_epoch)

    def step(batch: Batch, aux: AuxConstants,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        micro = [batch] if accum == 1 else [Batch(*(t[i] for t in batch)) for i in range(accum)]
        loss_sum = torch.zeros((), device=batch.upper.device)
        for mb in micro:
            loss = loss_fn(model, mb, aux, cfg, generator)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        if accum > 1:
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.div_(accum)
        lr = schedule(optimizer_step_count(optimizer))
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        return loss_sum / accum

    return step


def make_eval_step(model: nn.Module, cfg: PanguConfig) -> Callable[[Batch, AuxConstants],
                                                                   torch.Tensor]:
    """Returns ``eval(batch, aux) -> loss``: the model in eval mode, no grad."""

    @torch.no_grad()
    def step(batch: Batch, aux: AuxConstants) -> torch.Tensor:
        model.eval()
        return loss_fn(model, batch, aux, cfg)

    return step


def make_forward(model: nn.Module) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """Returns the normalized-space forward ``(upper, surface, aux) ->
    (out_upper, out_surface)``, eval mode, under ``torch.inference_mode``."""

    @torch.inference_mode()
    def forward(upper: torch.Tensor, surface: torch.Tensor, aux: AuxConstants):
        model.eval()
        return model(upper, surface, aux)

    return forward
