"""Train and eval steps (port of ``pangu_tpu/train/step.py``).

The optimizer is ``torch.optim.Adam(lr, weight_decay=wd)``: L2 decay added
to the gradient before the moments and eps outside the square root, which
is optax's ``add_decayed_weights -> scale_by_adam -> scale_by_learning_rate``
(not AdamW). The LR follows ``multistep_lr`` of the optimizer's own step
count, set before every update, as optax indexes its schedule by the
update count. Gradient accumulation runs the microbatches of a leading axis
one after the other and averages loss and gradients before the one update.

Under an active mesh (``parallel.activate_mesh``) each rank holds its rows
of the global batch and the step averages the gradients over the ranks, in
one of the JAX step's three modes (``pangu_tpu/train/step.py:127-138``):
with a ``parallel.sharding.ShardedOptimizer`` (``zero_shard_opt_state``, as
the Trainer builds it when ``cfg.parallel.zero_opt_state``), ZeRO-2 when
``cfg.parallel.zero_gradients`` (reduce-scatter, update of the rank's
shards, all-gather), else ZeRO-1 (all-reduce, the sharded update,
all-gather); with a plain optimizer, plain DP (all-reduce, the full update
on every rank), which is also how replicated LoRA adapters train. The loss
returned is the mean over the data axis, the same value on every rank.

Under a mesh with a lat x lon plane the step first sums over the plane the
gradients of the tensors the layers use on their slabs (``spatial_reduce``
of ``model.blocks.slab_tensors``: blocks, their adapters, the earth biases;
each rank's is a partial sum over its slab); the tensors used on the whole
grid (embedding, joints, recovery, the LoRA heads) already hold the whole
gradient, the same on every spatial peer, and are not reduced. Then the
data axis runs one of the three modes over the data group.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from pangu_tpu_torch.config import PanguConfig
from pangu_tpu_torch.aux import AuxConstants, norm_data
from pangu_tpu_torch.model.blocks import slab_tensors
from pangu_tpu_torch.model.pangu import check_kernel_widths
from pangu_tpu_torch.parallel.mesh import active_mesh
from pangu_tpu_torch.parallel.sharding import (ShardedOptimizer, all_reduce_mean, local_shard,
                                               replicate_constraint, spatial_reduce, trainable,
                                               zero_constraint)
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


def output_loss(out_u: torch.Tensor, out_s: torch.Tensor, target_upper: torch.Tensor,
                target_surface: torch.Tensor, aux: AuxConstants,
                cfg: PanguConfig) -> torch.Tensor:
    """The weighted L1 loss of normalized outputs against physical targets."""
    tgt_u, tgt_s = norm_data(target_upper, target_surface, aux)
    mask = aux.custom_mask if cfg.train.use_custom_mask else None
    return weighted_l1_loss(out_u, out_s, tgt_u, tgt_s, aux,
                            only_wind_speed=cfg.train.only_wind_speed_loss, mask=mask)


def loss_fn(model: nn.Module, batch: Batch, aux: AuxConstants, cfg: PanguConfig,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The loss of one batch, in the model's current mode; ``generator``
    draws the drop paths and dropout masks in training."""
    out_u, out_s = model(batch.upper, batch.surface, aux, generator)
    return output_loss(out_u, out_s, batch.target_upper, batch.target_surface, aux, cfg)


def set_scheduled_lr(optimizer, schedule: Callable[[int], float]) -> None:
    """Set the LR the schedule gives at the optimizer's update count, before
    the update (optax indexes its schedule by the update count)."""
    lr = schedule(optimizer_step_count(optimizer))
    for group in optimizer.param_groups:
        group["lr"] = lr


def reduce_and_update(optimizer, cfg: PanguConfig, loss: torch.Tensor, timer,
                      model: nn.Module) -> torch.Tensor:
    """Sum the slab gradients over the active mesh's plane, average the
    gradients over its data axis, update, and return the loss averaged over
    the data axis (one rank: the plain update)."""
    mesh = active_mesh()
    if mesh is None:
        optimizer.step()
        timer.mark("update")
        return loss
    loss = all_reduce_mean(loss)
    if mesh.lat * mesh.lon > 1:
        on_slabs = {id(t) for t in slab_tensors(model)}
        spatial_reduce([p.grad for p in trainable(optimizer) if id(p) in on_slabs])
        timer.mark("spatial_reduce")
    if not isinstance(optimizer, ShardedOptimizer):  # plain DP
        zero_constraint([p.grad for p in trainable(optimizer)], enable=False)
        timer.mark("all_reduce")
        optimizer.step()
        timer.mark("update")
        return loss
    zero2 = cfg.parallel.zero_gradients
    grads = zero_constraint([p.grad for p in optimizer.params], enable=zero2)
    if not zero2:  # ZeRO-1: the rank's shard of each all-reduced gradient
        grads = [None if g is None else local_shard(g, d, mesh)
                 for g, d in zip(grads, optimizer.dims)]
    timer.mark("reduce_scatter" if zero2 else "all_reduce")
    optimizer.step(grads)
    timer.mark("update")
    replicate_constraint(optimizer.shards, optimizer.params)
    timer.mark("all_gather")
    return loss


class _HalfParams:
    """``grads_dtype="bfloat16"``: the f32 trainable tensors hold a bf16 copy
    of their values while the forward and backward run (the blocks' casts
    to the compute dtype are then no-ops), and each microbatch's bf16
    gradients are cast up once into f32 sums; ``restore`` puts the f32
    masters back and sets the f32 gradients (JAX casts them up before any
    reduction, ``pangu_tpu/train/step.py:99-108``)."""

    def __init__(self, tensors: Iterable[torch.Tensor]):
        self.tensors = [t for t in tensors if t.dtype == torch.float32]
        self.masters = [t.data for t in self.tensors]
        self.sums: List[Optional[torch.Tensor]] = [None] * len(self.tensors)
        for t in self.tensors:
            t.data = t.data.to(torch.bfloat16)

    def collect(self) -> None:
        for i, t in enumerate(self.tensors):
            if t.grad is not None:
                g = t.grad.float()
                self.sums[i] = g if self.sums[i] is None else self.sums[i] + g
                t.grad = None

    def restore(self) -> None:
        for t, m, g in zip(self.tensors, self.masters, self.sums):
            t.grad = None
            t.data = m
            t.grad = g


def make_train_step(model: nn.Module, cfg: PanguConfig, optimizer,
                    steps_per_epoch: int = 1,
                    spans: Optional[Dict[str, float]] = None) -> Callable[..., torch.Tensor]:
    """Returns ``step(batch, aux, generator=None) -> loss``: one optimizer
    update in place, the gradients it used left in ``.grad`` (under a mesh,
    averaged over the ranks where an all-reduce ran in place, the rank's own
    where a reduce-scatter took them).

    If ``cfg.train.accumulation_steps > 1`` the batch carries a leading
    microbatch axis of that length; loss and gradients are averaged over it.
    ``cfg.model.grads_dtype="bfloat16"`` differentiates with respect to a
    bf16 copy of the f32 parameters (``_HalfParams``); the masters, the
    moments and the gradients the update reads stay f32. On the card it
    first checks that the kernels take the model's widths
    (``check_kernel_widths``). ``spans``, when given, gains the wall seconds
    of the step's phases summed over its calls, each ended by a
    synchronize: ``forward_backward``, under a spatial mesh ``spatial_reduce``,
    under a mesh ``reduce_scatter`` (ZeRO-2) or ``all_reduce``, ``update``,
    and with sharded moments ``all_gather``.
    """
    from pangu_tpu_torch.eval.evaluate import Spans  # evaluate imports this module

    if next(model.parameters()).is_cuda:
        check_kernel_widths(cfg.model)
    if cfg.model.grads_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"grads_dtype={cfg.model.grads_dtype!r}")
    bf16_grads = cfg.model.grads_dtype == "bfloat16"
    accum = cfg.train.accumulation_steps
    schedule = multistep_lr(cfg.train.lr, cfg.train.lr_milestones, cfg.train.lr_gamma,
                            steps_per_epoch)
    device = next(model.parameters()).device

    def step(batch: Batch, aux: AuxConstants,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        model.train()
        timer = Spans(spans, device)
        optimizer.zero_grad(set_to_none=True)
        micro = [batch] if accum == 1 else [Batch(*(t[i] for t in batch)) for i in range(accum)]
        half = _HalfParams(trainable(optimizer)) if bf16_grads else None
        loss_sum = torch.zeros((), device=batch.upper.device)
        try:
            for mb in micro:
                loss = loss_fn(model, mb, aux, cfg, generator)
                loss.backward()
                if half is not None:
                    half.collect()
                loss_sum = loss_sum + loss.detach()
        finally:
            if half is not None:
                half.restore()
        if accum > 1:
            for p in trainable(optimizer):
                if p.grad is not None:
                    p.grad.div_(accum)
        timer.mark("forward_backward")
        set_scheduled_lr(optimizer, schedule)
        return reduce_and_update(optimizer, cfg, loss_sum / accum, timer, model)

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
