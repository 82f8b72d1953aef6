"""GPipe pipeline parallelism over the mesh's ``pipe`` axis (port of
``pangu_tpu/parallel/pipeline.py``; the role of the reference's DeepSpeed
pipeline prototype ``PanguModelPipe``, reference
models/pangu_model_deepspeed.py:18-125).

The backbone's op chain is cut into contiguous stages, by default the
reference's four at the U-Net joints:

  stage 0: patch_embed + layer0
  stage 1: downsample + layer1
  stage 2: layer2
  stage 3: upsample + layer3 + skip-concat + patch_recovery

One process per card holds one stage: its modules, its parameters and its
Adam state, nothing of the other stages. The ranks of one data replica form
its pipe group, in stage order (``parallel.mesh``). A train step runs the
GPipe fill/drain schedule written out by hand: the forward of the M
microbatches over M + S - 1 ticks, each tick one batched point-to-point
exchange (``batch_isend_irecv``) with the neighbouring stages, each stage
keeping the autograd graph of every microbatch it ran; then the backward in
the same microbatch order over M + S - 1 ticks, each payload's gradient sent
one hop back; then each stage's gradients averaged over its data group (an
all-reduce: the JAX pipeline has no ZeRO) and the stage-local Adam update.
Adam is elementwise, so the stage-local updates are the whole model's. The
bubble is (S-1)/(M+S-1) of the ticks.

The skip connection (reference models/pangu_model.py:98) is captured by the
``downsample`` op and consumed by ``patch_recovery``: between them the
payload is ``(x, skip)``, and the skip rides with its microbatch through the
stages between, a received leaf returned unchanged, whose gradient is the
sum of the next stage's skip gradient and the downsample path's.

Payloads between stages travel in ``transport_dtype`` (default: the model's
compute dtype). The raw physical inputs never do: stage 0 reads its
microbatch's rows of the f32 inputs itself. Nor do the outputs: the last
stage computes the loss from its f32 outputs and the targets it reads
itself, and the eval forward broadcasts its f32 outputs from there.
Microbatch m is the rows [m B/M, (m+1) B/M) of the global batch, and a data
replica takes its coordinate's rows of each; each microbatch's loss and
gradients are summed, then divided by M, as the one-process step's gradient
accumulation does (``train.step.make_train_step``), before the average over
the data group.

Departures from the JAX module, which cannot be matched bit for bit: drop
path and dropout draw from one generator per (stage, microbatch), seeded
from a table the caller's generator draws, and the data coordinate is folded
in as everywhere in the port (``model.blocks.drop_path_scale``,
``model.attention.train_seeds``); flax's draws differ anyway. A step
without a generator runs with drop path off, as the JAX step without an rng
does; dropout there still needs a generator.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from pangu_tpu_torch import dtype_of
from pangu_tpu_torch.aux import AuxConstants
from pangu_tpu_torch.config import ModelConfig, PanguConfig
from pangu_tpu_torch.eval.evaluate import Spans, to_device
from pangu_tpu_torch.geometry import compute_geometry
from pangu_tpu_torch.model.blocks import EarthSpecificLayer
from pangu_tpu_torch.model.pangu import backbone_module, check_kernel_widths
from pangu_tpu_torch.parallel.mesh import Mesh, activate_mesh, all_gather_tensor
from pangu_tpu_torch.train.schedule import multistep_lr
from pangu_tpu_torch.train.step import (Batch, output_loss, reduce_and_update,
                                        set_scheduled_lr)

#: the full backbone as an ordered op chain; a pipeline stage is any
#: contiguous slice of it.
OPS: Tuple[str, ...] = ("patch_embed", "layer0", "downsample", "layer1",
                        "layer2", "upsample", "layer3", "patch_recovery")

#: the reference's 4-way split at the U-Net joints (same partition as
#: reference models/pangu_model_deepspeed.py:24-66).
DEFAULT_STAGES: Tuple[Tuple[str, ...], ...] = (
    ("patch_embed", "layer0"),
    ("downsample", "layer1"),
    ("layer2",),
    ("upsample", "layer3", "patch_recovery"),
)

NUM_STAGES = len(DEFAULT_STAGES)  # the default split's size

# kept under its historical name for importers of the 4-way split
STAGE_MODULES = DEFAULT_STAGES

#: each op's module in the whole model (``PanguModel``): a stage's state dict
#: keys are the whole model's keys under these names
MODULE_NAMES: Dict[str, str] = {
    "patch_embed": "_input_layer", "downsample": "downsample", "upsample": "upsample",
    "patch_recovery": "_output_layer",
    **{f"layer{i}": f"layers.EarthSpecificLayer{i}" for i in range(4)}}


def default_stages(n: int) -> Tuple[Tuple[str, ...], ...]:
    """A contiguous n-way partition of :data:`OPS`.

    n=4 is the reference's U-Net-joint split; n=2 cuts at the single
    mid-network joint (balanced by depth: layer1/layer2 hold the deep
    blocks); other n in [1, 8] fall back to near-equal contiguous chunks.
    """
    if n == 4:
        return DEFAULT_STAGES
    if n == 2:
        return (("patch_embed", "layer0", "downsample", "layer1"),
                ("layer2", "upsample", "layer3", "patch_recovery"))
    if not 1 <= n <= len(OPS):
        raise ValueError(f"pipeline stages must be in [1, {len(OPS)}], got {n}")
    chunks = np.array_split(np.arange(len(OPS)), n)
    return tuple(tuple(OPS[i] for i in c) for c in chunks)


def _validate_stages(stages: Sequence[Sequence[str]]) -> Tuple[Tuple[str, ...], ...]:
    stages = tuple(tuple(s) for s in stages)
    flat = tuple(op for st in stages for op in st)
    if flat != OPS:
        raise ValueError(
            f"stages must be an ordered contiguous partition of {OPS}, "
            f"got {stages}")
    if any(len(s) == 0 for s in stages):
        raise ValueError("empty pipeline stage")
    return stages


def bubble_fraction(stages: int, microbatches: int) -> float:
    """The share of the schedule's ticks a stage idles: (S-1)/(M+S-1)."""
    return (stages - 1) / (microbatches + stages - 1)


class PanguStage(nn.Module):
    """A contiguous slice ``ops`` of the backbone op chain as a standalone
    module, holding only its ops' modules, under the whole model's names
    (:data:`MODULE_NAMES`), so its state dict keys are the whole model's for
    those ops.

    ``forward`` maps a payload tuple to a payload tuple: the physical
    ``(upper, surface)`` before ``patch_embed``, ``(x,)`` up to
    ``downsample``, which captures the skip, ``(x, skip)`` up to
    ``patch_recovery``, which consumes it, and the normalized f32 ``(upper,
    surface)`` after it. On the card it first checks that the kernels take
    the model's widths (``check_kernel_widths``), as ``PanguModel`` does."""

    def __init__(self, cfg: ModelConfig, ops: Sequence[str]):
        super().__init__()
        self.cfg, self.ops = cfg, tuple(ops)
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        g = compute_geometry(cfg)
        layers = {}
        for op in self.ops:
            module = backbone_module(cfg, g, op)
            if op.startswith("layer"):
                layers[MODULE_NAMES[op].split(".")[1]] = module
            else:
                self.add_module(MODULE_NAMES[op], module)
        if layers:
            self.layers = nn.ModuleDict(layers)

    @property
    def first(self) -> bool:
        """Whether the stage reads the physical inputs."""
        return self.ops[0] == OPS[0]

    def forward(self, payload: Tuple[torch.Tensor, ...], aux: AuxConstants,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        if payload[0].is_cuda:
            check_kernel_widths(self.cfg)
        for op in self.ops:
            module = self.get_submodule(MODULE_NAMES[op])
            if op == "patch_embed":
                upper, surface = payload
                payload = (module(upper, surface, aux, self.compute_dtype),)
            elif op == "downsample":
                (x,) = payload
                payload = (module(x, generator), x)  # capture the skip
            elif op == "patch_recovery":
                x, skip = payload
                payload = tuple(module(torch.cat([skip, x], dim=-1)))
            elif op == "layer0":
                (x,) = payload
                payload = (module(x, generator),)
            else:  # layer1 / layer2 / upsample / layer3: the skip passes through
                x, skip = payload
                payload = (module(x, generator), skip)
        return payload


class StageRun(NamedTuple):
    """One microbatch's pass through a stage: ``inputs``, the received
    payload as leaves whose gradients the backward fills (none on the first
    stage); ``outputs``, the stage's outputs, or on the last stage in
    training the microbatch's loss."""

    inputs: Tuple[torch.Tensor, ...]
    outputs: Tuple[torch.Tensor, ...]


def stage_forward(stage: PanguStage, payload: Tuple[torch.Tensor, ...], aux: AuxConstants,
                  generator: Optional[torch.Generator] = None, grad: bool = True) -> StageRun:
    """The forward of one microbatch on ``stage``: ``payload`` is the
    physical inputs on the first stage, else the previous stage's outputs as
    received (the transport dtype), which become leaves (requiring a
    gradient when ``grad``) cast to the compute dtype."""
    inputs = ()
    if not stage.first:
        inputs = tuple(t.detach().requires_grad_(grad) for t in payload)
        payload = tuple(t.to(stage.compute_dtype) for t in inputs)
    return StageRun(inputs, stage(payload, aux, generator))


def stage_backward(run: StageRun,
                   grads: Optional[Sequence[torch.Tensor]] = None) -> Tuple[torch.Tensor, ...]:
    """The backward of one microbatch's ``run``: ``grads`` are its outputs'
    gradients as received (None when the outputs are the loss). The stage's
    parameter gradients accumulate in ``.grad``; returns the gradients of
    its inputs, in their dtype (the transport's)."""
    torch.autograd.backward(run.outputs, None if grads is None else
                            [g.to(o.dtype) for g, o in zip(grads, run.outputs)])
    return tuple(t.grad for t in run.inputs)


def _op_of(key: str) -> str:
    for op, name in MODULE_NAMES.items():
        if key.startswith(name + "."):
            return op
    raise KeyError(f"{key} belongs to no op of the backbone chain")


def split_stage_params(state: Mapping[str, torch.Tensor],
                       stages: Sequence[Sequence[str]] = DEFAULT_STAGES
                       ) -> List[Dict[str, torch.Tensor]]:
    """Partition a whole ``PanguModel`` state dict into per-stage state dicts."""
    ops = {k: _op_of(k) for k in state}
    return [{k: v for k, v in state.items() if ops[k] in names} for names in stages]


def merge_stage_params(stage_states: Sequence[Mapping[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`split_stage_params`."""
    out = {}
    for state in stage_states:
        out.update(state)
    return out


def _boundary_shapes(cfg: ModelConfig, b: int, bi: int
                     ) -> List[Tuple[int, ...]]:
    """Payload array shapes at op-chain boundary ``bi`` (0 = model input,
    ``len(OPS)`` = model output) for per-device microbatch size ``b``."""
    g = compute_geometry(cfg)
    io_shapes = [(b, cfg.upper_vars, cfg.levels, cfg.lat, cfg.lon),
                 (b, cfg.surface_vars, cfg.lat, cfg.lon)]
    outer = (b, g.z, g.h, g.w, cfg.dims[0])
    inner = (b, g.z, g.h2, g.w2, cfg.dims[1])
    outer3 = (b, g.z, g.h, g.w, cfg.dims[3])
    if bi == 0 or bi == len(OPS):
        return io_shapes
    if bi in (1, 2):          # after patch_embed / layer0
        return [outer]
    if bi in (3, 4, 5):       # after downsample / layer1 / layer2
        return [inner, outer]
    return [outer3, outer]    # after upsample / layer3 (bi 6, 7)


def _payload_shapes(cfg: ModelConfig, b: int,
                    stages: Sequence[Sequence[str]]
                    ) -> List[List[Tuple[int, ...]]]:
    """Payload shapes at each stage input boundary, plus the final output
    boundary, for the given stage partition."""
    bnds = [0]
    for st in stages:
        bnds.append(bnds[-1] + len(st))
    return [_boundary_shapes(cfg, b, bi) for bi in bnds]


@contextlib.contextmanager
def _drop_path_off(stage: nn.Module, off: bool):
    """While open with ``off``, every layer of ``stage`` draws no drop path
    (the scales are drawn outside the checkpointed blocks, so the backward's
    recompute does not read the rates)."""
    layers = [m for m in stage.modules() if isinstance(m, EarthSpecificLayer)] if off else []
    rates = [layer.drop_path_rates for layer in layers]
    for layer in layers:
        layer.drop_path_rates = (0.0,) * len(layer.drop_path_rates)
    try:
        yield
    finally:
        for layer, r in zip(layers, rates):
            layer.drop_path_rates = r


class PanguPipeline:
    """The pipeline of ``cfg``'s model over ``mesh`` (its ``pipe`` axis the
    stage count; ``stages`` default to :func:`default_stages`): this rank
    builds and holds only its own stage, ``self.stage``, on ``device``.
    Weights go in by :meth:`load_state_dict` of a whole model's state dict
    and come out by :meth:`state_dict`; the optimizer is
    ``train.step.make_optimizer(pipeline.stage, cfg)``, Adam over the
    stage's parameters."""

    def __init__(self, cfg: PanguConfig, mesh: Mesh, device="cuda",
                 transport_dtype: Optional[torch.dtype] = None,
                 stages: Optional[Sequence[Sequence[str]]] = None):
        self.stages = (_validate_stages(stages) if stages is not None
                       else default_stages(mesh.pipe))
        self.num_stages = len(self.stages)
        if mesh.pipe != self.num_stages:
            raise ValueError(
                f"pipeline needs a 'pipe' mesh axis of size {self.num_stages} (one device "
                f"group per stage), got "
                f"{dict(data=mesh.data, pipe=mesh.pipe, lat=mesh.lat, lon=mesh.lon)}")
        if mesh.lat != 1 or mesh.lon != 1:
            raise ValueError("pipeline mode does not compose with spatial (lat/lon) sharding; "
                             "use PP x DP (docs/PARITY.md discusses why)")
        self.cfg, self.mesh, self.device = cfg, mesh, torch.device(device)
        self.transport_dtype = transport_dtype or dtype_of(cfg.model.compute_dtype)
        d, self.stage_id, _, _ = mesh.coords
        if self.device.type == "cuda":
            check_kernel_widths(cfg.model)
        with self.device:  # parameters are allocated there; the masks move with .to
            self.stage = PanguStage(cfg.model, self.stages[self.stage_id]).to(self.device)
        S, s = self.num_stages, self.stage_id
        self.prev = mesh.global_rank(d, s - 1, 0, 0) if s > 0 else None
        self.next = mesh.global_rank(d, s + 1, 0, 0) if s < S - 1 else None
        self.last_rank = mesh.global_rank(d, S - 1, 0, 0)
        self.first_rank = mesh.global_rank(d, 0, 0, 0)
        self._joined = S == 1

    @property
    def last(self) -> bool:
        return self.stage_id == self.num_stages - 1

    # -- weights ------------------------------------------------------------

    def load_state_dict(self, state: Mapping[str, torch.Tensor]) -> None:
        """Load this stage's part of a whole model's state dict (strict)."""
        self.stage.load_state_dict(split_stage_params(state, self.stages)[self.stage_id])

    def gather(self, tensors: Mapping[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
        """This stage's ``tensors`` (by the whole model's names) and every
        other stage's of the rank's replica, as host copies on its first
        stage (a collective over the pipe group): the whole model's there,
        None on the other stages."""
        own = {k: v.detach().cpu() for k, v in tensors.items()}
        if self.num_stages == 1:
            return own
        parts = [None] * self.num_stages if self.stage_id == 0 else None
        dist.gather_object(own, parts, dst=self.first_rank, group=self.mesh.pipe_group)
        return merge_stage_params(parts) if parts is not None else None

    def state_dict(self) -> Optional[Dict[str, torch.Tensor]]:
        """The whole model's state dict on the first stage of each replica
        (:meth:`gather`; the counterpart of the JAX ``unstack_params``)."""
        return self.gather(self.stage.state_dict())

    # -- the schedule -------------------------------------------------------

    def _exchange(self, sends: Sequence[torch.Tensor], to: Optional[int],
                  shapes: Sequence[Tuple[int, ...]],
                  frm: Optional[int]) -> Tuple[torch.Tensor, ...]:
        """One tick's batched point-to-point exchange on the pipe group:
        ``sends`` to global rank ``to``, and buffers of ``shapes`` (the
        transport dtype) received from ``frm``, returned."""
        if not self._joined:
            # a collective every rank of the group joins makes its communicator: NCCL
            # wants that before a batched point-to-point call that some ranks skip
            dist.all_reduce(torch.zeros(1, device=self.device), group=self.mesh.pipe_group)
            self._joined = True
        recvs = tuple(torch.empty(sh, dtype=self.transport_dtype, device=self.device)
                      for sh in shapes)
        group = self.mesh.pipe_group
        ops = ([dist.P2POp(dist.isend, t.contiguous(), to, group) for t in sends] +
               [dist.P2POp(dist.irecv, t, frm, group) for t in recvs])
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return recvs

    def _plan(self, rows: int, m: int) -> Tuple[List[slice], List[List[Tuple[int, ...]]]]:
        """This replica's rows of each of ``m`` microbatches of a global batch
        of ``rows``, and the payload shapes at each stage boundary."""
        dp = self.mesh.data
        if rows % (m * dp):
            raise ValueError(f"batch {rows} not divisible by microbatches {m} x data axis {dp}")
        per, bl = rows // m, rows // (m * dp)
        d = self.mesh.data_rank
        return ([slice(i * per + d * bl, i * per + (d + 1) * bl) for i in range(m)],
                _payload_shapes(self.cfg.model, bl, self.stages))

    def _fill(self, batch: Sequence, aux: AuxConstants, rows: List[slice], shapes: list,
              train: bool, generators: Sequence[Optional[torch.Generator]]
              ) -> List[Optional[StageRun]]:
        """The forward of the microbatches ``rows`` over m + S - 1 ticks;
        stage s runs microbatch t - s at tick t. Returns this stage's runs
        (on a middle stage in eval, none are kept); on the last stage in
        training each run's outputs are its microbatch's loss."""
        S, s, m = self.num_stages, self.stage_id, len(rows)
        runs: List[Optional[StageRun]] = [None] * m
        received: Tuple[torch.Tensor, ...] = ()
        for t in range(m + S - 1):
            i, sends = t - s, []
            if 0 <= i < m:
                payload = received if s else tuple(to_device(x[rows[i]], self.device)
                                                   for x in batch[:2])
                run = stage_forward(self.stage, payload, aux, generators[i], grad=train)
                if not self.last:
                    sends = [o.detach().to(self.transport_dtype) for o in run.outputs]
                    if train:
                        runs[i] = run
                elif train:
                    targets = (to_device(x[rows[i]], self.device) for x in batch[2:])
                    runs[i] = run._replace(outputs=(output_loss(*run.outputs, *targets, aux,
                                                                self.cfg),))
                else:
                    runs[i] = run
            recv = s > 0 and 0 <= t + 1 - s < m
            received = self._exchange(sends, self.next, shapes[s] if recv else (), self.prev)
        return runs

    def _drain(self, runs: List[Optional[StageRun]], shapes: list) -> None:
        """The backward of the runs over m + S - 1 ticks, in the forward's
        microbatch order: stage s takes microbatch t - (S - 1 - s) at tick t."""
        S, s, m = self.num_stages, self.stage_id, len(runs)
        received: Tuple[torch.Tensor, ...] = ()
        for t in range(m + S - 1):
            i, sends = t - (S - 1 - s), ()
            if 0 <= i < m:
                grads = stage_backward(runs[i], None if self.last else received)
                runs[i] = None
                sends = grads if s else ()
            recv = not self.last and 0 <= t + 1 - (S - 1 - s) < m
            received = self._exchange(sends, self.prev, shapes[s + 1] if recv else (), self.next)

    def _generators(self, generator: Optional[torch.Generator],
                    m: int) -> List[Optional[torch.Generator]]:
        """This stage's generator of each microbatch: seeded from an (S, m)
        table the caller's generator draws (the same on every rank)."""
        if generator is None:
            return [None] * m
        dev = generator.device
        seeds = torch.randint(2**62, (self.num_stages, m), generator=generator, device=dev)
        return [torch.Generator(device=dev).manual_seed(int(seed))
                for seed in seeds[self.stage_id].tolist()]

    def _from_last(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` broadcast from the last stage over the pipe group, in place."""
        if self.num_stages > 1:
            dist.broadcast(t, src=self.last_rank, group=self.mesh.pipe_group)
        return t

    # -- public entry points ------------------------------------------------

    @torch.no_grad()
    def forward(self, upper, surface, aux: AuxConstants,
                num_microbatches: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The pipelined forward in eval mode (on the card: K1): physical
        ``upper`` (B, Vu, L, lat, lon) and ``surface`` (B, Vs, lat, lon), the
        same global batch on every rank, B divisible by ``num_microbatches``
        x the data axis; returns the normalized f32 outputs of the whole
        batch on every rank (gathered over the data group on the last stage,
        then broadcast over the pipe group)."""
        self.stage.eval()
        m = num_microbatches
        rows, shapes = self._plan(upper.shape[0], m)
        with activate_mesh(self.mesh):
            runs = self._fill((upper, surface), aux, rows, shapes, False, [None] * m)
        shapes = _boundary_shapes(self.cfg.model, upper.shape[0], len(OPS))
        out = tuple(torch.empty(sh, dtype=torch.float32, device=self.device) for sh in shapes)
        if self.last:
            dp = self.mesh.data
            for k, o in enumerate(out):
                local = torch.cat([r.outputs[k] for r in runs])
                whole = torch.empty(o.shape, dtype=o.dtype, device=o.device)
                all_gather_tensor(whole, local, group=self.mesh.data_group)
                # (replica, microbatch, row) -> (microbatch, replica, row): the global order
                o.copy_(whole.reshape(dp, m, -1, *o.shape[1:]).transpose(0, 1).reshape(o.shape))
        for o in out:
            self._from_last(o)
        return out

    def make_train_step(self, optimizer, num_microbatches: int, steps_per_epoch: int = 1,
                        spans: Optional[Dict[str, float]] = None) -> Callable[..., torch.Tensor]:
        """Returns ``step(batch, aux, generator=None) -> loss``: one update of
        this stage's parameters by ``optimizer`` (Adam over them,
        ``make_optimizer(pipeline.stage, cfg)``) with the LR of
        ``multistep_lr`` at its update count, from the global ``batch`` (a
        ``Batch`` of arrays or tensors, the same on every rank). The loss is
        the weighted L1 of ``train.step``, the global batch's mean, the same
        on every rank. The stage runs in training mode (the training
        kernels, remat as ``cfg.model.remat``). ``spans``, when given, gains
        the wall seconds of ``forward``, ``backward``, ``all_reduce`` and
        ``update``, each ended by a synchronize."""
        cfg, m = self.cfg, num_microbatches
        schedule = multistep_lr(cfg.train.lr, cfg.train.lr_milestones, cfg.train.lr_gamma,
                                steps_per_epoch)
        params = [p for p in self.stage.parameters() if p.requires_grad]

        def step(batch: Batch, aux: AuxConstants,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
            self.stage.train()
            timer = Spans(spans, self.device)
            optimizer.zero_grad(set_to_none=True)
            rows, shapes = self._plan(batch[0].shape[0], m)
            with activate_mesh(self.mesh), _drop_path_off(self.stage, generator is None):
                runs = self._fill(batch, aux, rows, shapes, True, self._generators(generator, m))
                loss_sum = torch.zeros((), device=self.device)
                if self.last:
                    for run in runs:
                        loss_sum = loss_sum + run.outputs[0].detach()
                timer.mark("forward")
                self._drain(runs, shapes)
                timer.mark("backward")
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(m)
                set_scheduled_lr(optimizer, schedule)
                loss = reduce_and_update(optimizer, cfg, loss_sum / m, timer, self.stage)
            return self._from_last(loss)

        return step
