"""ZeRO sharding of the optimizer state and the gradients (port of
``pangu_tpu/parallel/sharding.py``; the role of DeepSpeed ZeRO stage 2,
reference ds_config.json:1-24).

Parameters stay replicated: every rank reads all of them every step. The
Adam moments live sharded over the ``data`` axis (``zero_shard_opt_state``):
each rank holds them for its shard of each tensor only. The train step
then runs the ZeRO-2 schedule that GSPMD derives from the JAX step's
sharding constraints, written out here by hand: reduce-scatter the
gradients (``zero_constraint``), update each rank's shards, all-gather the
new shards into the full parameters (``replicate_constraint``). A tensor is
sharded along ``_zero_spec``'s dim, moved to the front and made contiguous
for the collective; a tensor with no divisible dim is all-reduced and
updated whole on every rank. Every collective is one call per tensor
(bucketing and overlap with the backward are later speed work, ROADMAP).

Unlike the JAX functions, these do not return early at ``data`` 1: under an
active mesh one card runs the same collectives, which are copies there.

Under a mesh with a lat x lon plane every collective here runs over the
rank's data group (the JAX ``_zero_spec`` shards over ``"data"`` only): the
spatial peers of one data replica hold the same shards. Before them,
``spatial_reduce`` sums over the plane the gradients of the tensors the
layers use on their slabs, each a partial sum over one slab.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from pangu_tpu_torch.parallel.mesh import Mesh, active_mesh, all_gather_tensor

# the name of torch 2.13; older releases have only the second form
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _zero_spec(shape: Sequence[int], data_size: int) -> Optional[int]:
    """The dim to shard: the largest ``data``-divisible one (the first of
    equal sizes), else None (replicated). The JAX rule, but at ``data`` 1
    it also names the largest dim (JAX replicates there; the bytes agree),
    so that one card runs the real collectives."""
    if not shape:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % data_size == 0 and shape[i] >= data_size:
            return i
    return None


def _tensors(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, Mapping):
        return list(tree.values())
    return list(tree)


def _mesh() -> Mesh:
    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError("no active mesh (parallel.activate_mesh)")
    return mesh


def local_shard(x: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This rank's shard of ``x`` along ``dim``, moved to the front and
    contiguous (a new tensor); ``x`` itself when ``dim`` is None."""
    if dim is None:
        return x
    k = x.shape[dim] // mesh.data
    return x.movedim(dim, 0).narrow(0, mesh.data_rank * k, k).contiguous()


def gather_full(shard: torch.Tensor, dim: Optional[int], mesh: Mesh,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All-gather the data axis's ``shard``s (front-moved layout) into the full
    tensor, in ``out``'s layout when given (written in place), else a new
    contiguous tensor."""
    if dim is None:
        return shard
    full = torch.empty((shard.shape[0] * mesh.data, *shard.shape[1:]), dtype=shard.dtype,
                       device=shard.device)
    all_gather_tensor(full, shard, group=mesh.data_group)
    full = full.movedim(0, dim)
    if out is None:
        return full.contiguous()
    out.copy_(full)
    return out


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of a global batch (a Batch or any tuple of arrays or
    tensors), by its data coordinate; with gradient accumulation (6-d upper fields) the rows are on
    axis 1, behind the microbatch axis."""
    axis = 1 if batch[0].ndim == 6 else 0
    rows = batch[0].shape[axis]
    if rows % mesh.data:
        raise ValueError(f"a global batch of {rows} does not split over {mesh.data} ranks")
    b = rows // mesh.data
    d = mesh.data_rank
    sl = (slice(None),) * axis + (slice(d * b, (d + 1) * b),)
    return type(batch)(*(x[sl] for x in batch))


@torch.no_grad()
def shard_params(params: Any, mesh: Mesh) -> Any:
    """Replicate parameters across the mesh: broadcast rank 0's values in
    place (a module, a mapping or a sequence of tensors)."""
    for t in _tensors(params):
        dist.broadcast(t.data, src=dist.get_global_rank(mesh.group, 0)
                       if mesh.group is not None else 0, group=mesh.group)
    return params


class ShardedOptimizer:
    """A torch optimizer over this rank's shards of the trainable tensors:
    the moments exist for the shards only. ``params`` are the full tensors
    (the model's, never replaced), ``dims`` their ``_zero_spec`` dims,
    ``shards`` the tensors the inner optimizer updates: a contiguous
    front-moved copy of the rank's shard, or the full tensor itself when it
    has no divisible dim. ``param_groups`` and ``state`` are the inner
    optimizer's, so the LR schedule reads its update count as before;
    ``zero_grad`` clears the parameters' and the shards' gradients. ``state_dict`` gathers the moments into the one-device layout
    (a collective: every rank calls it) and ``load_state_dict`` keeps this
    rank's shards of such a dict, so a checkpoint moves between world sizes."""

    def __init__(self, optimizer: torch.optim.Optimizer, mesh: Mesh):
        self.mesh = mesh
        groups, self.params, self.dims, self.shards = [], [], [], []
        for g in optimizer.param_groups:
            shards = []
            for p in g["params"]:
                d = _zero_spec(tuple(p.shape), mesh.data)
                s = p if d is None else local_shard(p.detach(), d, mesh)
                self.params.append(p)
                self.dims.append(d)
                shards.append(s)
            self.shards += shards
            groups.append({**{k: v for k, v in g.items() if k != "params"}, "params": shards})
        self.inner = type(optimizer)(groups, **optimizer.defaults)
        if optimizer.state:
            self.load_state_dict(optimizer.state_dict())

    @property
    def param_groups(self) -> List[dict]:
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        for t in (*self.params, *self.shards):
            if t.grad is not None:
                if set_to_none:
                    t.grad = None
                else:
                    t.grad.zero_()

    @torch.no_grad()
    def step(self, shard_grads: Sequence[Optional[torch.Tensor]]) -> None:
        """One update of the shards with their gradients (front-moved
        layout, as ``zero_constraint`` gives them); each shard is first
        refreshed from its parameter, so values loaded into the parameters
        since the last step count."""
        for p, d, s, g in zip(self.params, self.dims, self.shards, shard_grads):
            if d is not None:
                s.copy_(local_shard(p.detach(), d, self.mesh))
            s.grad = g
        self.inner.step()

    def state_dict(self) -> Dict[str, Any]:
        sd = self.inner.state_dict()
        sd["state"] = {i: {k: gather_full(v, self.dims[i], self.mesh)
                           if _per_element(v, self.shards[i]) else v for k, v in st.items()}
                       for i, st in sd["state"].items()}
        return sd

    def load_state_dict(self, sd: Mapping[str, Any]) -> None:
        state = {i: {k: local_shard(v, self.dims[i], self.mesh)
                     if _per_element(v, self.params[i]) else v for k, v in st.items()}
                 for i, st in sd["state"].items()}
        self.inner.load_state_dict({**sd, "state": state})


def _per_element(v: Any, like: torch.Tensor) -> bool:
    """Whether an optimizer state value is per element of ``like`` (a moment),
    not a scalar such as Adam's ``step``."""
    return torch.is_tensor(v) and v.dim() > 0 and v.shape == like.shape


def zero_shard_opt_state(optimizer: torch.optim.Optimizer, mesh: Mesh,
                         enable: bool = True):
    """Shard the optimizer's state over the ``data`` axis (ZeRO): a
    ``ShardedOptimizer`` over the same tensors, holding the optimizer's
    state (if any) sharded; the optimizer itself when not ``enable``."""
    return ShardedOptimizer(optimizer, mesh) if enable else optimizer


def spatial_reduce(grads: Sequence[Optional[torch.Tensor]]) -> None:
    """Sum each gradient over the active mesh's lat x lon plane, in place:
    the gradients of tensors used on the slabs (blocks, their adapters, the
    earth bias), each a partial sum over the rank's slab. None stays None."""
    mesh = _mesh()
    for g in grads:
        if g is not None:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=mesh.plane_group)


def zero_constraint(grads: Sequence[Optional[torch.Tensor]],
                    enable: bool = True) -> List[Optional[torch.Tensor]]:
    """Average the ranks' gradients over the active mesh's data axis. With ``enable``
    (ZeRO-2): a reduce-scatter of each gradient along its ``_zero_spec`` dim,
    moved to the front and contiguous, returning the rank's shard; a
    gradient with no divisible dim is all-reduced whole. Without (ZeRO-1
    and plain DP): every gradient is all-reduced in place, the reduction
    GSPMD inserts for the global batch's loss. None stays None."""
    mesh = _mesh()
    out = []
    for g in grads:
        d = _zero_spec(tuple(g.shape), mesh.data) if (g is not None and enable) else None
        if g is None:
            out.append(None)
        elif d is None:
            dist.all_reduce(g, op=dist.ReduceOp.AVG, group=mesh.data_group)
            out.append(g)
        else:
            full = g.movedim(d, 0).contiguous()
            shard = torch.empty((full.shape[0] // mesh.data, *full.shape[1:]), dtype=g.dtype,
                                device=g.device)
            _reduce_scatter(shard, full, op=dist.ReduceOp.AVG, group=mesh.data_group)
            out.append(shard)
    return out


@torch.no_grad()
def replicate_constraint(shards: Sequence[torch.Tensor], params: Sequence[torch.Tensor]) -> None:
    """The all-gather tail of the ZeRO schedule: each updated shard of the
    active mesh's ranks gathered into its full parameter, in place (the
    parameter tensors, and the kernels' pointers to them, stay the same).
    A tensor updated whole (no divisible dim) needs nothing."""
    mesh = _mesh()
    for s, p in zip(shards, params):
        d = _zero_spec(tuple(p.shape), mesh.data)
        if d is not None:
            gather_full(s, d, mesh, out=p.data)


def zero_bytes_per_device(tree: Any, mesh: Mesh, enable: bool = True) -> int:
    """Per-device bytes of a tree of tensors (meta tensors too) under the
    ZeRO sharding rule (the memory math behind the zero_opt_state /
    zero_gradients knobs)."""
    data = mesh.data if enable else 1

    def leaf_bytes(x: torch.Tensor) -> int:
        n = x.numel() * x.element_size()
        return n // data if _zero_spec(tuple(x.shape), data) is not None else n

    return sum(leaf_bytes(x) for x in _tensors(tree))


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the active mesh's data axis, in place (the spatial
    peers of a data replica hold the same value)."""
    mesh = _mesh()
    dist.all_reduce(x, op=dist.ReduceOp.AVG, group=mesh.data_group)
    return x


def trainable(optimizer) -> Iterable[torch.Tensor]:
    """The full trainable tensors of an optimizer, sharded or not."""
    if isinstance(optimizer, ShardedOptimizer):
        return list(optimizer.params)
    return [p for g in optimizer.param_groups for p in g["params"]]
