"""The multi-process runtime and the mesh policy (port of
``pangu_tpu/parallel/mesh.py``; the reference's NCCL/torchrun layer,
era5_data/utils_dist.py:15-207).

One process per card, joined by ``torch.distributed``: NCCL on the card,
gloo only when the caller asks for the CPU. The mesh is a small record of
the process group, the sizes of its axes ``(data, pipe, lat, lon)``, this
process's rank, and the process groups of the data axis, of the lat x lon
plane and of the pipe axis. Ranks are laid out row-major over ``(data, pipe,
lat, lon)``, as the JAX ``make_mesh`` reshapes its devices: the world is
``data * pipe * lat * lon``. Model code reads the active mesh
(``activate_mesh``) instead of taking it as an argument, as in the JAX
package. The ``data`` axis runs data parallelism with ZeRO sharding of the
Adam state (``parallel.sharding``); ``lat`` and ``lon`` shard the
window-padded token grid of every layer (``parallel.spatial``); ``pipe``
cuts the backbone into pipeline stages, one a rank (``parallel.pipeline``),
and does not compose with ``lat`` or ``lon``. Under a pipe axis the data
group of a rank joins the same stage of every replica, and its pipe group
the stages of its own replica.

Launch: ``torchrun --nproc-per-node N -m pangu_tpu_torch.scripts.finetune ...
[--set parallel.lat=2 --set parallel.lon=2]``; the pipeline trains through
``pangu_tpu_torch.scripts.pipeline_train``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
from typing import Optional

import torch
import torch.distributed as dist

from pangu_tpu_torch.config import ModelConfig, ParallelConfig
from pangu_tpu_torch.geometry import Geometry, StageGeometry, compute_geometry

# the name of torch 2.13; older releases have only the second form
all_gather_tensor = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

_local = threading.local()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The mesh: ``group`` (None: the default process group), the sizes of
    its ``data``, ``lat``, ``lon`` and ``pipe`` axes and this process's
    ``rank`` in ``group``; ``data_group`` reduces over the data axis (None:
    the default group, which is the data axis when pipe = lat = lon = 1),
    ``plane_group`` over the rank's lat x lon plane (None without one) and
    ``pipe_group`` joins the pipeline stages of the rank's data replica, its
    consecutive ranks (None without a pipe axis)."""

    group: Optional[dist.ProcessGroup]
    data: int
    rank: int
    lat: int = 1
    lon: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    plane_group: Optional[dist.ProcessGroup] = None
    pipe: int = 1
    pipe_group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return self.data * self.pipe * self.lat * self.lon

    @property
    def coords(self) -> tuple:
        """This rank's (data, pipe, lat, lon) coordinates."""
        d, inner = divmod(self.rank, self.pipe * self.lat * self.lon)
        p, plane = divmod(inner, self.lat * self.lon)
        return d, p, plane // self.lon, plane % self.lon

    @property
    def data_rank(self) -> int:
        """This rank's coordinate on the data axis: the sample shard it holds."""
        return self.coords[0]

    def global_rank(self, d: int, p: int, la: int, lo: int) -> int:
        """The global rank of the mesh position (d, p, la, lo)."""
        r = ((d * self.pipe + p) * self.lat + la) * self.lon + lo
        return r if self.group is None else dist.get_global_rank(self.group, r)


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def distributed_init(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, local_rank: Optional[int] = None,
                     device="cuda") -> torch.device:
    """Join the process group and return this process's device.

    The arguments default to torchrun's environment (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``; ``env://`` reads ``MASTER_ADDR`` and
    ``MASTER_PORT``); a test passes them, with a ``file://`` init method. A
    single process without an init method is a no-op, as in the JAX package
    (with one, a world of one joins its group). On the card
    the backend is NCCL and the process takes card ``LOCAL_RANK``; gloo
    serves only a ``device`` on the CPU. An already initialized group is kept."""
    device = torch.device(device)
    if dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda" \
            else device
    world = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and init_method is None:
        return device
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    local = local_rank if local_rank is not None else int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        torch.cuda.set_device(local)
        device, backend = torch.device("cuda", local), "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world,
                            rank=rank)
    return device


def is_main() -> bool:
    """rank-0 gate (role of ``master_only``, era5_data/utils_dist.py:199-207)."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _refuse_pipe_with_plane(cfg: ParallelConfig) -> None:
    if cfg.pipe > 1 and cfg.lat * cfg.lon > 1:
        raise ValueError("pipeline mode does not compose with spatial (lat/lon) sharding; "
                         "use PP x DP (docs/PARITY.md discusses why)")


def _check_stage(name: str, stage: StageGeometry, lat: int, lon: int) -> None:
    n_lat, n_lon = stage.h_pad // stage.window[1], stage.n_lon_windows
    for axis, ranks, windows in (("lat", lat, n_lat), ("lon", lon, n_lon)):
        if ranks > windows:
            raise ValueError(
                f"parallel.{axis}={ranks} outnumbers the {windows} {axis} windows of the "
                f"{name} stage (grid {stage.z} x {stage.h_pad} x {stage.w}, window "
                f"{stage.window}): every rank of a spatial axis needs a whole window")


def check_partition(geom: Geometry, lat: int, lon: int) -> None:
    """Raise ValueError, naming the stage, where ``lat`` or ``lon`` ranks
    outnumber a stage's windows along that axis (the JAX ``valid_spec``
    silently drops such an axis instead)."""
    for name, stage in (("outer", geom.outer), ("inner", geom.inner)):
        _check_stage(name, stage, lat, lon)


def _new_group(ranks: list, group: Optional[dist.ProcessGroup]):
    """A process group of the mesh positions ``ranks`` (ranks of ``group``);
    every process calls it for every group, in the same order."""
    if group is not None:
        ranks = [dist.get_global_rank(group, r) for r in ranks]
    return dist.new_group(ranks)


def make_mesh(cfg: ParallelConfig, group: Optional[dist.ProcessGroup] = None,
              model: Optional[ModelConfig] = None) -> Mesh:
    """The mesh of ``cfg`` over the initialized process ``group`` (default:
    the world): ``data * pipe * lat * lon`` must be the group's size. With
    pipe, lat or lon > 1 every process creates the data groups and the pipe
    or plane groups (collectively). A pipe axis with lat or lon > 1 raises
    ValueError, as the JAX pipeline does. A spatial mesh needs the
    ``model``, and an axis with more ranks than a stage has windows along it
    raises ValueError naming the stage, before anything else. This is the
    only check: the slabs trust the mesh."""
    _refuse_pipe_with_plane(cfg)
    if cfg.lat * cfg.lon > 1:
        if model is None:
            raise ValueError("a mesh with lat or lon > 1 needs the model config, to check "
                             "that every rank of a spatial axis gets whole windows")
        check_partition(compute_geometry(model), cfg.lat, cfg.lon)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (distributed_init)")
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if cfg.data * cfg.pipe * cfg.lat * cfg.lon != world:
        raise ValueError(f"parallel {cfg.data} x {cfg.pipe} x {cfg.lat} x {cfg.lon} (data x pipe "
                         f"x lat x lon) but the process group holds {world} ranks (one process "
                         "per card)")
    inner = cfg.pipe * cfg.lat * cfg.lon  # a replica's ranks: its stages or its plane
    if inner == 1:
        return Mesh(group, world, rank, data_group=group)
    data_group = replica_group = None
    for d in range(cfg.data):  # the replicas, then the data axes
        g = _new_group(list(range(d * inner, (d + 1) * inner)), group)
        if rank // inner == d:
            replica_group = g
    for p in range(inner):
        g = _new_group(list(range(p, world, inner)), group)
        if rank % inner == p:
            data_group = g
    if cfg.pipe > 1:
        return Mesh(group, cfg.data, rank, data_group=data_group, pipe=cfg.pipe,
                    pipe_group=replica_group)
    return Mesh(group, cfg.data, rank, cfg.lat, cfg.lon, data_group, replica_group)


def resolve_mesh(cfg: ParallelConfig, device=None,
                 model: Optional[ModelConfig] = None) -> Optional[Mesh]:
    """Entry-point mesh policy: never silently waste attached cards.

    None for a single process (the collective-free path), where any axis
    above 1 raises; in a world of N processes a ``parallel.data`` of 1
    expands to N / (pipe * lat * lon), so a default (1x1x1x1) config is data
    parallelism over all of them, as the JAX policy does over devices; a
    pipe x lat x lon that does not divide N, or a ``data`` that is neither 1
    nor N / (pipe * lat * lon), raises, and so do a pipe axis with lat or
    lon > 1 and, given the ``model``, an axis that outnumbers a stage's
    windows. A world smaller than the cards of ``device``'s host logs that
    the others will IDLE."""
    log = logging.getLogger("pangu_tpu_torch")
    world = _world()
    inner = cfg.pipe * cfg.lat * cfg.lon
    if world == 1 and cfg.data * inner > 1:
        raise ValueError(
            f"parallel config asks for {cfg.data * inner} devices ({cfg.data} x {cfg.pipe} x "
            f"{cfg.lat} x {cfg.lon}, data x pipe x lat x lon) but this is a single process -- "
            f"launch one process per card (torchrun --nproc-per-node {cfg.data * inner}) or "
            "drop the parallel.* overrides")
    _refuse_pipe_with_plane(cfg)
    if world > 1 and world % inner:
        raise ValueError(f"parallel.pipe x parallel.lat x parallel.lon = {inner} does not "
                         f"divide WORLD_SIZE {world}")
    if world > 1 and cfg.data not in (1, world // inner):
        raise ValueError(f"parallel.data={cfg.data} but WORLD_SIZE is {world}")
    cards = (torch.cuda.device_count()
             if device is not None and torch.device(device).type == "cuda" else 0)
    if world < cards:
        log.warning("%d processes cover only %d of %d attached devices -- the other %d will "
                    "IDLE for the whole run", world, world, cards, cards - world)
    if world == 1:
        return None
    if cfg.data * inner == 1:
        log.info("parallel config covers 1 device but %d processes run -- using a "
                 "data-parallel mesh over all of them", world)
    return make_mesh(dataclasses.replace(cfg, data=world // inner), model=model)


@contextlib.contextmanager
def activate_mesh(mesh: Optional[Mesh]):
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


def active_mesh() -> Optional[Mesh]:
    return getattr(_local, "mesh", None)


def barrier() -> None:
    """Wait for every rank of the active mesh (no-op without one)."""
    mesh = active_mesh()
    if mesh is not None:
        dist.barrier(group=mesh.group)
