"""The multi-process runtime and the mesh policy (port of
``pangu_tpu/parallel/mesh.py``; the reference's NCCL/torchrun layer,
era5_data/utils_dist.py:15-207).

One process per card, joined by ``torch.distributed``: NCCL on the card,
gloo only when the caller asks for the CPU. The mesh is a small record of
the process group, the sizes of its axes ``(data, lat, lon)``, this process's
rank, and the process groups of the data axis and of the lat x lon plane.
Ranks are laid out row-major over ``(data, lat, lon)``, as the JAX
``make_mesh`` reshapes its devices: the world is ``data * lat * lon``. Model
code reads the active mesh (``activate_mesh``) instead of taking it as an
argument, as in the JAX package. The ``data`` axis runs data parallelism with
ZeRO sharding of the Adam state (``parallel.sharding``); ``lat`` and ``lon``
shard the window-padded token grid of every layer (``parallel.spatial``).
The ``pipe`` axis is refused (ROADMAP queue 1, item 10c).

Launch: ``torchrun --nproc-per-node N -m pangu_tpu_torch.scripts.finetune ...
[--set parallel.lat=2 --set parallel.lon=2]``.
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
    its ``data``, ``lat`` and ``lon`` axes and this process's ``rank`` in
    ``group``; ``data_group`` reduces over the data axis (None: the default
    group, which is the data axis when lat = lon = 1) and ``plane_group``
    over the rank's lat x lon plane (None without one)."""

    group: Optional[dist.ProcessGroup]
    data: int
    rank: int
    lat: int = 1
    lon: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    plane_group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return self.data * self.lat * self.lon

    @property
    def coords(self) -> tuple:
        """This rank's (data, lat, lon) coordinates."""
        d, plane = divmod(self.rank, self.lat * self.lon)
        return d, plane // self.lon, plane % self.lon

    @property
    def data_rank(self) -> int:
        """This rank's coordinate on the data axis: the sample shard it holds."""
        return self.coords[0]

    def global_rank(self, d: int, la: int, lo: int) -> int:
        """The global rank of the mesh position (d, la, lo)."""
        r = (d * self.lat + la) * self.lon + lo
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


def _refuse_unported(cfg: ParallelConfig) -> None:
    if cfg.pipe > 1:
        raise NotImplementedError(
            f"parallel.pipe={cfg.pipe}: the GPipe pipeline is not ported "
            "(ROADMAP queue 1, item 10c)")


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
    the world): ``data * lat * lon`` must be the group's size. With lat or
    lon > 1 every process creates the data and plane groups (collectively);
    such a mesh needs the ``model``, and an axis with more ranks than a
    stage has windows along it raises ValueError naming the stage, before
    anything else. This is the only check: the slabs trust the mesh."""
    _refuse_unported(cfg)
    if cfg.lat * cfg.lon > 1:
        if model is None:
            raise ValueError("a mesh with lat or lon > 1 needs the model config, to check "
                             "that every rank of a spatial axis gets whole windows")
        check_partition(compute_geometry(model), cfg.lat, cfg.lon)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (distributed_init)")
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if cfg.data * cfg.lat * cfg.lon != world:
        raise ValueError(f"parallel {cfg.data} x {cfg.lat} x {cfg.lon} (data x lat x lon) but "
                         f"the process group holds {world} ranks (one process per card)")
    plane = cfg.lat * cfg.lon
    if plane == 1:
        return Mesh(group, world, rank, data_group=group)
    data_group = plane_group = None
    for d in range(cfg.data):  # the planes, then the data axes
        g = _new_group(list(range(d * plane, (d + 1) * plane)), group)
        if rank // plane == d:
            plane_group = g
    for p in range(plane):
        g = _new_group(list(range(p, world, plane)), group)
        if rank % plane == p:
            data_group = g
    return Mesh(group, cfg.data, rank, cfg.lat, cfg.lon, data_group, plane_group)


def resolve_mesh(cfg: ParallelConfig, device=None,
                 model: Optional[ModelConfig] = None) -> Optional[Mesh]:
    """Entry-point mesh policy: never silently waste attached cards.

    None for a single process (the collective-free path), where any axis
    above 1 raises; in a world of N processes a ``parallel.data`` of 1
    expands to N / (lat * lon), so a default (1x1x1x1) config is data
    parallelism over all of them, as the JAX policy does over devices; a
    lat x lon that does not divide N, or a ``data`` that is neither 1 nor
    N / (lat * lon), raises, and so does ``pipe`` > 1 (not ported) and,
    given the ``model``, an axis that outnumbers a stage's windows. A
    world smaller than the cards of ``device``'s host logs that the others
    will IDLE."""
    _refuse_unported(cfg)
    log = logging.getLogger("pangu_tpu_torch")
    world = _world()
    plane = cfg.lat * cfg.lon
    if world == 1 and cfg.data * plane > 1:
        raise ValueError(
            f"parallel config asks for {cfg.data * plane} devices ({cfg.data} x {cfg.lat} x "
            f"{cfg.lon}, data x lat x lon) but this is a single process -- launch one process "
            f"per card (torchrun --nproc-per-node {cfg.data * plane}) or drop the parallel.* "
            "overrides")
    if world > 1 and world % plane:
        raise ValueError(f"parallel.lat x parallel.lon = {plane} does not divide WORLD_SIZE "
                         f"{world}")
    if world > 1 and cfg.data not in (1, world // plane):
        raise ValueError(f"parallel.data={cfg.data} but WORLD_SIZE is {world}")
    cards = (torch.cuda.device_count()
             if device is not None and torch.device(device).type == "cuda" else 0)
    if world < cards:
        log.warning("%d processes cover only %d of %d attached devices -- the other %d will "
                    "IDLE for the whole run", world, world, cards, cards - world)
    if world == 1:
        return None
    if cfg.data * plane == 1:
        log.info("parallel config covers 1 device but %d processes run -- using a "
                 "data-parallel mesh over all of them", world)
    return make_mesh(dataclasses.replace(cfg, data=world // plane), model=model)


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
