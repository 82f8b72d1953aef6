"""The multi-process runtime and the mesh policy (port of
``pangu_tpu/parallel/mesh.py``; the reference's NCCL/torchrun layer,
era5_data/utils_dist.py:15-207).

One process per card, joined by ``torch.distributed``: NCCL on the card,
gloo only when the caller asks for the CPU. The mesh is a small record of
the process group, the size of its ``data`` axis (the world) and this
process's rank in it. Model code reads the active mesh (``activate_mesh``)
instead of taking it as an argument, as in the JAX package. Only the
``data`` axis is ported: data parallelism with ZeRO sharding of the Adam
state (``parallel.sharding``). Spatial sharding over ``lat``/``lon`` and the
``pipe`` axis are refused (ROADMAP queue 1, items 10b and 10c).

Launch: ``torchrun --nproc-per-node N -m pangu_tpu_torch.scripts.finetune ...``.
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

from pangu_tpu_torch.config import ParallelConfig

_local = threading.local()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-parallel mesh: ``group`` (None: the default process group),
    the size of its ``data`` axis and this process's ``rank`` on it."""

    group: Optional[dist.ProcessGroup]
    data: int
    rank: int


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
    if cfg.lat > 1 or cfg.lon > 1:
        raise NotImplementedError(
            f"parallel.lat={cfg.lat}, parallel.lon={cfg.lon}: spatial sharding of the token "
            "grid is not ported (ROADMAP queue 1, item 10b)")
    if cfg.pipe > 1:
        raise NotImplementedError(
            f"parallel.pipe={cfg.pipe}: the GPipe pipeline is not ported "
            "(ROADMAP queue 1, item 10c)")


def make_mesh(cfg: ParallelConfig, group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The mesh of ``cfg`` over the initialized process ``group`` (default:
    the world); ``cfg.data`` must be the group's size."""
    _refuse_unported(cfg)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (distributed_init)")
    world = dist.get_world_size(group)
    if cfg.data != world:
        raise ValueError(f"parallel.data={cfg.data} but the process group holds {world} ranks "
                         "(one process per card)")
    return Mesh(group, world, dist.get_rank(group))


def infer_mesh(group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """Every rank on the data axis -- the safe default (pure DP)."""
    return make_mesh(ParallelConfig(data=dist.get_world_size(group)), group)


def resolve_mesh(cfg: ParallelConfig, device=None) -> Optional[Mesh]:
    """Entry-point mesh policy: never silently waste attached cards.

    None for a single process (the collective-free path); a default
    (1x1x1x1) config in a world of N processes expands to data parallelism
    over all of them (``infer_mesh``), as the JAX policy does over devices;
    a ``parallel.data`` that is neither 1 nor the world size raises, and so
    do ``lat``, ``lon`` or ``pipe`` > 1 (not ported). A world smaller than
    the cards of ``device``'s host logs that the others will IDLE."""
    _refuse_unported(cfg)
    log = logging.getLogger("pangu_tpu_torch")
    world = _world()
    if world == 1 and cfg.data > 1:
        raise ValueError(
            f"parallel config asks for {cfg.data} devices but this is a single process -- "
            f"launch one process per card (torchrun --nproc-per-node {cfg.data}) or drop "
            "the parallel.* overrides")
    if world > 1 and cfg.data not in (1, world):
        raise ValueError(f"parallel.data={cfg.data} but WORLD_SIZE is {world}")
    cards = (torch.cuda.device_count()
             if device is not None and torch.device(device).type == "cuda" else 0)
    if world < cards:
        log.warning("parallel config %dx1x1x1 covers only %d of %d attached devices -- the "
                    "other %d will IDLE for the whole run", world, world, cards, cards - world)
    if world == 1:
        return None
    if cfg.data == 1:
        log.info("parallel config covers 1 device but %d processes run -- using a "
                 "data-parallel mesh over all of them", world)
    return infer_mesh()


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
