"""Spatial sharding of the window-padded token grid over the mesh's lat x lon
plane (the port's form of the JAX package's ``TOKEN_SPEC = P("data", None,
"lat", "lon", None)``, pangu_tpu/parallel/mesh.py:36, and the halo
exchanges GSPMD inserts for it).

Each rank of a lat x lon plane holds a contiguous block of WHOLE windows of
a stage's window-padded grid (B, Z, Hp, W, C): its ``Slab``. The windows
along each axis are dealt out in order, the first ranks taking one more
where they do not divide (flagship outer stage, 31 lat windows over 2:
16 then 15). No kernel sees anything but a grid of whole windows, so every
kernel runs on a slab as it is, with the earth bias (nT, heads, T, T) and
the shift mask (nT, T, T) cut to the slab's lat windows (``Slab.cut_types``:
the type index is ``zi * hn + hi`` of the grid the kernel is given).

* ``scatter``/``gather``: a layer's entry and exit. ``scatter`` keeps the
  rank's slab of the whole (replicated) grid; its backward all-gathers the
  slabs' gradients into the whole gradient. ``gather`` all-gathers the
  slabs into the whole grid on every rank; its backward keeps the rank's
  slab of the gradient. Slabs of unequal size travel padded to the largest.
* ``roll``: ``torch.roll`` of the whole grid, done on slabs. Z is not
  sharded and rolls locally; latitude, then longitude, is a halo shift: a
  roll by -s hands each rank its own rows [s:] followed by the first s rows
  of the next rank along the axis (cyclically), a roll by +s the previous
  rank's last s rows followed by its own rows [:-s]. Shifting latitude
  first carries the corner block along without a diagonal exchange. The
  backward of a shift is the opposite shift. Each shift is one
  ``batch_isend_irecv`` of a send and a receive, so a world of 2 (one
  neighbour both ways) cannot deadlock.
* ``on_slab``: open while a layer's blocks run on its slab; ``active_slab``
  tells the dropout seeds (``model.attention.train_seeds``) whether the
  caller works on a slab (fold the global rank) or on the whole grid (fold
  the data coordinate, so the spatial peers of a sample draw the same masks).
* ``record_shardings``: collect (tag, global shape, local shape) of every
  block's input, the assertion the JAX ``record_shardings`` serves.

``parallel.mesh.make_mesh`` refuses an axis with more ranks than a stage
has windows along it, so every slab holds at least one window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from pangu_tpu_torch.geometry import StageGeometry
from pangu_tpu_torch.parallel.mesh import Mesh, all_gather_tensor

_local = threading.local()


def partition(n: int, parts: int) -> List[Tuple[int, int]]:
    """[start, stop) of each of ``parts`` contiguous runs of ``n`` items, in
    order; sizes differ by at most one, the larger first."""
    base, extra = divmod(n, parts)
    out, start = [], 0
    for i in range(parts):
        stop = start + base + (i < extra)
        out.append((start, stop))
        start = stop
    return out


@dataclasses.dataclass(frozen=True)
class Slab:
    """This rank's block of whole windows of ``stage``'s padded grid:
    windows [lat_windows) x [lon_windows), the same windows' tokens as
    ``rows`` x ``cols``; ``lat_parts``/``lon_parts`` are every rank's window
    runs along each axis (the plane's layout)."""

    stage: StageGeometry
    mesh: Mesh
    lat_parts: Tuple[Tuple[int, int], ...]
    lon_parts: Tuple[Tuple[int, int], ...]

    @property
    def lat_windows(self) -> Tuple[int, int]:
        return self.lat_parts[self.mesh.coords[2]]

    @property
    def lon_windows(self) -> Tuple[int, int]:
        return self.lon_parts[self.mesh.coords[3]]

    @property
    def rows(self) -> Tuple[int, int]:
        wh = self.stage.window[1]
        a, b = self.lat_windows
        return a * wh, b * wh

    @property
    def cols(self) -> Tuple[int, int]:
        ww = self.stage.window[2]
        a, b = self.lon_windows
        return a * ww, b * ww

    def cut_types(self, t: torch.Tensor) -> torch.Tensor:
        """The rows of a per-window-type table (nT = nz * nh leading: the
        earth bias or the shift mask) for the slab's lat windows, contiguous."""
        nz = self.stage.z // self.stage.window[0]
        a, b = self.lat_windows
        return t.reshape(nz, t.shape[0] // nz, *t.shape[1:])[:, a:b].reshape(
            -1, *t.shape[1:]).contiguous()


def slab_of(stage: StageGeometry, mesh: Optional[Mesh]) -> Optional[Slab]:
    """The rank's slab of ``stage`` under ``mesh``; None without a mesh or
    when its plane is one rank (the whole grid)."""
    if mesh is None or mesh.lat * mesh.lon == 1:
        return None
    return Slab(stage, mesh, tuple(partition(stage.h_pad // stage.window[1], mesh.lat)),
                tuple(partition(stage.n_lon_windows, mesh.lon)))


# ---- layer entry and exit ------------------------------------------------------------


def _gather_plane(x: torch.Tensor, slab: Slab) -> torch.Tensor:
    """The whole grid from every rank's slab ``x`` (an all-gather over the
    plane, slabs padded to the largest and trimmed)."""
    wh, ww = slab.stage.window[1:]
    hmax = max(b - a for a, b in slab.lat_parts) * wh
    wmax = max(b - a for a, b in slab.lon_parts) * ww
    pad = F.pad(x, (0, 0, 0, wmax - x.shape[3], 0, hmax - x.shape[2])).contiguous()
    n = len(slab.lat_parts) * len(slab.lon_parts)
    parts = torch.empty((n * pad.shape[0], *pad.shape[1:]), dtype=x.dtype, device=x.device)
    all_gather_tensor(parts, pad, group=slab.mesh.plane_group)
    parts = parts.view(n, *pad.shape)
    b, z, _, _, c = x.shape
    whole = torch.empty((b, z, slab.stage.h_pad, slab.stage.w, c), dtype=x.dtype,
                        device=x.device)
    p = 0
    for la, lb in slab.lat_parts:
        for wa, wb in slab.lon_parts:
            h, w = (lb - la) * wh, (wb - wa) * ww
            whole[:, :, la * wh:lb * wh, wa * ww:wb * ww] = parts[p, :, :, :h, :w]
            p += 1
    return whole


def _cut(x: torch.Tensor, slab: Slab) -> torch.Tensor:
    (r0, r1), (c0, c1) = slab.rows, slab.cols
    return x[:, :, r0:r1, c0:c1].contiguous()


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slab):
        ctx.slab = slab
        return _cut(x, slab)

    @staticmethod
    def backward(ctx, g):
        return _gather_plane(g.contiguous(), ctx.slab), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slab):
        ctx.slab = slab
        return _gather_plane(x.contiguous(), slab)

    @staticmethod
    def backward(ctx, g):
        return _cut(g, ctx.slab), None


def scatter(x: torch.Tensor, slab: Slab) -> torch.Tensor:
    """The rank's slab of the whole padded grid ``x`` (the same on every rank
    of the plane); backward: the whole gradient, gathered from the slabs."""
    return _Scatter.apply(x, slab)


def gather(x: torch.Tensor, slab: Slab) -> torch.Tensor:
    """The whole padded grid from the plane's slabs, on every rank;
    backward: the rank's slab of the (replicated) gradient."""
    return _Gather.apply(x, slab)


# ---- the shifted blocks' roll -----------------------------------------------------------


def _shift(x: torch.Tensor, dim: int, shift: int, prev: int, nxt: int, group) -> torch.Tensor:
    """``torch.roll`` by ``shift`` along ``dim`` of the axis's slabs laid end
    to end, on this rank's slab: one send to and one receive from the
    neighbours (global ranks ``prev`` and ``nxt``)."""
    s = abs(shift)
    n = x.shape[dim]
    if s > n:
        raise ValueError(f"a halo of {s} is wider than a slab of {n}")
    if shift < 0:  # own [s:] + next's [:s]; our [:s] goes to prev
        send, peer_to, peer_from, keep = x.narrow(dim, 0, s), prev, nxt, x.narrow(dim, s, n - s)
    else:  # prev's [-s:] + own [:-s]; our [-s:] goes to next
        send, peer_to, peer_from, keep = x.narrow(dim, n - s, s), nxt, prev, x.narrow(dim, 0, n - s)
    send = send.contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, peer_to, group),
                                   dist.P2POp(dist.irecv, recv, peer_from, group)])
    for r in reqs:
        r.wait()
    return torch.cat([keep, recv] if shift < 0 else [recv, keep], dim=dim)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, shift, prev, nxt, group):
        ctx.args = (dim, shift, prev, nxt, group)
        return _shift(x, dim, shift, prev, nxt, group)

    @staticmethod
    def backward(ctx, g):
        dim, shift, prev, nxt, group = ctx.args
        return _shift(g.contiguous(), dim, -shift, prev, nxt, group), None, None, None, None, None


def _neighbours(mesh, axis: int) -> Tuple[int, int]:
    """Global ranks of the previous and next rank along mesh axis ``axis``
    (2: lat, 3: lon), cyclically."""
    size = (mesh.data, mesh.pipe, mesh.lat, mesh.lon)[axis]
    c = list(mesh.coords)
    out = []
    for step in (-1, 1):
        c[axis] = (mesh.coords[axis] + step) % size
        out.append(mesh.global_rank(*c))
    return out[0], out[1]


def roll(x: torch.Tensor, shifts: Sequence[int], slab: Optional[Slab]) -> torch.Tensor:
    """``torch.roll(x, shifts, dims=(1, 2, 3))`` of the whole padded grid:
    on ``x`` itself without a slab, else on the rank's slab, Z locally,
    then the lat and lon halo shifts."""
    if slab is None:
        return torch.roll(x, shifts=tuple(shifts), dims=(1, 2, 3))
    sz, sh, sw = shifts
    x = torch.roll(x, shifts=sz, dims=1)
    mesh = slab.mesh
    for dim, axis, s in ((2, 2, sh), (3, 3, sw)):
        if (mesh.data, mesh.pipe, mesh.lat, mesh.lon)[axis] == 1:
            x = torch.roll(x, shifts=s, dims=dim)
        elif s:
            x = _Shift.apply(x, dim, s, *_neighbours(mesh, axis), mesh.group)
    return x


# ---- the blocks' context -------------------------------------------------------------


@contextlib.contextmanager
def on_slab(slab: Optional[Slab]):
    """Open while a layer's blocks run on ``slab`` (None: the whole grid)."""
    prev = getattr(_local, "slab", None)
    _local.slab = slab
    try:
        yield slab
    finally:
        _local.slab = prev


def active_slab() -> Optional[Slab]:
    """The slab of the ``on_slab`` context open in this thread, else None."""
    return getattr(_local, "slab", None)


# ---- the recorder -----------------------------------------------------------------------


@contextlib.contextmanager
def record_shardings(log: Optional[list] = None):
    """Collect (tag, global shape, local shape) of every block input while
    the context is open (``record``)."""
    if log is None:
        log = []
    prev = getattr(_local, "record", None)
    _local.record = log
    try:
        yield log
    finally:
        _local.record = prev


def record(tag: str, global_shape: Sequence[int], local_shape: Sequence[int]) -> None:
    log = getattr(_local, "record", None)
    if log is not None:
        log.append((tag, tuple(global_shape), tuple(local_shape)))
