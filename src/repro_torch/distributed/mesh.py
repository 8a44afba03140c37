"""A mesh bound to ranks: the collectives of the rank program.

The reference lays its model out on a device mesh by sharding rules and
lets GSPMD insert the collectives. The port runs the same layout as an
explicit rank program (``models``): single-rank code over this rank's
shards, whose collectives go through a ``RankMesh``, this rank's view of a
``launch.mesh.MeshLayout``. Each collective runs over one axis or a tuple
of axes (the ranks that differ only there, in ``MeshLayout.group``
order); over axes of size 1 it returns its input and moves nothing:

- ``all_reduce(x, axes)``: the sum over the group;
- ``all_gather(x, dim, axes)``: the group's tensors concatenated along
  ``dim`` in group order;
- ``all_to_all(x, split_dim, cat_dim, axes)``: ``x`` split along
  ``split_dim`` into one chunk per member, chunk i sent to member i, and
  the received chunks concatenated along ``cat_dim`` in group order.

``ep_group(axes)`` is the flat ``EPGroup`` over the expert-parallel axes,
so the EP rank body (``alltoall._local_dispatch_combine``) runs unchanged
over it. Every collective adds the bytes of its result to
``collective_bytes`` (the convention of the reference's
``collective_bytes_from_hlo``), the EP group's exchanges included.

Three transports, picked explicitly (no fallback from one to another):

- ``ThreadMesh``: every rank a Python thread in this process, on one
  device (the CPU tests; the card in ``chip_smoke.py``). A collective
  meets at a barrier of all ranks and each member combines the group's
  tensors in group order, so a sum is the same on every member and from
  run to run. The threads share the device's current stream, so a
  tensor another rank made is ready for this rank's kernels in stream
  order.
- ``DistMesh``: this process's rank of a ``torch.distributed`` world of
  ``layout.size`` ranks, one subgroup per group of every axis subset.
- ``CountingMesh``: rank 0 alone on the ``meta`` device (the dry run).
  Its collectives return empty tensors of the result's shape and count
  their bytes. Rank 0 stands for every rank: the sharding rules split a
  dim only when the axis divides it, so every rank holds the same
  shapes and runs the same ops.
"""

from __future__ import annotations

import functools
import itertools
import threading

import torch
from torch.utils._python_dispatch import _disable_current_modes

from .group import _DONE, DistGroup, EPGroup, inverse_round

__all__ = ["CountingMesh", "DistMesh", "RankMesh", "ThreadMesh"]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class RankMesh:
    """One rank's view of a ``MeshLayout``. Subclasses give ``_reduce``,
    ``_gather``, ``_a2a`` and ``ep_group``."""

    def __init__(self, layout, rank: int, device):
        self.layout = layout
        self.rank = int(rank)
        self.device = torch.device(device)
        self.collective_bytes = 0

    # The mesh as the sharding rules read it.
    @property
    def axis_names(self):
        return self.layout.axis_names

    @property
    def devices(self):
        return self.layout.devices

    def axis_size(self, axes) -> int:
        return self.layout.axis_size(axes)

    def axis_index(self, axes) -> int:
        return self.layout.axis_index(self.rank, axes)

    def _count(self, out):
        self.collective_bytes += _nbytes(out)
        return out

    def all_reduce(self, x, axes):
        if self.axis_size(axes) == 1:
            return x
        return self._count(self._reduce(x, self.layout.axes(axes)))

    def all_gather(self, x, dim: int, axes):
        if self.axis_size(axes) == 1:
            return x
        return self._count(self._gather(x, dim % x.ndim,
                                        self.layout.axes(axes)))

    def all_to_all(self, x, split_dim: int, cat_dim: int, axes):
        n = self.axis_size(axes)
        if n == 1:
            return x
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all splits dim {split_dim} of "
                             f"{tuple(x.shape)} into {n} chunks")
        return self._count(self._a2a(x, split_dim % x.ndim, cat_dim % x.ndim,
                                     self.layout.axes(axes)))


# ---------------------------------------------------------------------------
# In-process ranks (threads)
# ---------------------------------------------------------------------------

class ThreadMesh:
    """``layout.size`` ranks as threads of this process on ``device``.
    ``run(fn)`` calls ``fn(rank_mesh)`` on every rank at once and returns
    the results in rank order (a rank's exception is raised once every
    thread has stopped). A rank that waits ``timeout`` seconds at a
    collective for the others (a rank program whose ranks call different
    collectives) breaks it, and ``run`` raises."""

    def __init__(self, layout, device="cpu", timeout: float = 600.0):
        self.layout = layout
        self.device = torch.device(device)
        self._slots = [None] * layout.size
        self._barrier = threading.Barrier(layout.size, timeout=timeout)
        self.ranks = [ThreadRank(self, r) for r in range(layout.size)]

    def _exchange(self, rank: int, value, combine, out=None):
        """Deposit ``value``, wait for every rank, run ``combine(slots)``
        (which fills ``out``), wait again, and return ``out``. ``out`` is
        made by the caller, like the counting transport's result, and
        ``combine`` runs with this thread's dispatch modes off: the dry
        run's trackers (``launch.dryrun``) then see one new storage per
        collective, as on ``meta``, and never the views of other ranks'
        tensors that combining makes."""
        self._slots[rank] = value
        self._barrier.wait()
        try:
            with _disable_current_modes():
                combine(self._slots)
        finally:
            self._barrier.wait()
        self._slots[rank] = None
        return out

    def run(self, fn):
        results = [None] * self.layout.size
        errors = []

        def body(r):
            try:
                if self.device.type == "cuda" and self.device.index is not None:
                    torch.cuda.set_device(self.device)
                results[r] = fn(self.ranks[r])
            except BaseException as e:           # noqa: BLE001
                errors.append((r, e))
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(self.layout.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._barrier.reset()
        self._slots = [None] * self.layout.size
        if errors:
            real = [e for e in errors
                    if not isinstance(e[1], threading.BrokenBarrierError)]
            r, e = (real or errors)[0]
            raise RuntimeError(f"rank {r} failed: {e!r}") from e
        return results


def _sum_into(out, members, slots) -> None:
    """out = the members' tensors summed in group order."""
    out.copy_(slots[members[0]])
    for r in members[1:]:
        out.add_(slots[r])


class ThreadRank(RankMesh):
    """One thread's rank of a ``ThreadMesh``."""

    def __init__(self, mesh: ThreadMesh, rank: int):
        super().__init__(mesh.layout, rank, mesh.device)
        self.mesh = mesh
        self._ep = {}

    def _members(self, axes):
        return self.layout.group(self.rank, axes)

    def _reduce(self, x, axes):
        out = torch.empty_like(x)
        return self.mesh._exchange(self.rank, x, functools.partial(
            _sum_into, out, self._members(axes)), out)

    def _gather(self, x, dim, axes):
        members = self._members(axes)
        shape = list(x.shape)
        shape[dim] *= len(members)
        out = x.new_empty(shape)
        return self.mesh._exchange(self.rank, x, lambda s: torch.cat(
            [s[r] for r in members], dim, out=out), out)

    def _a2a(self, x, split_dim, cat_dim, axes):
        members = self._members(axes)
        me = members.index(self.rank)
        n = len(members)
        shape = list(x.shape)
        shape[split_dim] //= n
        shape[cat_dim] *= n
        out = x.new_empty(shape)
        return self.mesh._exchange(self.rank, x, lambda s: torch.cat(
            [s[r].chunk(n, split_dim)[me] for r in members], cat_dim,
            out=out), out)

    def ep_group(self, axes) -> EPGroup:
        axes = self.layout.axes(axes)
        if axes not in self._ep:
            self._ep[axes] = _ThreadEPGroup(self, axes)
        return self._ep[axes]


class _ThreadEPGroup(EPGroup):
    """The flat EP group over ``axes`` seen from one thread rank: it holds
    that one rank (``ranks == (its index,)``), as a ``DistGroup`` does."""

    def __init__(self, rank_mesh: ThreadRank, axes):
        self.rm = rank_mesh
        self.members = rank_mesh.layout.group(rank_mesh.rank, axes)
        self.n = len(self.members)
        self.ranks = (self.members.index(rank_mesh.rank),)
        self.device = rank_mesh.device

    @property
    def transport(self) -> str:
        return f"in-process thread (rank {self.ranks[0]} of {self.n})"

    def _x(self, value, combine, out):
        return self.rm._count(self.rm.mesh._exchange(self.rm.rank, value,
                                                     combine, out))

    def all_to_all(self, bufs):
        buf, = bufs
        me = self.ranks[0]
        out = torch.empty_like(buf)
        return [self._x(buf, lambda s: torch.stack(
            [s[r][me] for r in self.members], out=out), out)]

    def permute(self, dst, send, recv, stream=None):
        me = self.ranks[0]
        value = send(me) if dst[me] >= 0 else None
        src = inverse_round(dst)[me]
        if src < 0:
            self.rm.mesh._exchange(self.rm.rank, value, lambda s: None)
            return _DONE
        out = recv(me)
        self._x(value, lambda s: out.copy_(s[self.members[src]]), out)
        return _DONE

    def all_gather(self, parts):
        part, = parts
        out = part.new_empty((part.shape[0] * self.n,)
                             + tuple(part.shape[1:]))
        return self._x(part, lambda s: torch.cat(
            [s[r] for r in self.members], out=out), out)

    def mean(self, vals):
        val, = vals
        out = torch.empty_like(val)

        def combine(s):
            _sum_into(out, self.members, s)
            out.div_(self.n)
        return self._x(val, combine, out)


# ---------------------------------------------------------------------------
# torch.distributed
# ---------------------------------------------------------------------------

class DistMesh(RankMesh):
    """This process's rank of an initialised ``torch.distributed`` world of
    ``layout.size`` ranks (rank r at the layout's flat index r). Every
    process must build it, in the same order: it makes one subgroup per
    group of every proper subset of the axes (``dist.new_group`` is
    collective); the whole mesh is the default group."""

    def __init__(self, layout, device="cpu"):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs an initialised process group")
        if dist.get_world_size() != layout.size:
            raise ValueError(f"a {layout.size}-rank mesh under a world of "
                             f"{dist.get_world_size()}")
        super().__init__(layout, dist.get_rank(), device)
        self._pg = {}
        names = layout.axis_names
        for k in range(1, len(names)):
            for axes in itertools.combinations(names, k):
                for members in layout.groups(axes):
                    pg = dist.new_group(list(members))
                    if self.rank in members:
                        self._pg[axes] = (pg, members)
        self._pg[tuple(names)] = (None, tuple(range(layout.size)))
        self._ep = {}

    def _group(self, axes):
        return self._pg[axes]

    def _reduce(self, x, axes):
        import torch.distributed as dist
        out = x.contiguous().clone()
        dist.all_reduce(out, group=self._group(axes)[0])
        return out

    def _gather(self, x, dim, axes):
        import torch.distributed as dist
        pg, members = self._group(axes)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in members]
        dist.all_gather(parts, x, group=pg)
        return torch.cat(parts, dim)

    def _a2a(self, x, split_dim, cat_dim, axes):
        import torch.distributed as dist
        pg, members = self._group(axes)
        n = len(members)
        send = torch.stack(x.chunk(n, split_dim)).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=pg)
        return torch.cat(recv.unbind(0), cat_dim)

    def ep_group(self, axes) -> EPGroup:
        axes = self.layout.axes(axes)
        if axes not in self._ep:
            pg, members = self._group(axes)
            self._ep[axes] = _CountedDistGroup(self, pg, members)
        return self._ep[axes]


class _CountedDistGroup(DistGroup):
    """``DistGroup`` over one group of a ``DistMesh``, whose exchanges add
    their results' bytes to the mesh's ``collective_bytes``."""

    def __init__(self, rm: DistMesh, pg, members):
        super().__init__(group=pg, device=rm.device, members=members)
        self.rm = rm

    def all_to_all(self, bufs):
        out = super().all_to_all(bufs)
        self.rm._count(out[0])
        return out

    def permute(self, dst, send, recv, stream=None):
        handle = super().permute(dst, send, recv, stream)
        if inverse_round(dst)[self.rank] >= 0:
            self.rm._count(recv(self.rank))
        return handle

    def all_gather(self, parts):
        return self.rm._count(super().all_gather(parts))

    def mean(self, vals):
        return self.rm._count(super().mean(vals))


# ---------------------------------------------------------------------------
# Counting (the dry run on meta)
# ---------------------------------------------------------------------------

class CountingMesh(RankMesh):
    """Rank ``rank`` (0 by default) alone, on ``meta``: every collective
    returns an empty tensor of its result's shape and adds its bytes."""

    def __init__(self, layout, rank: int = 0, device="meta"):
        super().__init__(layout, rank, device)
        self._ep = {}

    def _reduce(self, x, axes):
        return torch.empty_like(x)

    def _gather(self, x, dim, axes):
        shape = list(x.shape)
        shape[dim] *= self.axis_size(axes)
        return x.new_empty(shape)

    def _a2a(self, x, split_dim, cat_dim, axes):
        n = self.axis_size(axes)
        shape = list(x.shape)
        shape[split_dim] //= n
        shape[cat_dim] *= n
        return x.new_empty(shape)

    def ep_group(self, axes) -> EPGroup:
        axes = self.layout.axes(axes)
        if axes not in self._ep:
            self._ep[axes] = _CountingEPGroup(self, axes)
        return self._ep[axes]


class _CountingEPGroup(EPGroup):
    def __init__(self, rank_mesh: CountingMesh, axes):
        self.rm = rank_mesh
        members = rank_mesh.layout.group(rank_mesh.rank, axes)
        self.n = len(members)
        self.ranks = (members.index(rank_mesh.rank),)
        self.device = rank_mesh.device

    @property
    def transport(self) -> str:
        return f"counting (rank {self.ranks[0]} of {self.n})"

    def all_to_all(self, bufs):
        buf, = bufs
        return [self.rm._count(torch.empty_like(buf))]

    def permute(self, dst, send, recv, stream=None):
        me = self.ranks[0]
        if inverse_round(dst)[me] >= 0:
            self.rm._count(recv(me))
        return _DONE

    def all_gather(self, parts):
        part, = parts
        return self.rm._count(part.new_empty(
            (part.shape[0] * self.n,) + tuple(part.shape[1:])))

    def mean(self, vals):
        return self.rm._count(torch.empty_like(vals[0]))
