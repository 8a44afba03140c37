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
``collective_bytes_from_hlo``), the EP group's exchanges included; those
exchanges (the monolithic all-to-all or the rounds) also add theirs to
``exchange_bytes``, the share ``roofline.ep_round_bytes`` reckons.

Three transports, picked explicitly (no fallback from one to another):

- ``ThreadMesh``: every rank a Python thread in this process, on one
  device (the card by default; the CPU tests pass ``"cpu"``). A collective
  meets at a barrier of all ranks and each member combines the group's
  tensors in group order, so a sum is the same on every member and from
  run to run. The threads share the device's current stream, so a
  tensor another rank made is ready for this rank's kernels in stream
  order.
- ``DistMesh``: this process's rank of a ``torch.distributed`` world of
  ``layout.size`` ranks, one subgroup per group of every axis subset, on
  the current CUDA device unless ``device`` is given (a gloo world on
  the CPU passes ``"cpu"``).
- ``CountingMesh``: rank 0 alone on the ``meta`` device (the dry run).
  Its collectives return empty tensors of the result's shape and count
  their bytes. Rank 0 stands for every rank: the sharding rules split a
  dim only when the axis divides it, so every rank holds the same
  shapes and runs the same ops.

Gradients. Each collective is one ``torch.autograd.Function``
(``_AllReduce``, ``_AllGather``, ``_AllToAll``, shared by the three
transports) whose backward runs its transpose through the same
primitives, so a loss's grads cross the ranks. The convention, once for
every backward: the rank program is one function of every rank's
tensors, and a value that several ranks hold (an activation replicated
over ``model``, a replicated leaf, the loss that a batch shard's
``model`` peers each compute) has as its grad the SUM of its copies'
partial grads. So ``all_reduce`` transposes to ``all_reduce``,
``all_gather`` to a reduce-scatter (the grad split into the members'
blocks by an all-to-all and summed over the members in group order) and
``all_to_all`` to the all-to-all with ``split_dim`` and ``cat_dim``
swapped. A rank seeds its backward with its loss over ``layout.size``
(``training.loop``: the seeds then sum to the mean over the batch
shards), and a leaf's grad is summed over the axes that replicate it
(``training.loop.reduce_replicas``). No identity-forward op is needed
where a replicated activation enters a split product: its copies'
partial grads are summed where they meet a collective's transpose.

Remat. Under ``torch.utils.checkpoint`` (``transformer.forward(remat=
True)``) a block's recompute replays the block's collective results
(``remat_contexts``, the checkpoint's ``context_fn``) instead of running
its collectives again: the results are kept, at the memory of one output
a collective, and a step moves and counts its forward's and its
backward's collectives, on every transport alike.

Thread ranks and autograd. The engine runs every CUDA node of every
backward on one worker thread per device, so a collective's backward
that waited at the barrier for the other thread ranks would block the
only thread that could run them (and so would a recompute's collective).
So with grad a thread rank's collective is one graph node over its whole
group: at the exchange the group's first member applies the Function to
every member's tensor (``_Joint``) and each member takes its own result;
``RankMesh.grad`` on a ``ThreadMesh`` is one backward over every rank's
loss, run from rank 0's thread while the others wait, and no backward
node waits for a thread. Without grad (serving) each member combines its
own result. ``DistMesh`` ranks each run their own backward; their
collectives' backward nodes run in the same order on every rank, as
their forwards do.
"""

from __future__ import annotations

import functools
import itertools
import threading

import torch
from torch.utils._python_dispatch import _disable_current_modes

from ..bridge import map_tree, tree_leaves
from ..device import current_cuda_device, resolve_device
from .group import _DONE, DistGroup, EPGroup, LocalGroup, inverse_round

__all__ = ["CountingMesh", "DistMesh", "RankMesh", "ThreadMesh"]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# The collectives as autograd Functions over the ranks a call holds
# ---------------------------------------------------------------------------
#
# ``held`` is what runs the primitives: a ``RankMesh`` (this rank's tensor
# alone) or a ``_Joint`` (every member of a thread group). Its
# ``_held_reduce`` / ``_held_gather`` / ``_held_a2a`` take and return one
# tensor per held rank and count each result on its rank.

class _AllReduce(torch.autograd.Function):
    """The sum over a group; its transpose is itself."""

    @staticmethod
    def forward(ctx, held, axes, *xs):
        ctx.held, ctx.axes = held, axes
        return held._held_reduce(xs, axes)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + ctx.held._held_reduce(gs, ctx.axes)


class _AllGather(torch.autograd.Function):
    """The concatenation along ``dim`` over a group; its transpose is a
    reduce-scatter: each member's grad split into the members' blocks by
    an all-to-all, and the blocks a member receives summed in group
    order."""

    @staticmethod
    def forward(ctx, held, axes, dim, *xs):
        ctx.held, ctx.axes, ctx.dim = held, axes, dim
        return held._held_gather(xs, dim, axes)

    @staticmethod
    def backward(ctx, *gs):
        parts = ctx.held._held_a2a(tuple(g[None] for g in gs), ctx.dim + 1,
                                   0, ctx.axes)
        return (None, None, None) + tuple(p.sum(0) for p in parts)


class _AllToAll(torch.autograd.Function):
    """The all-to-all; its transpose swaps ``split_dim`` and
    ``cat_dim``."""

    @staticmethod
    def forward(ctx, held, axes, split_dim, cat_dim, *xs):
        ctx.held, ctx.axes, ctx.dims = held, axes, (split_dim, cat_dim)
        return held._held_a2a(xs, split_dim, cat_dim, axes)

    @staticmethod
    def backward(ctx, *gs):
        split_dim, cat_dim = ctx.dims
        return (None,) * 4 + ctx.held._held_a2a(gs, cat_dim, split_dim,
                                                ctx.axes)


class _Kept:
    """One checkpointed region's collective results on one rank, in the
    order its forward made them (detached, with whether each needed
    grad); its recompute replays them in that order."""

    def __init__(self):
        self.outs = []
        self.next = 0


class _KeptTensor:
    """A kept result, detached, and whether it needed grad."""

    def __init__(self, t):
        self.t, self.grad = t.detach(), t.requires_grad


class _RematMode:
    """The checkpoint's forward (``replay=False``: keep each result) or
    recompute (``replay=True``: hand the kept results back) context of
    one region on one rank."""

    def __init__(self, rm, kept: _Kept, replay: bool):
        self.rm, self.kept, self.replay = rm, kept, replay

    def __enter__(self):
        self.prev = self.rm._remat
        self.kept.next = 0
        self.rm._remat = (self.kept, self.replay)

    def __exit__(self, *exc):
        self.rm._remat = self.prev


class RankMesh:
    """One rank's view of a ``MeshLayout``. Subclasses give ``_reduce``,
    ``_gather``, ``_a2a`` and ``ep_group``."""

    def __init__(self, layout, rank: int, device):
        self.layout = layout
        self.rank = int(rank)
        self.device = torch.device(device)
        self.collective_bytes = 0
        self.exchange_bytes = 0
        self._remat = None

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

    def _count(self, out, exchange: bool = False):
        self.collective_bytes += _nbytes(out)
        if exchange:
            self.exchange_bytes += _nbytes(out)
        return out

    def all_reduce(self, x, axes):
        if self.axis_size(axes) == 1:
            return x
        return self._collective(_AllReduce, x, self.layout.axes(axes))

    def all_gather(self, x, dim: int, axes):
        if self.axis_size(axes) == 1:
            return x
        return self._collective(_AllGather, x, self.layout.axes(axes),
                                dim % x.ndim)

    def all_to_all(self, x, split_dim: int, cat_dim: int, axes):
        n = self.axis_size(axes)
        if n == 1:
            return x
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all splits dim {split_dim} of "
                             f"{tuple(x.shape)} into {n} chunks")
        return self._collective(_AllToAll, x, self.layout.axes(axes),
                                split_dim % x.ndim, cat_dim % x.ndim)

    def _collective(self, fn, x, axes, *args):
        return self._replayed(lambda: self._apply(fn, x, axes, *args))

    def _apply(self, fn, x, axes, *args):
        """``fn`` (a collective's Function) over this rank's ``x``."""
        return fn.apply(self, axes, *args, x)[0]

    # The primitives over the held ranks' tensors: this rank's alone.
    def _held_reduce(self, xs, axes):
        return tuple(self._count(self._reduce(x, axes)) for x in xs)

    def _held_gather(self, xs, dim, axes):
        return tuple(self._count(self._gather(x, dim, axes)) for x in xs)

    def _held_a2a(self, xs, split_dim, cat_dim, axes):
        return tuple(self._count(self._a2a(x, split_dim, cat_dim, axes))
                     for x in xs)

    # -- remat ---------------------------------------------------------------
    def remat_contexts(self):
        """The (forward, recompute) contexts of one checkpointed region
        (``torch.utils.checkpoint``'s ``context_fn``): its forward keeps
        each collective result of this rank, its recompute replays them in
        order and runs no collective."""
        kept = _Kept()
        return _RematMode(self, kept, False), _RematMode(self, kept, True)

    def _replayed(self, run):
        """``run()`` (a collective, or an EP group's exchange), kept for a
        checkpointed region's recompute or replayed by it."""
        if self._remat is None:
            return run()
        kept, replay = self._remat
        if replay:
            out = kept.outs[kept.next]
            kept.next += 1
            return map_tree(lambda k: k.t.detach().requires_grad_(k.grad),
                            out)
        out = run()
        kept.outs.append(map_tree(_KeptTensor, out))
        return out

    # -- backward ------------------------------------------------------------
    def grad(self, loss, inputs):
        """The grads of the sum over every rank of its ``loss`` (the
        convention of the module docstring) with respect to this rank's
        ``inputs``; None for an input the loss does not reach. Every rank
        calls it."""
        return torch.autograd.grad(loss, list(inputs), allow_unused=True)


# ---------------------------------------------------------------------------
# In-process ranks (threads)
# ---------------------------------------------------------------------------

class ThreadMesh:
    """``layout.size`` ranks as threads of this process on ``device`` (the
    card unless another is given).
    ``run(fn)`` calls ``fn(rank_mesh)`` on every rank at once and returns
    the results in rank order (a rank's exception is raised once every
    thread has stopped). A rank that waits ``timeout`` seconds at a
    collective for the others (a rank program whose ranks call different
    collectives) breaks it, and ``run`` raises."""

    def __init__(self, layout, device="cuda", timeout: float = 600.0):
        self.layout = layout
        self.device = resolve_device(device)
        self._slots = [None] * layout.size
        self._grad = [False] * layout.size
        self._results = [None] * layout.size
        self._barrier = threading.Barrier(layout.size, timeout=timeout)
        self.ranks = [ThreadRank(self, r) for r in range(layout.size)]

    def _exchange(self, rank: int, value, combine, out=None,
                  grad: bool = False, members=None):
        """Deposit ``value``, wait for every rank, run ``combine(slots)``
        (which fills ``out``), wait again, and return ``out``. ``out`` is
        made by the caller, like the counting transport's result, and
        ``combine`` runs with this thread's dispatch modes off: the dry
        run's trackers (``launch.dryrun``) then see one new storage per
        collective, as on ``meta``, and never the views of other ranks'
        tensors that combining makes. ``grad``: whether this rank's call
        takes the joint path; the ``members`` of its group must agree."""
        self._slots[rank] = value
        self._grad[rank] = grad
        self._barrier.wait()
        try:
            if members is not None and len(
                    {self._grad[m] for m in members}) > 1:
                raise RuntimeError("the ranks of a group disagree on "
                                   "whether a collective needs grad")
            with _disable_current_modes():
                combine(self._slots)
        finally:
            self._barrier.wait()
        self._slots[rank] = None
        return out

    def _joint(self, rank: int, members, value, apply):
        """One collective as one graph node over the group ``members``:
        every member deposits ``value``; the first runs ``apply(member
        ranks, their values)`` (one result per member, or one for all)
        and each member returns its own."""
        def combine(slots):
            if rank != members[0]:
                return
            outs = apply([self.ranks[m] for m in members],
                         [slots[m] for m in members])
            if not isinstance(outs, (list, tuple)):
                outs = [outs] * len(members)
            for m, o in zip(members, outs):
                self._results[m] = o
        self._exchange(rank, value, combine, grad=True, members=members)
        out, self._results[rank] = self._results[rank], None
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
        self._results = [None] * self.layout.size
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


class _Joint:
    """A thread group's members at once, as its first member holds them
    during an exchange: the primitives over every member's tensor (in
    group order), each result counted on its member's rank."""

    def __init__(self, ranks):
        self.ranks = ranks

    def _out(self, outs):
        return tuple(r._count(o) for r, o in zip(self.ranks, outs))

    def _held_reduce(self, xs, axes):
        total = xs[0].clone(memory_format=torch.contiguous_format)
        for x in xs[1:]:
            total.add_(x)
        return self._out([total] + [total.clone() for _ in xs[1:]])

    def _held_gather(self, xs, dim, axes):
        cat = torch.cat(xs, dim)
        return self._out([cat] + [cat.clone() for _ in xs[1:]])

    def _held_a2a(self, xs, split_dim, cat_dim, axes):
        chunks = [x.chunk(len(xs), split_dim) for x in xs]
        return self._out([torch.cat([c[me] for c in chunks], cat_dim)
                          for me in range(len(xs))])


class ThreadRank(RankMesh):
    """One thread's rank of a ``ThreadMesh``."""

    def __init__(self, mesh: ThreadMesh, rank: int):
        super().__init__(mesh.layout, rank, mesh.device)
        self.mesh = mesh
        self._ep = {}

    def _members(self, axes):
        return self.layout.group(self.rank, axes)

    def _apply(self, fn, x, axes, *args):
        if not (torch.is_grad_enabled() and x.requires_grad):
            return super()._apply(fn, x, axes, *args)
        return self.mesh._joint(self.rank, self._members(axes), x,
                                lambda ranks, xs: fn.apply(
                                    _Joint(ranks), axes, *args, *xs))

    def _plain(self, x, axes, combine, out):
        return self.mesh._exchange(self.rank, x, combine, out,
                                   members=self._members(axes))

    def _reduce(self, x, axes):
        out = torch.empty_like(x)
        return self._plain(x, axes, functools.partial(
            _sum_into, out, self._members(axes)), out)

    def _gather(self, x, dim, axes):
        members = self._members(axes)
        shape = list(x.shape)
        shape[dim] *= len(members)
        out = x.new_empty(shape)
        return self._plain(x, axes, lambda s: torch.cat(
            [s[r] for r in members], dim, out=out), out)

    def _a2a(self, x, split_dim, cat_dim, axes):
        members = self._members(axes)
        me = members.index(self.rank)
        n = len(members)
        shape = list(x.shape)
        shape[split_dim] //= n
        shape[cat_dim] *= n
        out = x.new_empty(shape)
        return self._plain(x, axes, lambda s: torch.cat(
            [s[r].chunk(n, split_dim)[me] for r in members], cat_dim,
            out=out), out)

    def grad(self, loss, inputs):
        """One backward over every rank's loss, from rank 0's thread (the
        module docstring); each rank gets its inputs' grads."""
        def apply(ranks, values):
            flat = [t for _, ins in values for t in ins]
            gs = torch.autograd.grad([lo for lo, _ in values], flat,
                                     allow_unused=True)
            out, i = [], 0
            for _, ins in values:
                out.append(gs[i:i + len(ins)])
                i += len(ins)
            return out
        return self.mesh._joint(self.rank, tuple(range(self.layout.size)),
                                (loss, list(inputs)), apply)

    def ep_group(self, axes) -> EPGroup:
        axes = self.layout.axes(axes)
        if axes not in self._ep:
            self._ep[axes] = _ThreadEPGroup(self, axes)
        return self._ep[axes]


class _ThreadEPGroup(EPGroup):
    """The flat EP group over ``axes`` seen from one thread rank: it holds
    that one rank (``ranks == (its index,)``), as a ``DistGroup`` does.
    With grad, an exchange runs once for the whole group on a
    ``_JointEPGroup`` (the module docstring's joint path)."""

    def __init__(self, rank_mesh: ThreadRank, axes):
        self.rm = rank_mesh
        self.members = rank_mesh.layout.group(rank_mesh.rank, axes)
        self.n = len(self.members)
        self.ranks = (self.members.index(rank_mesh.rank),)
        self.device = rank_mesh.device

    @property
    def transport(self) -> str:
        return f"in-process thread (rank {self.ranks[0]} of {self.n})"

    def _op(self, fn, values, per_rank: bool = True):
        value, = values
        rm = self.rm
        if not (torch.is_grad_enabled() and any(
                t.requires_grad for t in tree_leaves(value))):
            return rm._replayed(lambda: fn(self, values))

        def joint():
            out = rm.mesh._joint(rm.rank, self.members, value,
                                 lambda ranks, vals: fn(_JointEPGroup(
                                     ranks, self.device), vals))
            return [out] if per_rank else out
        return rm._replayed(joint)

    def _x(self, value, combine, out, exchange: bool = False):
        return self.rm._count(self.rm.mesh._exchange(
            self.rm.rank, value, combine, out, members=self.members),
            exchange)

    def all_to_all(self, bufs):
        buf, = bufs
        me = self.ranks[0]
        out = torch.empty_like(buf)
        return [self._x(buf, lambda s: torch.stack(
            [s[r][me] for r in self.members], out=out), out, True)]

    def permute(self, dst, send, recv, stream=None):
        me = self.ranks[0]
        value = send(me) if dst[me] >= 0 else None
        src = inverse_round(dst)[me]
        if src < 0:
            self.rm.mesh._exchange(self.rm.rank, value, lambda s: None)
            return _DONE
        out = recv(me)
        self._x(value, lambda s: out.copy_(s[self.members[src]]), out, True)
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


class _JointEPGroup(LocalGroup):
    """A thread EP group's members at once (``_Joint``'s EP form): the
    in-process exchanges of a ``LocalGroup`` over every member's buffers,
    each result counted on its member's rank as the thread group counts
    it."""

    def __init__(self, ranks, device):
        super().__init__(len(ranks), device)
        self.rms = ranks

    def all_to_all(self, bufs):
        outs = super().all_to_all(bufs)
        for rm, o in zip(self.rms, outs):
            rm._count(o, True)
        return outs

    def permute(self, dst, send, recv, stream=None):
        handle = super().permute(dst, send, recv, stream)
        for j, i in enumerate(inverse_round(dst)):
            if i >= 0:
                self.rms[j]._count(recv(j), True)
        return handle

    def all_gather(self, parts):
        out = super().all_gather(parts)
        for rm in self.rms:
            rm._count(out)
        return out

    def mean(self, vals):
        out = super().mean(vals)
        for rm in self.rms:
            rm._count(out)
        return out


# ---------------------------------------------------------------------------
# torch.distributed
# ---------------------------------------------------------------------------

class DistMesh(RankMesh):
    """This process's rank of an initialised ``torch.distributed`` world of
    ``layout.size`` ranks (rank r at the layout's flat index r). Every
    process must build it, in the same order: it makes one subgroup per
    group of every proper subset of the axes (``dist.new_group`` is
    collective); the whole mesh is the default group. ``device``: the
    current CUDA device when None (a gloo world runs on ``"cpu"``)."""

    def __init__(self, layout, device=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs an initialised process group")
        device = (current_cuda_device() if device is None
                  else resolve_device(device))
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
    their results' bytes to the mesh's ``collective_bytes`` (and are
    replayed by a checkpointed region's recompute)."""

    def __init__(self, rm: DistMesh, pg, members):
        super().__init__(group=pg, device=rm.device, members=members)
        self.rm = rm

    def _op(self, fn, values, per_rank: bool = True):
        return self.rm._replayed(lambda: fn(self, values))

    def all_to_all(self, bufs):
        out = super().all_to_all(bufs)
        self.rm._count(out[0], True)
        return out

    def permute(self, dst, send, recv, stream=None):
        handle = super().permute(dst, send, recv, stream)
        if inverse_round(dst)[self.rank] >= 0:
            self.rm._count(recv(self.rank), True)
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

    def _op(self, fn, values, per_rank: bool = True):
        return self.rm._replayed(lambda: fn(self, values))

    def all_to_all(self, bufs):
        buf, = bufs
        return [self.rm._count(torch.empty_like(buf), True)]

    def permute(self, dst, send, recv, stream=None):
        me = self.ranks[0]
        if inverse_round(dst)[me] >= 0:
            self.rm._count(recv(me), True)
        return _DONE

    def all_gather(self, parts):
        part, = parts
        return self.rm._count(part.new_empty(
            (part.shape[0] * self.n,) + tuple(part.shape[1:])))

    def mean(self, vals):
        return self.rm._count(torch.empty_like(vals[0]))
