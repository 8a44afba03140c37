"""Expert-parallel groups: the ranks an EP layer exchanges tokens between.

The counterpart of the JAX package's flat EP mesh axis (``shard_map`` over
``pc.ep_axes``, ``alltoall.flat_axis_index``): n ranks, each hosting a
contiguous block of E/n experts. The rank body of the EP layer
(``alltoall._local_dispatch_combine``, ``overlap.
pipelined_local_dispatch_combine``) is written once, over "the ranks this
process holds" (``EPGroup.ranks``); only the primitives below differ
between the two transports, which the caller picks explicitly:

- ``DistGroup``: ``torch.distributed``, one rank per process (what a
  multi-card deployment runs: ``torchrun``, NCCL; gloo on the CPU). A
  round is one ``batch_isend_irecv`` with at most one send and one
  receive; the monolithic baseline is one ``all_to_all_single``.
- ``LocalGroup(n, device)``: n virtual ranks in one process on one device
  (the counterpart of the reference's host-device mesh). A round is one
  device-to-device copy per (src, dst) pair of its permutation; with a
  ``stream`` the copies go on that side stream, ordered with events.

Primitives: ``all_to_all`` (the baseline exchange), ``permute`` (one
partial permutation round), ``all_gather`` (concatenate one tensor per
rank along dim 0, in rank order) and ``mean`` (the mean of one scalar per
rank, the reference's ``pmean``). They move values and record no grad;
``alltoall.ep_all_to_all``, ``ep_all_gather`` and ``ep_mean`` are the
differentiable exchanges built on them, each an autograd Function whose
backward is its transpose over the same primitives.
"""

from __future__ import annotations

import contextlib

import torch

from ..device import current_cuda_device, resolve_device

__all__ = ["DistGroup", "EPGroup", "LocalGroup", "inverse_round",
           "transpose_round"]


def inverse_round(dst) -> list[int]:
    """src[j] = the rank that sends to j in round ``dst`` (-1: none)."""
    src = [-1] * len(dst)
    for i, j in enumerate(dst):
        if j >= 0:
            src[j] = i
    return src


def transpose_round(dst) -> tuple[int, ...]:
    """The round that sends every transfer of ``dst`` back to its sender
    (still a partial permutation)."""
    return tuple(inverse_round(dst))


class _Done:
    """Handle of a transfer whose results are already visible (also the
    self chunk's in the pipeline)."""

    def wait(self) -> None:
        return None


_DONE = _Done()


class EPGroup:
    """An EP group of ``n`` ranks of which this process holds ``ranks``,
    all on ``device``. Subclasses give the primitives."""

    n: int
    ranks: tuple[int, ...]
    device: torch.device

    def all_to_all(self, bufs):
        """bufs: one (n, ...) tensor per held rank; returns one (n, ...)
        tensor per held rank, out[s] = what rank s sent to this rank."""
        raise NotImplementedError

    def permute(self, dst, send, recv, stream=None):
        """One round: for every pair i -> j = dst[i] (j >= 0), rank j's
        ``recv(j)`` receives rank i's ``send(i)``. ``send``/``recv`` are
        called only for the held ranks that take part. Returns a handle
        whose ``wait()`` makes the received data visible to the current
        stream."""
        raise NotImplementedError

    def all_gather(self, parts):
        """One tensor per held rank -> the concatenation over all n ranks
        along dim 0, in rank order."""
        raise NotImplementedError

    def mean(self, vals):
        """One scalar tensor per held rank -> the mean over all n ranks."""
        raise NotImplementedError

    def comm_stream(self):
        """The side stream the round-pipelined path issues its transfers
        on (None: the current stream)."""
        return None

    def _op(self, fn, values, per_rank: bool = True):
        """``fn(group, values)``: one differentiable exchange
        (``alltoall.ep_all_to_all``, ``ep_all_gather``, ``ep_mean``, a
        round of ``overlap``'s pipeline) over the held ranks' ``values``
        (a tensor or a tuple of tensors each), returning one result per
        held rank (``per_rank``) or one for them all. A mesh's EP groups
        run it jointly over a thread group with grad, and keep or replay
        its result under remat (``distributed.mesh``)."""
        return fn(self, values)

    @property
    def transport(self) -> str:
        raise NotImplementedError


class LocalGroup(EPGroup):
    """``n`` virtual ranks in this process, all on ``device`` (the card
    unless another is given). Each
    exchange is a set of copies between the ranks' buffers; ``copies``
    and ``copy_bytes`` count the round copies (self-traffic excluded)."""

    def __init__(self, n: int, device="cuda"):
        if n < 1:
            raise ValueError(f"an EP group needs >= 1 rank, got {n}")
        self.n = int(n)
        self.ranks = tuple(range(self.n))
        self.device = resolve_device(device)
        self._stream = None
        self.copies = 0
        self.copy_bytes = 0

    @property
    def transport(self) -> str:
        return f"in-process ({self.n} ranks on {self.device})"

    def all_to_all(self, bufs):
        out = torch.stack(bufs).transpose(0, 1).contiguous()
        return list(out.unbind(0))

    def permute(self, dst, send, recv, stream=None):
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(self.device))
        with ctx:
            for i, j in enumerate(dst):
                if j >= 0:
                    src = send(i)
                    recv(j).copy_(src)
                    self.copies += 1
                    self.copy_bytes += src.numel() * src.element_size()
            if stream is None:
                return _DONE
            event = torch.cuda.Event()
            event.record(stream)
        return _EventHandle(event, self.device)

    def all_gather(self, parts):
        return torch.cat(parts)

    def mean(self, vals):
        return torch.stack(vals).sum() / self.n

    def comm_stream(self):
        if self.device.type != "cuda":
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream


class _EventHandle:
    def __init__(self, event, device):
        self.event, self.device = event, device

    def wait(self) -> None:
        torch.cuda.current_stream(self.device).wait_event(self.event)


class _Requests:
    """Handle of outstanding point-to-point requests. Idempotent: a second
    ``wait`` returns at once (gloo's point-to-point ``Work.wait`` is not:
    it would wait for a second message)."""

    def __init__(self, reqs):
        self.reqs = reqs

    def wait(self) -> None:
        for r in self.reqs:
            r.wait()
        self.reqs = ()


class DistGroup(EPGroup):
    """This process's rank of a ``torch.distributed`` process group
    (``group=None``: the default group; ``members``: the global ranks of
    the group, in group-rank order). The process group must already be
    initialised. ``device``: the current CUDA device when None (a gloo
    group runs on ``"cpu"``)."""

    def __init__(self, group=None, device=None, members=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("DistGroup needs an initialised process "
                               "group (torch.distributed."
                               "init_process_group)")
        self.pg = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks = (self.rank,)
        self.members = (tuple(members) if members is not None
                        else tuple(range(self.n)))
        if len(self.members) != self.n:
            raise ValueError(f"{len(self.members)} members for a group of "
                             f"{self.n}")
        self.device = (current_cuda_device() if device is None
                       else resolve_device(device))

    @property
    def transport(self) -> str:
        import torch.distributed as dist
        return (f"torch.distributed {dist.get_backend(self.pg)} (rank "
                f"{self.rank} of {self.n})")

    def all_to_all(self, bufs):
        import torch.distributed as dist
        buf, = bufs
        buf = buf.contiguous()
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf, group=self.pg)
        return [out]

    def permute(self, dst, send, recv, stream=None):
        import torch.distributed as dist
        me = self.rank
        ops = []
        j = dst[me]
        if j >= 0:
            ops.append(dist.P2POp(dist.isend, send(me).contiguous(),
                                  self.members[j], self.pg))
        src = inverse_round(dst)[me]
        if src >= 0:
            ops.append(dist.P2POp(dist.irecv, recv(me), self.members[src],
                                  self.pg))
        if not ops:
            return _DONE
        return _Requests(dist.batch_isend_irecv(ops))

    def all_gather(self, parts):
        import torch.distributed as dist
        part, = parts
        part = part.contiguous()
        out = [torch.empty_like(part) for _ in range(self.n)]
        dist.all_gather(out, part, group=self.pg)
        return torch.cat(out)

    def mean(self, vals):
        import torch.distributed as dist
        v = vals[0].detach().clone()
        dist.all_reduce(v, group=self.pg)
        return v / self.n
