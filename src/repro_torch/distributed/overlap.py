"""Round-pipelined (overlapped) Aurora dispatch: the paper's Fig 3(b) at
intra-step granularity (port of ``repro/distributed/overlap.py``).

The synchronous EP body (``alltoall._local_dispatch_combine``) is a barrier
pipeline: every dispatch round completes, then the expert FFN runs over
every arrival, then every return round fires. The pipeline here breaks the
barrier over the BvN rounds:

  round r+1's transfer is issued               ─┐  independent, so the
  the FFN runs on the chunk round r delivered   ├─ transfer is in flight
  that chunk returns (transposed round)        ─┘  while the FFN runs

Each round delivers at most one (experts_per_rank, C, d) capacity chunk per
rank; the grouped FFN (``moe_gmm``, with that chunk's exact per-expert
group sizes) runs per chunk, which equals the batched FFN on the
concatenation row for row, and the finished chunk returns through the
**transposed** permutation of its delivery round, still a partial
permutation. Under ``LocalGroup`` on the card the transfers are copies on a
side stream, ordered against the FFN with events; under ``DistGroup`` they
are asynchronous ``batch_isend_irecv`` requests, waited for only when their
data is needed.

The body is differentiable. Each round is one ``_Round`` (an autograd
Function over the held ranks, applied through ``EPGroup._op`` as the
synchronous body's exchanges are), whose backward sends every received
chunk's grad back through the transposed round; each rank's returned
chunks are concatenated in source order, so autograd records every
step. With the plain FFN (``kernels=None``) its grads are the
reference's ``jax.grad`` of the same pipeline.
"""

from __future__ import annotations

import dataclasses

import torch

from .alltoall import (_scatter_buckets, expert_shard, gathered_sizes,
                       rank_ffn)
from .group import _DONE, EPGroup, inverse_round, transpose_round


class _Round(torch.autograd.Function):
    """One partial-permutation round over the held ranks: held rank i sends
    its ``sends`` entry to ``dst[i]`` (the entry of a rank with
    ``dst[i] < 0`` is not read) and gets what its source sent, or an empty
    tensor when no rank sends to it. The transfer's handle goes to
    ``sink``. The transpose is the transposed round over the grads: each
    received chunk's grad goes back to its sender, and a rank that sent
    nothing gets no grad.

    ``links`` (one empty tensor per held rank, the previous round's) carry
    nothing and return a new empty link each: they chain a rank's rounds
    in the order it ran them, and the last link reaches the layer's
    output. So every rank runs every round's backward, including a round
    whose chunk it never received, and runs them in reverse, the same
    order on every rank: a ``DistGroup``'s transposed rounds meet their
    peers in order."""

    @staticmethod
    def forward(ctx, group, dst, stream, sink, *args):
        h = len(group.ranks)
        sends = args[:h]                    # args[h:]: the links
        ctx.group, ctx.dst = group, dst
        ctx.like = [(s.shape, s.dtype, s.device) for s in sends]
        at = {r: k for k, r in enumerate(group.ranks)}
        src = inverse_round(dst)
        recvs = [torch.empty(s.shape, dtype=s.dtype, device=s.device)
                 if src[me] >= 0 else s.new_empty((0,))
                 for me, s in zip(group.ranks, sends)]
        sink.append(group.permute(dst, lambda i: sends[at[i]],
                                  lambda j: recvs[at[j]], stream))
        return tuple(recvs) + tuple(s.new_empty((0,) + tuple(s.shape))
                                    for s in sends)

    @staticmethod
    def backward(ctx, *grads):
        group, dst = ctx.group, ctx.dst
        h = len(group.ranks)
        at = {r: k for k, r in enumerate(group.ranks)}
        ins = [torch.empty(shape, dtype=dtype, device=device)
               if dst[me] >= 0 else None
               for me, (shape, dtype, device) in zip(group.ranks, ctx.like)]
        group.permute(transpose_round(dst), lambda j: grads[at[j]],
                      lambda i: ins[at[i]]).wait()
        return (None,) * 4 + tuple(ins) + (None,) * h


def _round(group: EPGroup, dst, sends, links, stream):
    """``_Round`` over the held ranks' ``sends`` and ``links``: (one
    received tensor per held rank, their new links, the transfer's
    handle). A replayed round (remat's recompute, ``distributed.mesh``)
    ran no transfer: its handle is done."""
    sink = []

    def fn(g, vals):
        h = len(vals)
        out = _Round.apply(g, dst, stream, sink, *(v[0] for v in vals),
                           *(v[1] for v in vals))
        return [(out[k], out[h + k]) for k in range(h)]

    got = group._op(fn, list(zip(sends, links)))
    return ([r for r, _ in got], [lk for _, lk in got],
            sink[0] if sink else _DONE)


def pipelined_local_dispatch_combine(xs, valids, router_w, experts, moe,
                                     act, group: EPGroup, rounds, spec=None,
                                     kernels=None):
    """The round-pipelined rank body over the held ranks: the contract of
    ``alltoall._local_dispatch_combine`` (and token-identical to it).
    ``rounds`` must be an explicit schedule: the pipeline has no
    monolithic all-to-all."""
    if rounds is None:
        raise ValueError("the pipelined dispatch needs explicit permutation "
                         "rounds (aurora_rounds or round_robin_rounds)")
    n = group.n
    scat = [_scatter_buckets(x, v, router_w, moe, spec)
            for x, v in zip(xs, valids)]
    n_phys, cap, d = scat[0].buf.shape
    epd = n_phys // n                                  # experts per rank
    bufs = {me: s.buf.view(n, epd, cap, d)             # bufs[me][s] -> s
            for me, s in zip(group.ranks, scat)}
    sizes = gathered_sizes(group, scat) if kernels is not None else None
    # rows[me][s] = FFN outputs of me's tokens on rank s's experts.
    rows = {me: {} for me in bufs}
    stream = group.comm_stream()
    keep = []          # every chunk a transfer touches, alive to the end
    transfers = []     # every transfer, waited for at the end (a send's
    #                    request must outlive its completion)

    def ffn(me, src, chunk):
        gs = (sizes[src, me * epd:(me + 1) * epd]
              if sizes is not None else None)
        return rank_ffn(expert_shard(experts, me, epd), chunk, act,
                        kernels, gs)

    def flush(pending, dst):
        """Run the FFN on every held rank's arrived chunk, then return the
        outputs through the transposed round of their delivery (the self
        chunks, ``dst`` None, stay local). A rank that received nothing
        in round ``dst`` offers its self chunk's output, which no rank
        reads."""
        ys = {}
        for me, (handle, src, chunk) in pending.items():
            handle.wait()
            ys[me] = ffn(me, src, chunk)
        if dst is None:
            for me, y in ys.items():
                rows[me][me] = y
            return
        sends = [ys.get(j, rows[j][j]) for j in group.ranks]
        got, links[:], handle = _round(group, transpose_round(dst), sends,
                                       links, stream)
        keep.extend(sends + got)
        transfers.append(handle)
        for i, g in zip(group.ranks, got):
            if dst[i] >= 0:
                rows[i][dst[i]] = g

    # Prologue: the self chunks "arrived" before any round; their FFN
    # fills the first round's window (self-traffic never crosses the
    # network).
    pending = {me: (_DONE, me, b[me]) for me, b in bufs.items()}
    links = [bufs[me].new_empty((0, epd, cap, d)) for me in group.ranks]
    prev = None
    for dst in rounds:
        src = inverse_round(dst)
        sends = [bufs[i][max(dst[i], 0)] for i in group.ranks]
        got, links[:], handle = _round(group, dst, sends, links, stream)
        keep.extend(got)
        transfers.append(handle)
        flush(pending, prev)                           # ...compute <= r
        pending = {me: (handle, src[me], c)
                   for me, c in zip(group.ranks, got) if src[me] >= 0}
        prev = dst
    flush(pending, prev)                               # pipeline epilogue
    for h in transfers:
        h.wait()
    ys = []
    for me, s, link in zip(group.ranks, scat, links):
        # A pair that no round covers returns nothing: its row stays zero.
        out = torch.cat([(rows[me][r] if r in rows[me]
                          else bufs[me].new_zeros((epd, cap, d)))[None]
                         for r in range(n)] + [link])
        ys.append(s.combine(out.view(n_phys, cap, d)))
    return ys, [s.aux for s in scat], [s.idx for s in scat]


def pipelined_dispatch_combine(xt, router_w, experts, moe, act, pc,
                               return_counts: bool = False, kernels=None,
                               spec=None):
    """``ep_dispatch_combine`` with the pipeline forced on, whatever
    ``pc.ep_overlap`` and ``pc.moe_impl`` say, so callers can compare the
    two bodies on one ``ParallelContext``."""
    from .alltoall import ep_dispatch_combine

    pc = dataclasses.replace(pc, moe_impl="aurora", ep_overlap=True)
    return ep_dispatch_combine(xt, router_w, experts, moe, act, pc,
                               return_counts=return_counts, kernels=kernels,
                               spec=spec)
