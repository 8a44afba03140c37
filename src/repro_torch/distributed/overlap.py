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
"""

from __future__ import annotations

import dataclasses

import torch

from .alltoall import (_scatter_buckets, expert_shard, gathered_sizes,
                       rank_ffn)
from .group import _DONE, EPGroup, inverse_round, transpose_round


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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (*xs, router_w, *experts.values())):
        raise ValueError("the round-pipelined dispatch has no backward: its "
                         "rounds fill receive buffers in place (train with "
                         "ep_overlap=False; ROADMAP A5)")
    n = group.n
    scat = [_scatter_buckets(x, v, router_w, moe, spec)
            for x, v in zip(xs, valids)]
    n_phys, cap, d = scat[0].buf.shape
    epd = n_phys // n                                  # experts per rank
    bufs = {me: s.buf.view(n, epd, cap, d)             # bufs[me][s] -> s
            for me, s in zip(group.ranks, scat)}
    sizes = gathered_sizes(group, scat) if kernels is not None else None
    # out[me][s] = FFN outputs of me's tokens on rank s's experts.
    outs = {me: torch.zeros((n, epd, cap, d), dtype=b.dtype,
                            device=b.device) for me, b in bufs.items()}
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
        chunks, ``dst`` None, stay local)."""
        ys = {}
        for me, (handle, src, chunk) in pending.items():
            handle.wait()
            ys[me] = ffn(me, src, chunk)
            if dst is None:
                outs[me][me].copy_(ys[me])
        if dst is None:
            return
        keep.extend(ys.values())
        transfers.append(group.permute(
            transpose_round(dst), lambda j: ys[j],
            lambda i: outs[i][dst[i]], stream))

    # Prologue: the self chunks "arrived" before any round; their FFN
    # fills the first round's window (self-traffic never crosses the
    # network).
    pending = {me: (_DONE, me, b[me]) for me, b in bufs.items()}
    prev = None
    for dst in rounds:
        src = inverse_round(dst)
        chunks = {me: torch.empty((epd, cap, d), dtype=b.dtype,
                                  device=b.device)
                  for me, b in bufs.items() if src[me] >= 0}
        keep.extend(chunks.values())
        handle = group.permute(dst, lambda i, dst=dst: bufs[i][dst[i]],
                               lambda j: chunks[j], stream)
        transfers.append(handle)
        flush(pending, prev)                           # ...compute <= r
        pending = {me: (handle, src[me], c) for me, c in chunks.items()}
        prev = dst
    flush(pending, prev)                               # pipeline epilogue
    for h in transfers:
        h.wait()
    ys = [s.combine(outs[me].view(n_phys, cap, d))
          for me, s in zip(group.ranks, scat)]
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
