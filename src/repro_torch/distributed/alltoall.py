"""Expert-parallel dispatch/combine (port of ``repro/distributed/alltoall.py``).

The MoE all-to-all is realised two ways, over an ``EPGroup``
(``distributed.group``):

1. **Baseline**: one monolithic all-to-all per phase
   (``EPGroup.all_to_all``: ``all_to_all_single`` across processes, one
   transposing copy in-process).
2. **Aurora**: the paper's Thm 4.2 schedule, a static sequence of
   **permutation rounds**. Each round is a (partial) permutation of the
   ranks, so every rank sends to at most one peer and receives from at
   most one peer: the contention-free invariant. The round order comes
   from ``repro_torch.core.schedule`` on historical traffic (§2.4).

Both move identical bytes. The round builders are host-side numpy and
equal the reference's exactly. Where the reference's rank body runs once
per mesh device inside ``shard_map``, the port's runs over the ranks this
process holds (``EPGroup.ranks``: one under ``DistGroup``, all n under
``LocalGroup``). The expert FFN of a rank is the ``moe_gmm`` kernel
(``kernels.ops.moe_ffn``) when a ``KernelConfig`` is given, else the plain
grouped FFN; the reference runs ``ffn_apply`` under ``vmap`` there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.schedule import check_partial_permutation, \
    validate_permutation_slots
from .group import EPGroup, inverse_round, transpose_round

__all__ = ["aurora_rounds_from_schedule", "ep_all_gather", "ep_all_to_all",
           "ep_dispatch_combine", "ep_mean", "round_robin_rounds",
           "validate_rounds_cover"]


# ---------------------------------------------------------------------------
# Round construction (host side)
# ---------------------------------------------------------------------------

def round_robin_rounds(n: int) -> tuple[tuple[int, ...], ...]:
    """Default contention-free cover: n-1 cyclic-shift permutations.

    Round r sends i -> (i + r) mod n. Every ordered pair appears exactly
    once and every round is a full permutation: the unscheduled
    (traffic-blind) member of the family Aurora optimises over.
    """
    return tuple(
        tuple((i + r) % n for i in range(n)) for r in range(1, n)
    )


def aurora_rounds_from_schedule(schedule, n: int) -> tuple[tuple[int, ...], ...]:
    """Collapse a ``CommSchedule`` into one exchange round per (src, dst)
    pair.

    The BvN schedule may split a pair across slots; the static lowering
    moves each pair's whole capacity bucket in the slot where the pair
    FIRST appears, which keeps Aurora's ordering (heavy pairs early,
    contention-free rounds). Pairs absent from the schedule (zero
    historical traffic) are appended as round-robin cleanup rounds, so the
    exchange stays correct under traffic drift. A single device needs no
    rounds; malformed slots raise (``validate_permutation_slots``).
    """
    validate_permutation_slots(schedule.slots, n)
    if n == 1:
        return ()
    seen = np.zeros((n, n), dtype=bool)
    rounds: list[tuple[int, ...]] = []
    for slot in schedule.slots:
        dst = []
        any_new = False
        for i, j in enumerate(slot.dst):
            if j >= 0 and not seen[i, j]:
                seen[i, j] = True
                dst.append(j)
                any_new = True
            else:
                dst.append(-1)
        if any_new:
            rounds.append(tuple(dst))
    # Cleanup: cover never-seen off-diagonal pairs with round-robin shifts.
    for r in range(1, n):
        dst = []
        any_new = False
        for i in range(n):
            j = (i + r) % n
            if not seen[i, j]:
                seen[i, j] = True
                dst.append(j)
                any_new = True
            else:
                dst.append(-1)
        if any_new:
            rounds.append(tuple(dst))
    return tuple(rounds)


def validate_rounds_cover(rounds, n: int) -> tuple[tuple[int, ...], ...]:
    """Demand a full contention-free cover from a literal round sequence.

    The exchange trusts ``rounds``: a missing (src, dst) pair leaves that
    bucket as zeros (tokens silently vanish), a duplicate delivers one
    bucket twice. Rounds installed verbatim (``swap_rounds``, the engines'
    ``rounds=``) go through here so misuse fails loudly. Returns the
    normalised tuple.
    """
    rounds = tuple(check_partial_permutation(r, n, f"round {r_i}")
                   for r_i, r in enumerate(rounds))
    seen = np.zeros((n, n), dtype=int)
    for dst in rounds:
        for i, j in enumerate(dst):
            if j >= 0:
                seen[i, j] += 1
    off = ~np.eye(n, dtype=bool)
    if n > 1 and not (seen[off] == 1).all():
        missing = int((seen[off] == 0).sum())
        dup = int((seen[off] > 1).sum())
        raise ValueError(
            f"rounds are not an exact cover of the {n}-device exchange: "
            f"{missing} ordered pair(s) never exchanged (their token "
            f"buckets would silently vanish), {dup} exchanged more than "
            "once")
    return rounds


# ---------------------------------------------------------------------------
# Exchange
# ---------------------------------------------------------------------------

def _exchange_rounds(bufs, group: EPGroup, rounds):
    """Scheduled exchange: one (n, ...) buffer per held rank; out[s] =
    row ``me`` of rank s's buffer. Equivalent to the all-to-all, expressed
    as the round sequence; rows no round delivers stay zero. Self-traffic
    never crosses the network (§4.2 footnote 1). The results are
    contiguous whatever the buffers' strides (a backward's grads may be
    transposed views): a ``DistGroup`` receives into their rows."""
    held = dict(zip(group.ranks, bufs))
    outs = {me: torch.zeros(b.shape, dtype=b.dtype, device=b.device)
            for me, b in held.items()}
    for dst in rounds:
        src = inverse_round(dst)
        group.permute(dst, lambda i, dst=dst: held[i][dst[i]],
                      lambda j, src=src: outs[j][src[j]]).wait()
    for me, b in held.items():
        outs[me][me].copy_(b[me])
    return [outs[me] for me in group.ranks]


def _raw_exchange(bufs, group: EPGroup, rounds):
    if rounds is not None:
        return _exchange_rounds(bufs, group, rounds)
    return group.all_to_all(bufs)


class _Exchange(torch.autograd.Function):
    """The dispatch exchange; its transpose is the same exchange with each
    round transposed (``transpose_round``: every transfer sent back to its
    sender), the monolithic all-to-all's is the all-to-all itself."""

    @staticmethod
    def forward(ctx, group, rounds, *bufs):
        ctx.group, ctx.rounds = group, rounds
        return tuple(_raw_exchange(list(bufs), group, rounds))

    @staticmethod
    def backward(ctx, *grads):
        rounds = (None if ctx.rounds is None else
                  tuple(transpose_round(r) for r in ctx.rounds))
        return (None, None) + tuple(_raw_exchange(list(grads), ctx.group,
                                                  rounds))


def _spread(g, held: int):
    """The grad of an output that a call's held ranks share, as the first
    held rank's (the others' zero): one held rank's output carries only
    its own consumers' grad, while a shared one carries them all."""
    return [g] + [torch.zeros_like(g)] * (held - 1)


class _Gather(torch.autograd.Function):
    """``group.all_gather``; its transpose is a reduce-scatter: the grad
    cut into the ranks' blocks, exchanged, and summed over the senders."""

    @staticmethod
    def forward(ctx, group, *parts):
        ctx.group = group
        return group.all_gather(list(parts))

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        bufs = [b.reshape((group.n, -1) + tuple(g.shape[1:]))
                for b in _spread(g, len(group.ranks))]
        return (None,) + tuple(b.sum(0) for b in group.all_to_all(bufs))


class _Mean(torch.autograd.Function):
    """``group.mean``; its transpose is the mean of the grads."""

    @staticmethod
    def forward(ctx, group, *vals):
        ctx.group = group
        return group.mean(list(vals))

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        m = group.mean(_spread(g, len(group.ranks)))
        return (None,) + tuple(m.clone() for _ in group.ranks)


def ep_all_to_all(bufs, group: EPGroup, rounds=None):
    """Dispatch exchange over the EP group. ``bufs``: one (n, ...) tensor
    per held rank, row s bound for rank s. Returns one (n, ...) tensor per
    held rank, row s = what rank s sent to it. ``rounds=None``: the
    monolithic all-to-all; otherwise the Aurora round schedule. It is
    differentiable (``_Exchange``)."""
    return list(group._op(lambda g, bs: _Exchange.apply(g, rounds, *bs),
                          bufs))


def ep_all_gather(parts, group: EPGroup):
    """``group.all_gather`` (one tensor per held rank -> their
    concatenation over all n ranks along dim 0), differentiable."""
    return group._op(lambda g, ps: _Gather.apply(g, *ps), parts,
                     per_rank=False)


def ep_mean(vals, group: EPGroup):
    """``group.mean`` (one scalar per held rank -> the mean over all n
    ranks, the reference's ``pmean``), differentiable."""
    return group._op(lambda g, vs: _Mean.apply(g, *vs), vals,
                     per_rank=False)


# ---------------------------------------------------------------------------
# Dispatch -> expert FFN -> combine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Buckets:
    """One rank's dispatch: its tokens in per-(physical)-expert capacity
    buckets ``buf`` (E', C, d); ``sizes`` (E',) int32 kept rows per
    bucket (a prefix of each); ``combine`` maps returned (E', C, d) expert
    outputs back onto the rank's tokens (gate-weighted scatter-add);
    ``aux`` the rank's load-balance loss; ``idx`` (t_loc, k) its routing."""

    buf: torch.Tensor
    sizes: torch.Tensor
    combine: Callable
    aux: torch.Tensor
    idx: torch.Tensor


def _scatter_buckets(xt, valid, router_w, moe, spec=None) -> Buckets:
    """Shared dispatch prologue of the sync and pipelined bodies: route the
    rank's token slice and scatter it into per-expert capacity buckets.

    ``spec`` (a ``moe.ReplicationSpec``) widens the bucket frame to the
    physical expert count: routing, capacity and drops stay LOGICAL, then
    kept rank r of expert e lands on replica ``r % r_e`` at position
    ``r // r_e`` (the local paths' shard-of-token rule)."""
    from ..models.moe import (capacity, combine, dispatch_indices,
                              physical_group_sizes, physical_slots, route)

    t_loc, d = xt.shape
    e = moe.n_experts
    gates, idx, aux = route(router_w, xt, moe)
    cap = capacity(t_loc, moe.top_k, e, moe.capacity_factor)
    slot, keep = dispatch_indices(idx, e, cap)
    keep = keep & valid[:, None]

    t_f = torch.arange(t_loc, device=xt.device)[:, None].expand(
        idx.shape).reshape(-1)
    k_f = keep.reshape(-1)
    e_l = idx.reshape(-1).long()
    kept = torch.zeros(e, dtype=torch.int32, device=xt.device).index_add_(
        0, e_l, k_f.to(torch.int32))
    e_f, s_f = physical_slots(spec, e_l, slot.reshape(-1).long())
    n_phys = spec.n_phys if spec is not None else e
    safe_s = torch.where(k_f, s_f, cap - 1)
    buf = torch.zeros((n_phys, cap, d), dtype=xt.dtype, device=xt.device)
    buf.index_put_((e_f, safe_s), torch.where(k_f[:, None], xt[t_f], 0.0),
                   accumulate=True)

    def combine_back(back):
        picked = torch.where(k_f[:, None], back[e_f, safe_s], 0.0)
        return combine(picked, gates)

    return Buckets(buf, physical_group_sizes(spec, kept), combine_back, aux,
                   idx)


def _replicated_counts(idxs, valids, n_experts: int, group: EPGroup):
    """The (T_pad, E) per-token routed-choice histogram, replicated on every
    rank: each rank's (t_loc, E) ``routed_counts`` slice, pad rows zeroed,
    gathered in rank order (the reference scatters and ``psum``s)."""
    from ..models.moe import routed_counts
    parts = [routed_counts(idx, n_experts) * v[:, None].float()
             for idx, v in zip(idxs, valids)]
    return group.all_gather(parts)


def expert_shard(experts, rank: int, epd: int) -> dict:
    """Rank ``rank``'s block of ``epd`` experts: VIEWS of the expert leaves
    (a contiguous slice of the leading expert axis), never copies. Leaves
    that hold ``epd`` experts already are the rank's own block (the mesh
    layout's shards) and are returned as they are."""
    return {k: v if v.shape[0] == epd else v[rank * epd:(rank + 1) * epd]
            for k, v in experts.items()}


def rank_ffn(shard, xb, act: str, kernels=None, group_sizes=None):
    """The grouped expert FFN of one rank over its (epd, rows, d) buckets:
    ``moe_gmm`` (``kernels.ops.moe_ffn``) with per-expert ``group_sizes``,
    rows padded to ``align_capacity(rows, block_c)``, when ``kernels`` is
    given; the plain ``_experts_ffn`` otherwise."""
    from ..kernels import ops as kops
    from ..kernels.moe_gmm import align_capacity
    from ..models.moe import _experts_ffn
    if kernels is None:
        return _experts_ffn(shard, xb, act)
    rows = xb.shape[1]
    pad = align_capacity(rows, kernels.block_c) - rows
    # The kernel takes contiguous buckets; a reshape of the received
    # (n_src, epd, C, d) rows is a strided view when C == 1.
    xb = (torch.nn.functional.pad(xb, (0, 0, 0, pad)) if pad
          else xb.contiguous())
    y = kops.moe_ffn(xb, shard["w_gate"], shard["w_up"], shard["w_down"],
                     act=act, group_sizes=group_sizes)
    return y[:, :rows] if pad else y


def gathered_sizes(group: EPGroup, scat) -> torch.Tensor:
    """(n, E') kept rows of every rank's buckets, on every rank."""
    return group.all_gather([s.sizes[None] for s in scat])


def _local_dispatch_combine(xs, valids, router_w, experts, moe, act,
                            group: EPGroup, rounds, spec=None, kernels=None):
    """The synchronous rank body over the held ranks. xs/valids: each held
    rank's (t_loc, d) token slice and (t_loc,) mask. Returns (ys, auxes,
    idxs), one each per held rank."""
    n = group.n
    scat = [_scatter_buckets(x, v, router_w, moe, spec)
            for x, v in zip(xs, valids)]
    n_phys, cap, d = scat[0].buf.shape
    epd = n_phys // n                                  # experts per rank

    # First exchange (token dispatch, D_N).
    recv = ep_all_to_all([s.buf.view(n, epd, cap, d) for s in scat], group,
                         rounds)                      # (n_src, epd, C, d)
    sizes = gathered_sizes(group, scat) if kernels is not None else None

    outs = []
    for me, rv in zip(group.ranks, recv):
        xb = rv.transpose(0, 1).reshape(epd, n * cap, d)
        gs = None
        if sizes is not None:
            # Source s's kept rows of a bucket are the prefix of its
            # segment [s*C, (s+1)*C): the group's live extent.
            g = sizes[:, me * epd:(me + 1) * epd]
            pos = torch.arange(n, device=g.device, dtype=g.dtype)[:, None]
            gs = torch.where(g > 0, pos * cap + g, 0).amax(0)
        y = rank_ffn(expert_shard(experts, me, epd), xb, act, kernels, gs)
        # Second exchange (expert-output return, D_C = D_N^T): the same
        # rounds; the two phases are exact reverses (§2.2).
        outs.append(y.reshape(epd, n, cap, d).transpose(0, 1).contiguous())
    back = ep_all_to_all(outs, group, rounds)
    ys = [s.combine(b.view(n_phys, cap, d)) for s, b in zip(scat, back)]
    return ys, [s.aux for s in scat], [s.idx for s in scat]


def resolve_ep_rounds(pc, n: int):
    """The rounds a dispatch runs: ``pc.aurora_rounds`` on the "aurora"
    path, None (the monolithic all-to-all) on "ep"; round robin where
    rounds are needed and none are set (the pipeline, or "aurora" before
    any plan)."""
    rounds = pc.aurora_rounds if pc.moe_impl == "aurora" else None
    if rounds is None and (pc.moe_impl == "aurora" or pc.ep_overlap):
        rounds = round_robin_rounds(n)
    return rounds


def ep_dispatch_combine(xt, router_w, experts, moe, act, pc,
                        return_counts: bool = False, kernels=None,
                        spec=None):
    """The EP MoE layer over ``pc.group``. xt: (T, d), the same on every
    rank (the dense part runs replicated). T is padded to a multiple of
    the rank count and rank r takes rows [r*t_loc, (r+1)*t_loc) (the
    reference's ``P(token_axes)``); padded rows are masked out of
    dispatch. The result is gathered back to every rank.

    ``pc.ep_overlap=True`` runs the round-pipelined body
    (``distributed.overlap``). ``return_counts=True`` appends the (T, E)
    routed-choice histogram. ``spec``: the hot-expert layout of
    ``experts`` (its ``n_phys`` must divide over the ranks). ``kernels``:
    the expert FFN runs ``moe_gmm``. Returns (y, aux[, counts]); aux is
    the mean of the ranks' load-balance losses.
    """
    group = pc.group
    n = group.n
    t = xt.shape[0]
    t_loc = -(-t // n)
    valid = torch.arange(t_loc * n, device=xt.device) < t
    if t_loc * n != t:
        xt = torch.nn.functional.pad(xt, (0, 0, 0, t_loc * n - t))
    if spec is not None and spec.n_phys % n != 0:
        raise ValueError(
            f"replicated physical expert count {spec.n_phys} does not "
            f"divide over the {n}-rank EP group — pad the replication "
            f"(planner: total_multiple={n}) so every rank hosts the same "
            "number of physical experts")
    rounds = resolve_ep_rounds(pc, n)
    if pc.ep_overlap:
        from .overlap import pipelined_local_dispatch_combine as body
    else:
        body = _local_dispatch_combine
    xs = [xt[r * t_loc:(r + 1) * t_loc] for r in group.ranks]
    vs = [valid[r * t_loc:(r + 1) * t_loc] for r in group.ranks]
    ys, auxes, idxs = body(xs, vs, router_w, experts, moe, act, group,
                           rounds, spec=spec, kernels=kernels)
    y = ep_all_gather(ys, group)[:t]
    aux = ep_mean(auxes, group)
    if return_counts:
        return y, aux, _replicated_counts(idxs, vs, moe.n_experts,
                                          group)[:t]
    return y, aux
