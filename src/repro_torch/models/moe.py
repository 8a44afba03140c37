"""Mixture-of-Experts layer: router, capacity, dispatch, expert FFN, combine
(port of ``repro/models/moe.py``).

- ``moe_apply_dense``: the reference dispatch (one-hot slot positions), kept
  as the plain oracle the tests compare with.
- ``moe_apply_kernel``: sort-based ragged dispatch into zero-padded (E, C, d)
  capacity buckets with per-expert ``group_sizes``, through
  ``kernels.ops.moe_ffn`` (the CUDA ``moe_gmm`` kernel on the card). It is
  the reference's bucketed branch, the one it takes on a TPU; the CPU-only
  compact branch is not ported.
- ``moe_apply_ep``: expert-parallel dispatch over an EP group
  (``ParallelContext``), the monolithic all-to-all or Aurora's permutation
  rounds, each rank's experts through ``moe_gmm``
  (``repro_torch.distributed``).

Hot-expert replication (``ReplicationSpec``): routing, capacity and drops
stay in the LOGICAL frame; only the bucket coordinates move, rank r of
expert e landing on physical slot ``base[e] + r % counts[e]`` at position
``r // counts[e]``. Replicas are byte-identical copies, so the routed
function is unchanged.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.errors import FaultError
from ..device import resolve_device
from ..kernels import ops as kops
from ..kernels.moe_gmm import align_capacity
from ..kernels.ref import act_fn
from .layers import KernelConfig, ParallelContext, ffn_apply


# ---------------------------------------------------------------------------
# Expert replication (hot-expert copies; placement-only)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplicationSpec:
    """Physical layout of replicated experts.

    ``counts[e]`` copies of logical expert e sit contiguously in the widened
    physical expert axis (slots ``base[e] .. base[e] + counts[e] - 1``, all
    byte-identical). Routing stays logical; each kept (token, expert, rank r)
    lands on replica ``r % counts[e]`` at bucket position ``r // counts[e]``
    (the shard-of-token rule). Hashable, so it can sit on the frozen
    ``Model``."""

    counts: tuple[int, ...]

    def __post_init__(self):
        if not self.counts or any(int(c) < 1 for c in self.counts):
            raise ValueError(f"replica counts must be >= 1, "
                             f"got {self.counts}")

    @property
    def n_logical(self) -> int:
        return len(self.counts)

    @property
    def n_phys(self) -> int:
        return sum(self.counts)

    @property
    def base(self) -> tuple[int, ...]:
        """First physical slot of each logical expert."""
        out, acc = [], 0
        for c in self.counts:
            out.append(acc)
            acc += c
        return tuple(out)

    @property
    def phys_to_logical(self) -> tuple[int, ...]:
        return tuple(e for e, c in enumerate(self.counts) for _ in range(c))

    @property
    def is_identity(self) -> bool:
        return all(c == 1 for c in self.counts)

    @classmethod
    def from_counts(cls, counts) -> "ReplicationSpec | None":
        """None for the identity layout (no replication)."""
        spec = cls(counts=tuple(int(c) for c in counts))
        return None if spec.is_identity else spec


def _map_experts(fn, tree, inside: bool = False):
    """``tree`` rebuilt with ``fn(leaf)`` applied to every leaf under an
    "experts" key; every other leaf is shared, not copied. An expert leaf
    is a stacked tensor or, once an engine has re-laid it out
    (``relayout_moe_params``), a list of per-layer tensors."""
    if isinstance(tree, dict):
        return {k: _map_experts(fn, v, inside or k == "experts")
                for k, v in tree.items()}
    if inside and (torch.is_tensor(tree) or isinstance(tree, list)):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_experts(fn, v, inside) for v in tree)
    return tree


def expert_leaves(params) -> list:
    """Every expert leaf of ``params``, in tree order."""
    out = []

    def keep(leaf):
        out.append(leaf)
        return leaf
    _map_experts(keep, params)
    return out


def expert_slabs(leaf, axis: int = 1):
    """The per-layer views of an expert leaf, each with the expert axis
    first: the leaf itself for a standalone layer (``axis=0``), its layer
    slices for a stacked (layer, E, ...) leaf, or its list entries."""
    if isinstance(leaf, list):
        return leaf
    return [leaf] if axis == 0 else list(leaf.unbind(0))


def _gather_experts(params, slots, axis: int):
    """A new tree whose stacked expert leaves hold experts ``slots`` along
    ``axis``."""
    index = torch.as_tensor(slots, dtype=torch.long)
    return _map_experts(
        lambda leaf: leaf.index_select(axis, index.to(leaf.device)), params)


def replicate_moe_params(params, spec: ReplicationSpec, axis: int = 1):
    """Widen every MoE layer's expert leaves to ``spec.n_phys`` physical
    experts (replicas are gathered copies). Functional: returns a new tree,
    the caller's leaves are never written. Stacked-segment leaves are
    (layer_count, E, ...), so the expert axis defaults to 1; pass
    ``axis=0`` for a standalone layer dict. Routers are untouched: routing
    stays logical."""
    return _gather_experts(params, spec.phys_to_logical, axis)


def dereplicate_moe_params(params, spec: ReplicationSpec, axis: int = 1):
    """Exact inverse of ``replicate_moe_params``: each logical expert's home
    copy (replicas are byte-identical, so nothing is lost). Functional."""
    return _gather_experts(params, spec.base, axis)


def relayout_moe_params(params, old: ReplicationSpec | None,
                        new: ReplicationSpec | None, n_logical: int):
    """Move every expert leaf from layout ``old`` to layout ``new`` (None is
    the identity) one (layer, weight kind) slab at a time, for an engine's
    adoption. Returns a new tree whose expert leaves are lists of per-layer
    tensors. A stacked leaf is only read (it may be the caller's); a list
    leaf is the engine's own, so its entries are replaced as they go and
    each old slab is freed before the next is built: the memory beyond the
    two layouts is at most one slab. Physical slot p of ``new`` takes the
    home copy of its logical expert in ``old``."""
    old_base = old.base if old is not None else tuple(range(n_logical))
    p2l = new.phys_to_logical if new is not None else range(n_logical)
    index = torch.as_tensor([old_base[e] for e in p2l], dtype=torch.long)

    def move(leaf):
        if not isinstance(leaf, list):
            return [t.index_select(0, index.to(t.device))
                    for t in leaf.unbind(0)]
        for i, t in enumerate(leaf):
            leaf[i] = t.index_select(0, index.to(t.device))
        return leaf
    return _map_experts(move, params)


@functools.lru_cache(maxsize=64)
def _spec_tensors(spec: ReplicationSpec, device: torch.device):
    """(base, counts, phys_to_logical) as int64 tensors on ``device``, made
    once per layout and device: a copy from pageable host memory to the
    card waits for the stream, so the dispatch must not make one per layer.
    Read-only."""
    return tuple(torch.tensor(v, dtype=torch.long, device=device)
                 for v in (spec.base, spec.counts, spec.phys_to_logical))


def replica_arrays(spec: ReplicationSpec, device="cuda"):
    """(base (E,), counts (E,)) as int64 tensors for dispatch remaps, on
    the card unless another ``device`` is asked for (cached per device;
    read-only)."""
    return _spec_tensors(spec, resolve_device(device))[:2]


def shrink_replication(spec: ReplicationSpec | None,
                       drop_phys) -> "ReplicationSpec | None":
    """Failover shrink: the physical slots in ``drop_phys`` are gone; the
    layout with those copies removed. ``FaultError`` when an expert would
    lose its last copy (or nothing is replicated). None when the survivor
    layout is the identity."""
    if spec is None:
        raise FaultError(
            f"cannot drop physical expert slots {sorted(set(drop_phys))}: "
            "no replication is active, every slot is a last copy")
    drop = {int(p) for p in drop_phys}
    for p in drop:
        if not 0 <= p < spec.n_phys:
            raise FaultError(f"physical slot {p} out of "
                             f"range({spec.n_phys})")
    p2l = spec.phys_to_logical
    counts = list(spec.counts)
    for p in drop:
        counts[p2l[p]] -= 1
    for e, c in enumerate(counts):
        if c < 1:
            raise FaultError(
                f"expert {e} would lose its last copy (dropping "
                f"{sorted(drop)} from counts {spec.counts}) — failover "
                "is only lossless while one replica survives")
    return ReplicationSpec.from_counts(counts)


def repair_moe_params(params, spec: ReplicationSpec | None, bad_phys,
                      axis: int = 1):
    """Overwrite corrupt physical expert slots from a healthy replica of the
    same logical expert, IN PLACE (an engine repairs its own leaves without
    a second copy of the weights); returns ``params``. Byte-identical to
    the reference's gather. ``FaultError``, before anything is written,
    when some logical expert has no healthy copy left (always so without
    replication)."""
    bad = {int(p) for p in bad_phys}
    if spec is None:
        if bad:
            raise FaultError(
                f"cannot repair physical slots {sorted(bad)}: no "
                "replication is active, there is no healthy copy to clone")
        return params
    for p in bad:
        if not 0 <= p < spec.n_phys:
            raise FaultError(f"physical slot {p} out of "
                             f"range({spec.n_phys})")
    base, counts = spec.base, spec.counts
    src = {}
    for p in sorted(bad):
        e = spec.phys_to_logical[p]
        healthy = [q for q in range(base[e], base[e] + counts[e])
                   if q not in bad]
        if not healthy:
            raise FaultError(
                f"expert {e} has no healthy copy left among physical slots "
                f"{list(range(base[e], base[e] + counts[e]))}")
        src[p] = healthy[0]
    with torch.no_grad():
        for leaf in expert_leaves(params):
            for t in expert_slabs(leaf, axis):
                for p, q in src.items():
                    t[p].copy_(t[q])
    return params


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def route(router_w, x, moe):
    """Token -> expert assignment. x: (T, d); router_w is fp32 even in a
    bf16 model. Returns (gates (T,k) x.dtype, idx (T,k) int32, aux loss)."""
    logits = x.float() @ router_w.float()                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    if moe.router == "sigmoid":
        gates, idx = torch.topk(torch.sigmoid(logits), moe.top_k, dim=-1)
    else:
        gates, idx = torch.topk(probs, moe.top_k, dim=-1)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * P_e.
    e = moe.n_experts
    flat = idx.reshape(-1)
    f = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=x.device))
    f = f / torch.clamp(f.sum(), min=1.0)
    aux = e * torch.sum(f * probs.mean(dim=0))
    return gates.to(x.dtype), idx.to(torch.int32), aux


def capacity(n_tokens: int, top_k: int, n_experts: int, cf: float,
             multiple: int = 8) -> int:
    """Static per-expert capacity for a token group of ``n_tokens``, clamped
    above by ``n_tokens`` (top-k experts are distinct per token)."""
    c = int(n_tokens * top_k * cf / n_experts) + 1
    c = max(multiple, -(-c // multiple) * multiple)
    return min(c, max(n_tokens, 1))


def dispatch_indices(idx, n_experts: int, cap: int):
    """One-hot reference of the bucket coordinates. idx: (T, k). Returns
    (slot (T,k) int32 position inside the expert bucket, keep (T,k) bool);
    positions are assigned in token order per expert (GShard)."""
    t, k = idx.shape
    flat = idx.reshape(-1).long()
    onehot = torch.nn.functional.one_hot(flat, n_experts).int()
    pos = torch.cumsum(onehot, dim=0) - onehot
    slot = pos.gather(1, flat[:, None])[:, 0]
    return slot.reshape(t, k).to(torch.int32), (slot < cap).reshape(t, k)


def sort_dispatch(idx, n_experts: int, cap: int):
    """Sort-based ragged dispatch (``dispatch_indices`` without the one-hot).

    A stable argsort by expert id keeps token order within each group (the
    GShard tie order); group offsets come from ``searchsorted``. Returns
    order (T*k,) int32, sizes (E,) int32 offered rows per expert, slot
    (T,k) int32 rank within the group, keep (T,k) bool (rank < cap).
    """
    t, k = idx.shape
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order].contiguous()
    offsets = torch.searchsorted(
        sorted_e, torch.arange(n_experts, dtype=sorted_e.dtype,
                               device=idx.device), right=False)
    ends = torch.cat([offsets[1:], torch.full_like(offsets[:1], t * k)])
    sizes = (ends - offsets).to(torch.int32)
    rank_sorted = (torch.arange(t * k, device=idx.device)
                   - offsets[sorted_e.long()])
    slot = torch.empty(t * k, dtype=torch.int32, device=idx.device)
    slot[order] = rank_sorted.to(torch.int32)
    keep = slot < cap
    return (order.to(torch.int32), sizes, slot.reshape(t, k),
            keep.reshape(t, k))


def routed_counts(idx, n_experts: int):
    """(T, k) routed expert ids -> (T, E) float32 per-token choice histogram.
    Capacity drops are included: it measures the OFFERED dispatch traffic,
    the quantity the deployment planner consumes. One scatter-add, shared
    by the dense and the kernel dispatch."""
    t, k = idx.shape
    counts = torch.zeros((t, n_experts), dtype=torch.float32,
                         device=idx.device)
    ones = torch.ones((t, k), dtype=torch.float32, device=idx.device)
    return counts.scatter_add_(1, idx.long(), ones)


def _with_counts(y, aux, idx, shape, moe, return_counts: bool):
    """(y, aux), plus the (..., E) routed-choice counts when asked."""
    if not return_counts:
        return y, aux
    counts = routed_counts(idx, moe.n_experts)
    return y, aux, counts.reshape(shape[:-1] + (moe.n_experts,))


def _experts_ffn(experts, xb, act: str):
    """Each expert's FFN on its bucket. xb: (E, C, d)."""
    h = torch.einsum("ecd,edf->ecf", xb, experts["w_gate"])
    h = act_fn(act)(h) * torch.einsum("ecd,edf->ecf", xb, experts["w_up"])
    return torch.einsum("ecf,efd->ecd", h, experts["w_down"])


def combine(picked, gates):
    """Gate-weighted sum of each token's k expert outputs. picked: (T*k, d)
    in token-major order (the routing's ``reshape(-1)``); gates: (T, k).
    The reference scatter-adds the k rows into the token (``.at[t].add``),
    in order; a sum over k is the same function in a fixed order. (A
    CUDA ``index_add_`` adds a token's rows atomically in no fixed order:
    with k > 2 the bf16 result, and then a greedy stream, changes from run
    to run.)"""
    t, k = gates.shape
    return (picked * gates.reshape(-1, 1)).reshape(t, k, -1).sum(1)


# ---------------------------------------------------------------------------
# Dense (reference) dispatch
# ---------------------------------------------------------------------------

def physical_slots(spec: ReplicationSpec | None, e_f, s_f):
    """Logical (expert, rank) -> physical (slot, bucket position): rank r
    of expert e lands on replica ``r % counts[e]`` at position
    ``r // counts[e]`` (collision-free, adds no drops)."""
    if spec is None:
        return e_f, s_f
    base, reps, _ = _spec_tensors(spec, e_f.device)
    r_f = reps[e_f]
    return base[e_f] + s_f % r_f, s_f // r_f


def physical_group_sizes(spec: ReplicationSpec | None, group_sizes):
    """Logical (E,) kept-row counts -> (n_phys,) counts: replica j of an
    expert with r copies holds the ranks congruent to j mod r below the logical
    group size, ``max(0, ceil((g - j) / r))`` of them."""
    if spec is None:
        return group_sizes
    base, reps, p2l = _spec_tensors(spec, group_sizes.device)
    j = torch.arange(spec.n_phys, device=group_sizes.device) - base[p2l]
    r_p = reps[p2l]
    return torch.clamp((group_sizes[p2l].long() - j + r_p - 1) // r_p,
                       min=0).to(group_sizes.dtype)


def moe_apply_dense(p, x, moe, act: str, return_counts: bool = False,
                    replication: ReplicationSpec | None = None):
    """Reference MoE layer. x: (..., d) -> (y, aux[, counts]).
    ``return_counts=True`` appends the (..., E) float32 routed-choice
    histogram (``routed_counts``, logical frame). Under ``replication`` the
    expert leaves hold ``n_phys`` physical experts; routing, capacity and
    drops are those of the logical frame."""
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    gates, idx, aux = route(p["router"], xt, moe)
    cap = capacity(t, moe.top_k, moe.n_experts, moe.capacity_factor)
    slot, keep = dispatch_indices(idx, moe.n_experts, cap)
    t_f = torch.arange(t, device=x.device)[:, None].expand(idx.shape).reshape(-1)
    e_f, s_f = physical_slots(replication, idx.reshape(-1).long(),
                              slot.reshape(-1).long())
    keep_f = keep.reshape(-1)
    n_phys = (replication.n_phys if replication is not None
              else moe.n_experts)
    buf = torch.zeros((n_phys, cap, d), dtype=xt.dtype, device=x.device)
    safe_s = torch.where(keep_f, s_f, cap - 1)
    contrib = torch.where(keep_f[:, None], xt[t_f], 0.0)
    buf.index_put_((e_f, safe_s), contrib, accumulate=True)
    out_buf = _experts_ffn(p["experts"], buf, act)
    picked = torch.where(keep_f[:, None], out_buf[e_f, safe_s], 0.0)
    y = combine(picked, gates)
    if "shared" in p:
        y = y + ffn_apply(p["shared"], xt, act)
    return _with_counts(y.reshape(shape), aux, idx, shape, moe, return_counts)


# ---------------------------------------------------------------------------
# Kernel dispatch: sort-based buckets feeding the grouped FFN kernel
# ---------------------------------------------------------------------------

def moe_apply_kernel(p, x, moe, act: str, kernels: KernelConfig | None = None,
                     return_counts: bool = False,
                     replication: ReplicationSpec | None = None):
    """Kernelized MoE layer, same routing/capacity/drops as the dense
    reference. x: (..., d) -> (y, aux[, counts]); the counts come from the
    routing ``idx``, as on the dense path.

    Kept assignments are scattered, in expert-sorted order, into buckets of
    ``align_capacity(cap, block_c)`` rows; unfilled rows point at a zero pad
    row. Dropped ranks are filtered out explicitly (the reference's
    out-of-range ``mode="drop"`` scatter has no PyTorch counterpart). Under
    ``replication`` routing, capacity and drops stay logical and the kernel
    gets all ``n_phys`` physical groups (``physical_group_sizes``).
    """
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    k, e = moe.top_k, moe.n_experts
    gates, idx, aux = route(p["router"], xt, moe)
    cap = capacity(t, k, e, moe.capacity_factor)
    kc = kernels or KernelConfig()

    order, sizes, slot, keep = sort_dispatch(idx, e, cap)
    keep_f = keep.reshape(-1)
    pe_f, ps_f = physical_slots(replication, idx.reshape(-1).long(),
                                slot.reshape(-1).long())
    n_phys = replication.n_phys if replication is not None else e
    experts = p["experts"]

    cap_pad = align_capacity(cap, kc.block_c)
    order_l = order.long()
    dest = pe_f[order_l] * cap_pad + ps_f[order_l]
    kept = keep_f[order_l]
    # Filtered without a host sync: dropped ranks write to one extra row
    # past the buckets, which is cut off below.
    dest = torch.where(kept, dest, n_phys * cap_pad)
    src = torch.full((n_phys * cap_pad + 1,), t, dtype=torch.long,
                     device=x.device)
    src[dest] = order_l // k
    x_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    buf = x_pad[src[:-1]].reshape(n_phys, cap_pad, d)
    group_sizes = physical_group_sizes(replication,
                                       torch.clamp(sizes, max=cap))
    out_buf = kops.moe_ffn(buf, experts["w_gate"], experts["w_up"],
                           experts["w_down"], act=act,
                           group_sizes=group_sizes)
    safe = torch.where(keep_f, pe_f * cap_pad + ps_f, 0)
    picked = out_buf.reshape(n_phys * cap_pad, d)[safe]
    picked = torch.where(keep_f[:, None], picked, 0.0)
    y = combine(picked, gates)
    if "shared" in p:
        y = y + ffn_apply(p["shared"], xt, act)
    return _with_counts(y.reshape(shape), aux, idx, shape, moe, return_counts)


# ---------------------------------------------------------------------------
# Expert-parallel dispatch: all-to-all baseline / Aurora rounds
# ---------------------------------------------------------------------------

def moe_apply_ep(p, x, moe, act: str, pc: ParallelContext,
                 kernels: KernelConfig | None = None,
                 return_counts: bool = False,
                 replication: ReplicationSpec | None = None):
    """Expert-parallel MoE layer over ``pc.group``
    (``distributed.ep_dispatch_combine``): x (..., d), the same on every
    rank, is split into per-rank token slices; each rank's experts (a
    contiguous block of E/n, views of the expert leaves) run ``moe_gmm``
    when ``kernels`` is given. ``pc.moe_impl`` picks the monolithic
    all-to-all ("ep") or the permutation rounds ("aurora"),
    ``pc.ep_overlap`` the round-pipelined body. ``return_counts=True``
    appends the (..., E) routed-choice histogram, gathered from the ranks.
    """
    from ..distributed.alltoall import ep_dispatch_combine

    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    out = ep_dispatch_combine(xt, p["router"], p["experts"], moe, act, pc,
                              return_counts=return_counts, kernels=kernels,
                              spec=replication)
    y, aux = out[0], out[1]
    if "shared" in p:
        y = y + ffn_apply(p["shared"], xt, act)
    if return_counts:
        return (y.reshape(shape), aux,
                out[2].reshape(shape[:-1] + (moe.n_experts,)))
    return y.reshape(shape), aux


def _token_slice(xt, pc):
    """This rank's slice of the flat token axis, as the reference shards it
    over every mesh axis (``P(token_axes)``, T padded to a multiple of the
    device count). xt: this rank's rows (t_row, d). Returns (slice,
    valid, gather back): ``gather back`` maps the slice's outputs to this
    rank's rows. When the batch splits over every axis but ``model`` and
    the rows divide over ``model``, the slice is a block of this rank's
    own rows (no exchange); otherwise the tokens are gathered over the
    batch axes first and the outputs over the whole mesh."""
    mesh = pc.mesh
    t_row, d = xt.shape
    data = pc.data_axes
    nb = mesh.axis_size(data) if data else 1
    n_tok = mesh.layout.size
    m = pc.tp
    if nb * m == n_tok and t_row % m == 0:
        t_loc = t_row // m
        mi = mesh.axis_index(pc.model_axis)
        valid = torch.ones(t_loc, dtype=torch.bool, device=xt.device)
        return (xt[mi * t_loc:(mi + 1) * t_loc], valid,
                lambda y: mesh.all_gather(y, 0, pc.model_axis))
    xg = mesh.all_gather(xt, 0, data) if data else xt
    t = xg.shape[0]
    t_loc = -(-t // n_tok)
    f = mesh.axis_index(mesh.axis_names)
    if t_loc * n_tok != t:
        xg = torch.nn.functional.pad(xg, (0, 0, 0, t_loc * n_tok - t))
    valid = torch.arange(f * t_loc, (f + 1) * t_loc, device=xt.device) < t
    bi = mesh.axis_index(data) if data else 0

    def back(y):
        return mesh.all_gather(y, 0, mesh.axis_names)[
            bi * t_row:(bi + 1) * t_row]
    return xg[f * t_loc:(f + 1) * t_loc], valid, back


def moe_apply_mesh(p, x, moe, act: str, pc: ParallelContext,
                   kernels: KernelConfig | None = None):
    """The MoE layer as the rank program. x: this rank's rows (..., d), the
    same on every ``model`` rank. With experts over ``pc.ep_axes`` (this
    rank holds its block of E/|ep|), the flat token axis shards over the
    whole mesh (``_token_slice``) and the EP rank body
    (``alltoall._local_dispatch_combine``, or the pipelined one) runs over
    the mesh's EP group, ``moe_gmm`` for the rank's experts when
    ``kernels`` is given; the outputs are gathered back to the rows.
    Without EP (the experts do not shard), every rank dispatches the
    global batch densely over the replicated experts, as the reference's
    dense path does over the whole batch. The shared expert is
    tensor-parallel over ``model`` (``ffn_apply``). Returns (y, aux)."""
    from ..distributed.alltoall import (_local_dispatch_combine, ep_mean,
                                        resolve_ep_rounds)
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    mesh = pc.mesh
    if pc.expert_parallel:
        xs, valid, back = _token_slice(xt, pc)
        group = pc.group
        if pc.ep_overlap:
            from ..distributed.overlap import \
                pipelined_local_dispatch_combine as body
        else:
            body = _local_dispatch_combine
        ys, auxes, _ = body([xs], [valid], p["router"], p["experts"], moe,
                            act, group, resolve_ep_rounds(pc, group.n),
                            kernels=kernels)
        y, aux = back(ys[0]), ep_mean(auxes, group)
    else:
        data = pc.data_axes
        xg = mesh.all_gather(xt, 0, data) if data else xt
        bi = mesh.axis_index(data) if data else 0
        yg, aux = moe_apply_dense({k: v for k, v in p.items()
                                   if k != "shared"}, xg, moe, act)
        y = yg[bi * xt.shape[0]:(bi + 1) * xt.shape[0]]
    if "shared" in p:
        y = y + ffn_apply(p["shared"], xt, act, pc,
                          d_ff=moe.shared_d_ff or moe.d_ff)
    return y.reshape(shape), aux


def moe_apply(p, x, moe, act: str, kernels: KernelConfig | None = None,
              return_counts: bool = False,
              replication: ReplicationSpec | None = None,
              pc: ParallelContext | None = None):
    """The rank program's layer when ``pc`` has a mesh; expert-parallel
    dispatch when ``pc`` spans an EP group ("ep" or "aurora"), else the
    kernel dispatch when a ``KernelConfig`` is attached, else dense;
    ``replication`` is the physical layout of ``p``'s expert leaves."""
    if pc is not None and pc.mesh is not None:
        if return_counts or replication is not None:
            raise ValueError("routing counts and replicated experts are not "
                             "ported to the mesh layout (ROADMAP A4)")
        return moe_apply_mesh(p, x, moe, act, pc, kernels)
    if pc is not None and pc.expert_parallel:
        return moe_apply_ep(p, x, moe, act, pc, kernels,
                            return_counts=return_counts,
                            replication=replication)
    if kernels is not None:
        return moe_apply_kernel(p, x, moe, act, kernels,
                                return_counts=return_counts,
                                replication=replication)
    return moe_apply_dense(p, x, moe, act, return_counts=return_counts,
                           replication=replication)
