"""Mixture-of-Experts layer: router, capacity, dispatch, expert FFN, combine
(port of the single-device paths of ``repro/models/moe.py``).

- ``moe_apply_dense``: the reference dispatch (one-hot slot positions), kept
  as the plain oracle the tests compare with.
- ``moe_apply_kernel``: sort-based ragged dispatch into zero-padded (E, C, d)
  capacity buckets with per-expert ``group_sizes``, through
  ``kernels.ops.moe_ffn`` (the CUDA ``moe_gmm`` kernel on the card). It is
  the reference's bucketed branch, the one it takes on a TPU; the CPU-only
  compact branch is not ported.

Replication and the expert-parallel paths are not ported yet.
"""

from __future__ import annotations

import torch

from ..kernels import ops as kops
from ..kernels.moe_gmm import align_capacity
from ..kernels.ref import act_fn
from .layers import KernelConfig, ffn_apply


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


def _combine(xt, picked, gates, t_f):
    y = torch.zeros_like(xt)
    y.index_add_(0, t_f, picked * gates.reshape(-1)[:, None])
    return y


# ---------------------------------------------------------------------------
# Dense (reference) dispatch
# ---------------------------------------------------------------------------

def moe_apply_dense(p, x, moe, act: str, return_counts: bool = False):
    """Reference MoE layer. x: (..., d) -> (y, aux[, counts]).
    ``return_counts=True`` appends the (..., E) float32 routed-choice
    histogram (``routed_counts``)."""
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    gates, idx, aux = route(p["router"], xt, moe)
    cap = capacity(t, moe.top_k, moe.n_experts, moe.capacity_factor)
    slot, keep = dispatch_indices(idx, moe.n_experts, cap)
    t_f = torch.arange(t, device=x.device)[:, None].expand(idx.shape).reshape(-1)
    e_f, s_f, keep_f = idx.reshape(-1).long(), slot.reshape(-1).long(), keep.reshape(-1)
    buf = torch.zeros((moe.n_experts, cap, d), dtype=xt.dtype, device=x.device)
    safe_s = torch.where(keep_f, s_f, cap - 1)
    contrib = torch.where(keep_f[:, None], xt[t_f], 0.0)
    buf.index_put_((e_f, safe_s), contrib, accumulate=True)
    out_buf = _experts_ffn(p["experts"], buf, act)
    picked = torch.where(keep_f[:, None], out_buf[e_f, safe_s], 0.0)
    y = _combine(xt, picked, gates, t_f)
    if "shared" in p:
        y = y + ffn_apply(p["shared"], xt, act)
    return _with_counts(y.reshape(shape), aux, idx, shape, moe, return_counts)


# ---------------------------------------------------------------------------
# Kernel dispatch: sort-based buckets feeding the grouped FFN kernel
# ---------------------------------------------------------------------------

def moe_apply_kernel(p, x, moe, act: str, kernels: KernelConfig | None = None,
                     return_counts: bool = False):
    """Kernelized MoE layer, same routing/capacity/drops as the dense
    reference. x: (..., d) -> (y, aux[, counts]); the counts come from the
    routing ``idx``, as on the dense path.

    Kept assignments are scattered, in expert-sorted order, into buckets of
    ``align_capacity(cap, block_c)`` rows; unfilled rows point at a zero pad
    row. Dropped ranks are filtered out explicitly (the reference's
    out-of-range ``mode="drop"`` scatter has no PyTorch counterpart).
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
    e_f = idx.reshape(-1).long()
    s_f = slot.reshape(-1).long()
    t_f = torch.arange(t, device=x.device)[:, None].expand(t, k).reshape(-1)
    experts = p["experts"]

    cap_pad = align_capacity(cap, kc.block_c)
    order_l = order.long()
    dest = e_f[order_l] * cap_pad + s_f[order_l]
    kept = keep_f[order_l]
    # Filtered without a host sync: dropped ranks write to one extra row
    # past the buckets, which is cut off below.
    dest = torch.where(kept, dest, e * cap_pad)
    src = torch.full((e * cap_pad + 1,), t, dtype=torch.long, device=x.device)
    src[dest] = order_l // k
    x_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    buf = x_pad[src[:-1]].reshape(e, cap_pad, d)
    group_sizes = torch.clamp(sizes, max=cap)
    out_buf = kops.moe_ffn(buf, experts["w_gate"], experts["w_up"],
                           experts["w_down"], act=act,
                           group_sizes=group_sizes)
    safe = torch.where(keep_f, e_f * cap_pad + s_f, 0)
    picked = out_buf.reshape(e * cap_pad, d)[safe]
    picked = torch.where(keep_f[:, None], picked, 0.0)
    y = _combine(xt, picked, gates, t_f)
    if "shared" in p:
        y = y + ffn_apply(p["shared"], xt, act)
    return _with_counts(y.reshape(shape), aux, idx, shape, moe, return_counts)


def moe_apply(p, x, moe, act: str, kernels: KernelConfig | None = None,
              return_counts: bool = False):
    """Kernel dispatch when a ``KernelConfig`` is attached, else dense."""
    if kernels is not None:
        return moe_apply_kernel(p, x, moe, act, kernels,
                                return_counts=return_counts)
    return moe_apply_dense(p, x, moe, act, return_counts=return_counts)
