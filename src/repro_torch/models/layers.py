"""Shared neural building blocks (port of ``repro/models/layers.py``).

Plain functions on tensors; params are nested dicts of tensors in the JAX
package's layouts. Reductions and products the reference asks in fp32
(``preferred_element_type=float32``) are upcast explicitly here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..kernels.ref import act_fn

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Kernel-path settings for the serving hot path.

    Attaching one to a ``Model`` (``Model.with_kernels``) routes decode-step
    attention through ``kernels.ops.decode_attn_auto`` and MoE dispatch
    through the sort-based bucketed path feeding ``kernels.ops.moe_ffn``.

    ``block_c``: capacity-row block that ``align_capacity`` pads buckets to
    (as in the reference). The reference's ``block_s`` has no counterpart:
    the port's decode kernel sizes its tiles from each block's share of
    the live range.
    """

    block_c: int = 128


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """How the MoE layers are laid out over an expert-parallel group (the
    counterpart of the reference's ``ParallelContext``, EP part).

    ``group``: the ``distributed.EPGroup`` whose ranks host the experts in
    contiguous blocks of E/n (None: one device). ``moe_impl``: "dense" (no
    expert parallelism), "ep" (monolithic all-to-all) or "aurora" (the
    permutation rounds ``aurora_rounds``; round robin while None).
    ``ep_overlap``: the round-pipelined dispatch
    (``distributed.overlap``). The reference's mesh axes, tensor
    parallelism and sequence sharding have no counterpart: the dense part
    runs replicated on every rank. The port's ``kernels`` and
    ``replication`` stay on ``Model``."""

    group: Any = None
    moe_impl: str = "dense"
    aurora_rounds: tuple[tuple[int, ...], ...] | None = None
    ep_overlap: bool = False

    def __post_init__(self):
        if self.moe_impl not in ("dense", "ep", "aurora"):
            raise ValueError(f"moe_impl {self.moe_impl!r} is not one of "
                             "dense, ep, aurora")

    @property
    def expert_parallel(self) -> bool:
        return self.group is not None and self.moe_impl in ("ep", "aurora")


NO_PARALLEL = ParallelContext()


def rmsnorm(w, x, eps: float):
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, pos, theta: float):
    """x: (..., S, H, D); pos: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    angles = pos[..., None].float() * freqs                # (..., S, D/2)
    angles = angles[..., None, :]                          # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def plain_attention(q, k, v, mask):
    """GQA attention without repeating KV.

    q: (B,Sq,Hkv,G,D); k,v: (B,Sk,Hkv,D); mask: (1|B,1,Sq,Sk) bool or None.
    """
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask[:, :, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def attention_core(q, k, v, *, causal_offset, valid_len):
    """Plain GQA attention. q: (B,Sq,H,D); k,v: (B,Sk,Hkv,D), H = Hkv*G.

    ``causal_offset``: query i may attend key j iff j <= i + offset (None =
    no causal mask). ``valid_len``: keys >= valid_len are masked (the
    cache fill level). Each may be a scalar (a number or a 0-d tensor, one
    value for the whole batch) or a (B,) vector of per-slot values.

    Three forms, as in the reference: a single query keeps the (Hkv, G)
    split; several queries with per-row offsets or fill levels (a batch of
    chunked continuations, each at its own offset) use the grouped form
    with a materialised (B, Sq, Sk) mask; otherwise KV is repeated per head
    and one (Sq, Sk) mask serves the batch. The reference's blocked flash
    form, taken only above Sq*Sk = 4,194,304, and sliding windows are not
    ported: no prefill or chunk on the serving path reaches that size.
    """
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dev = q.device
    kj = torch.arange(sk, device=dev)

    def mask_fn(qi, kj):
        m = torch.ones(torch.broadcast_shapes(qi.shape, kj.shape),
                       dtype=torch.bool, device=dev)
        if causal_offset is not None:
            m = m & (kj <= qi + causal_offset)
        if valid_len is not None:
            m = m & (kj < valid_len)
        return m

    def is_vec(a):
        return a is not None and torch.as_tensor(a).ndim == 1

    if sq == 1:
        qg = q.reshape(b, sq, hkv, h // hkv, d)
        if valid_len is None:
            mask = None
        elif is_vec(valid_len):    # per-slot fill levels: one row per slot
            vl = torch.as_tensor(valid_len, device=dev)
            mask = kj[None, None, None, :] < vl[:, None, None, None]
        else:
            qi = torch.arange(sq, device=dev)[:, None]
            mask = mask_fn(qi, kj[None, :])[None, None]
        return plain_attention(qg, k, v, mask).reshape(b, sq, h, d)

    if is_vec(causal_offset) or is_vec(valid_len):
        # Per-row offsets / fill levels at Sq > 1: each row resumes its own
        # chunked prefill; the (B, Sq, Sk) mask is materialised.
        qi = torch.arange(sq, device=dev)[None, :, None]
        kjb = kj[None, None, :]
        m = torch.ones((b, sq, sk), dtype=torch.bool, device=dev)
        if causal_offset is not None:
            off = torch.as_tensor(causal_offset, device=dev).reshape(-1, 1, 1)
            m = m & (kjb <= qi + off)
        if valid_len is not None:
            vl = torch.as_tensor(valid_len, device=dev).reshape(-1, 1, 1)
            m = m & (kjb < vl)
        out = plain_attention(q.reshape(b, sq, hkv, h // hkv, d), k, v,
                              m[:, None])
        return out.reshape(b, sq, h, d)

    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    qg = q[:, :, :, None, :]                       # (B,Sq,H,1,D): G=1 form
    mask = None
    if causal_offset is not None or valid_len is not None:
        qi = torch.arange(sq, device=dev)[:, None]
        mask = mask_fn(qi, kj[None, :])[None, None]
    return plain_attention(qg, k, v, mask).reshape(b, sq, h, d)


def ffn_apply(p, x, act: str):
    h = act_fn(act)(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
