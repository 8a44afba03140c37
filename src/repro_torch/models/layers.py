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
    """How the model is laid out (the counterpart of the reference's
    ``ParallelContext``).

    Expert parallelism over a group (the EP engines of
    ``serving.distributed``): ``group`` is the ``distributed.EPGroup``
    whose ranks host the experts in contiguous blocks of E/n (None: one
    device); the dense part runs replicated on every rank over the whole
    batch and cache. ``moe_impl``: "dense" (no
    expert parallelism), "ep" (monolithic all-to-all) or "aurora" (the
    permutation rounds ``aurora_rounds``; round robin while None).
    ``ep_overlap``: the round-pipelined dispatch (``distributed.overlap``).

    The mesh layout (``sharding.make_pc`` with a mesh): ``mesh`` is this
    rank's ``distributed.mesh.RankMesh`` and the model runs as a rank
    program over this rank's shards. ``data_axes``: the axes the batch
    shards over (empty: replicated); ``model_axis``: tensor parallelism
    (heads, d_ff, vocab, mamba's projections, conv channels and heads);
    ``seq_axis``: the axes the KV caches' sequence shards over (the cross
    K/V's source sequence too); ``ep_axes``: the flat EP axes (``group``
    is the mesh's EP group over them); ``batch``, ``cap`` and ``src_len``:
    the global batch, cache capacity and an encoder-decoder's source
    positions that the shards divide. The port's ``kernels`` and
    ``replication`` stay on ``Model``."""

    group: Any = None
    moe_impl: str = "dense"
    aurora_rounds: tuple[tuple[int, ...], ...] | None = None
    ep_overlap: bool = False
    mesh: Any = None
    data_axes: tuple[str, ...] = ()
    model_axis: str | None = None
    seq_axis: tuple[str, ...] = ()
    ep_axes: tuple[str, ...] | None = None
    batch: int = 0
    cap: int = 0
    src_len: int = 0

    def __post_init__(self):
        if self.moe_impl not in ("dense", "ep", "aurora"):
            raise ValueError(f"moe_impl {self.moe_impl!r} is not one of "
                             "dense, ep, aurora")

    @property
    def expert_parallel(self) -> bool:
        return self.group is not None and self.moe_impl in ("ep", "aurora")

    @property
    def tp(self) -> int:
        """The tensor-parallel degree (the ``model`` axis size; 1 without
        a mesh)."""
        return 1 if self.mesh is None else self.mesh.axis_size(
            self.model_axis)


NO_PARALLEL = ParallelContext()


def rmsnorm(w, x, eps: float):
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
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


def apply_mrope(x, pos3, theta: float, sections: tuple[int, int, int]):
    """Qwen2-VL multimodal RoPE. x: (..., S, H, D); pos3: (3, ..., S)
    temporal / height / width position ids. The D/2 frequency slots are
    split into three sections, each rotated by its own position stream
    (all three equal for text, which makes this ``apply_rope``)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])     # (D/2,) in {0,1,2}
    pos_sel = torch.movedim(pos3, 0, -1)                   # (..., S, 3)
    pos_per_slot = pos_sel[..., sec]                       # (..., S, D/2)
    angles = (pos_per_slot.float() * freqs)[..., None, :]  # (..., S, 1, D/2)
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


def flash_attention(q, k, v, mask_fn, block_k: int = 1024):
    """Memory-bounded GQA attention: a loop over KV blocks with an online
    softmax (port of the reference's ``flash_attention``, whose
    ``lax.scan`` is a Python loop here).

    q: (B,Sq,Hkv,G,D); k,v: (B,Sk,Hkv,D). The (Sq, Sk) scores are never
    materialised: the peak temporary is (B, Hkv, G, Sq, block_k).
    ``mask_fn(q_pos, k_pos) -> bool`` builds one block's mask (causal,
    sliding window, fill level). As in the reference, K and
    V are zero-padded to whole blocks, the running max starts at -1e30 (so
    a row masked so far weighs every key alike until a live key arrives),
    and the output is acc / max(l, 1e-30).
    """
    b, sq, hkv, g, d = q.shape
    sk = k.shape[1]
    nb = -(-sk // block_k)
    pad = nb * block_k - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    scale = d ** -0.5
    q32 = q.float()
    q_pos = torch.arange(sq, device=dev)[:, None]
    m = torch.full((b, hkv, g, sq), _NEG_INF, dtype=torch.float32,
                   device=dev)
    lsum = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    for blk in range(nb):
        kblk = k[:, blk * block_k:(blk + 1) * block_k]
        vblk = v[:, blk * block_k:(blk + 1) * block_k]
        k_pos = blk * block_k + torch.arange(block_k, device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", q32, kblk.float()) * scale
        valid = (k_pos < sk)[None, :] & mask_fn(q_pos, k_pos[None, :])
        s = torch.where(valid, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(vblk.dtype).float(), vblk.float())
        m = m_new
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]      # (B,Hkv,G,Sq,D)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


FLASH_ABOVE = 4_194_304          # Sq * Sk above which prefill goes blocked
FLASH_BLOCK = 1024               # keys per block (the reference's default)


def attention_core(q, k, v, *, causal_offset, valid_len, window=None):
    """GQA attention. q: (B,Sq,H,D); k,v: (B,Sk,Hkv,D), H = Hkv*G.

    ``causal_offset``: query i may attend key j iff j <= i + offset (None =
    no causal mask). ``window``: with a causal offset, also j > i + offset
    - window (a sliding window; None = unbounded). ``valid_len``: keys >=
    valid_len are masked (the cache fill level). ``causal_offset`` and
    ``valid_len`` may each be a scalar (a number or a 0-d tensor, one value
    for the whole batch) or a (B,) vector of per-slot values.

    Three forms, as in the reference: a single query keeps the (Hkv, G)
    split (its per-slot fill levels mask alone, the decode form; a scalar
    fill level takes the causal and window terms too); several queries
    with per-row offsets or fill levels (a batch of chunked
    continuations, each at its own offset) use the grouped form with a
    materialised (B, Sq, Sk) mask; otherwise KV is repeated per head and
    one (Sq, Sk) mask serves the batch, through ``flash_attention`` in
    blocks of ``FLASH_BLOCK`` keys once Sq * Sk exceeds ``FLASH_ABOVE``.
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
            if window is not None:
                m = m & (kj > qi + causal_offset - window)
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
            if window is not None:
                m = m & (kjb > qi + off - window)
        if valid_len is not None:
            vl = torch.as_tensor(valid_len, device=dev).reshape(-1, 1, 1)
            m = m & (kjb < vl)
        out = plain_attention(q.reshape(b, sq, hkv, h // hkv, d), k, v,
                              m[:, None])
        return out.reshape(b, sq, h, d)

    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    qg = q[:, :, :, None, :]                       # (B,Sq,H,1,D): G=1 form
    if sq * sk > FLASH_ABOVE:
        out = flash_attention(qg, k, v, mask_fn, block_k=FLASH_BLOCK)
        return out.reshape(b, sq, h, d)
    mask = None
    if causal_offset is not None or valid_len is not None:
        qi = torch.arange(sq, device=dev)[:, None]
        mask = mask_fn(qi, kj[None, :])[None, None]
    return plain_attention(qg, k, v, mask).reshape(b, sq, h, d)


def tp_splits(pc, n: int) -> bool:
    """Whether a dim of ``n`` splits over the tensor-parallel (``model``)
    axis of ``pc``'s mesh: the sharding rules' divisibility test, which
    the rank program evaluates again to know which of its leaves are
    shards."""
    return (pc is not None and pc.mesh is not None and pc.tp > 1
            and n % pc.tp == 0)


def row_parallel(a, w, pc):
    """A row-parallel product over ``model``: this rank's ``a @ w`` over
    its slice of the contracted (last) dim of ``a``, ``w`` (K, N), summed
    over the ranks. A half-precision product keeps its fp32 accumulator
    as its result (``mm``'s ``out_dtype``: the weight is read as it lies,
    on the tensor cores; CUDA and ``meta`` have it, the CPU does not, so
    a half-precision rank program runs on the card); the partials are summed in fp32 and rounded to
    ``a``'s dtype once, as the unsharded product rounds once. So the
    all-reduce moves fp32, twice the bytes of the reference's lowering,
    whose partials are summed in the activation dtype."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    y = a2 @ w if a.dtype == torch.float32 else _MmF32.apply(a2, w)
    y = pc.mesh.all_reduce(y.reshape(*lead, w.shape[-1]), pc.model_axis)
    return y.to(a.dtype)


class _MmF32(torch.autograd.Function):
    """``torch.mm(a, w, out_dtype=torch.float32)`` of half-precision
    operands, which has no derivative of its own: its backward takes the
    fp32 grad back to the operands' dtype and forms the two products
    there, as the unsharded half-precision product's backward does."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.mm(a, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ w.T, a.T @ g


def ffn_apply(p, x, act: str, pc=None, d_ff: int | None = None):
    """SwiGLU / GeGLU FFN. On a mesh (``pc.mesh``), ``d_ff`` is the global
    hidden size: when it splits over ``model`` the leaves are this rank's
    column (``w_gate``, ``w_up``) and row (``w_down``) shards, and the
    partial outputs are summed over ``model`` (the Megatron pair,
    ``row_parallel``)."""
    h = act_fn(act)(x @ p["w_gate"]) * (x @ p["w_up"])
    if pc is not None and pc.mesh is not None:
        if d_ff is None:
            raise ValueError("ffn_apply on a mesh needs the global d_ff")
        if tp_splits(pc, d_ff):
            return row_parallel(h, p["w_down"], pc)
    return h @ p["w_down"]
