"""Decoder stack of the MoE and dense decoder families (port of
``repro/models/transformer.py``).

Layers are grouped into segments as in the reference, and params and caches
are stacked per segment: every leaf of a segment's per-position dict has a
leading ``count`` axis. The reference's ``lax.scan`` over that axis is a
Python loop over the stacked layers here.

Layer kinds ported: G (global attention + dense FFN), D (attention + dense
FFN of ``dense_d_ff``: an MoE config's leading dense layers, DeepSeek-V3's
first three) and E (attention + MoE FFN, with its shared expert when the
config has one). Attention is GQA, or MLA when ``cfg.mla`` is set: then
every layer's cache holds the latent ``{"ckv", "k_rope"}`` in place of
``{"k", "v"}``. Caches are updated in place.
"""

from __future__ import annotations

import dataclasses

import torch

from . import attention as attn_mod
from .layers import ffn_apply, rmsnorm
from .moe import moe_apply

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class Segment:
    kinds: tuple[str, ...]
    count: int


def segments_of(cfg) -> list[Segment]:
    """Segment decomposition of the layer stack (G, D and E kinds)."""
    n = cfg.n_layers
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        k = cfg.moe.first_dense_layers
        return [Segment(("D",), k), Segment(("E",), n - k)]
    if cfg.moe is not None:
        return [Segment(("E",), n)]
    return [Segment(("G",), n)]


def padded_vocab(cfg) -> int:
    """Vocab rounded up to a multiple of 256, as in the reference."""
    return -(-cfg.vocab // 256) * 256


def moe_layer_count(cfg) -> int:
    """Number of MoE layers, in the canonical stats order (segment-major,
    kind-major, block-major: the order ``forward(collect_moe_stats=True)``
    stacks the per-layer routing counts in)."""
    return sum(seg.count * seg.kinds.count("E") for seg in segments_of(cfg))


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _normal(shape, scale, dtype, device, gen):
    return torch.randn(shape, dtype=dtype, device=device, generator=gen).mul_(scale)


def _ffn(n, d, f, dtype, device, gen):
    return {"w_gate": _normal((n, d, f), d ** -0.5, dtype, device, gen),
            "w_up": _normal((n, d, f), d ** -0.5, dtype, device, gen),
            "w_down": _normal((n, f, d), f ** -0.5, dtype, device, gen)}


def _attn(n, cfg, dtype, device, gen) -> dict:
    """GQA or MLA leaves at the reference's shapes and scales
    (``init_attn``, ``init_mla``), stacked over ``n`` layers."""
    d, h = cfg.d_model, cfg.n_heads
    m = cfg.mla
    if m is None:
        hkv, hd = cfg.n_kv_heads, cfg.head_dim
        return {
            "wq": _normal((n, d, h, hd), d ** -0.5, dtype, device, gen),
            "wk": _normal((n, d, hkv, hd), d ** -0.5, dtype, device, gen),
            "wv": _normal((n, d, hkv, hd), d ** -0.5, dtype, device, gen),
            "wo": _normal((n, h, hd, d), (h * hd) ** -0.5, dtype, device,
                          gen)}
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    r_q, r_kv = m.q_lora_rank, m.kv_lora_rank
    return {
        "wq_a": _normal((n, d, r_q), d ** -0.5, dtype, device, gen),
        "q_norm": torch.zeros((n, r_q), dtype=dtype, device=device),
        "wq_b": _normal((n, r_q, h, qk_head), r_q ** -0.5, dtype, device,
                        gen),
        "wkv_a": _normal((n, d, r_kv + m.qk_rope_head_dim), d ** -0.5,
                         dtype, device, gen),
        "kv_norm": torch.zeros((n, r_kv), dtype=dtype, device=device),
        "wk_b": _normal((n, r_kv, h, m.qk_nope_head_dim), r_kv ** -0.5,
                        dtype, device, gen),
        "wv_b": _normal((n, r_kv, h, m.v_head_dim), r_kv ** -0.5, dtype,
                        device, gen),
        "wo": _normal((n, h, m.v_head_dim, d), (h * m.v_head_dim) ** -0.5,
                      dtype, device, gen)}


def _init_segment(seg: Segment, cfg, dtype, device, gen) -> tuple:
    n, d = seg.count, cfg.d_model
    out = []
    for kind in seg.kinds:
        p = {"ln1": torch.zeros((n, d), dtype=dtype, device=device),
             "attn": _attn(n, cfg, dtype, device, gen),
             "ln2": torch.zeros((n, d), dtype=dtype, device=device)}
        if kind == "E":
            m = cfg.moe
            e, f = m.n_experts, m.d_ff
            p["moe"] = {
                "router": _normal((n, d, e), d ** -0.5, torch.float32,
                                  device, gen),
                "experts": {
                    "w_gate": _normal((n, e, d, f), d ** -0.5, dtype, device, gen),
                    "w_up": _normal((n, e, d, f), d ** -0.5, dtype, device, gen),
                    "w_down": _normal((n, e, f, d), f ** -0.5, dtype, device, gen)}}
            if m.n_shared_experts:
                p["moe"]["shared"] = _ffn(n, d, m.shared_d_ff or f, dtype,
                                          device, gen)
        else:
            f = cfg.moe.dense_d_ff if kind == "D" else cfg.d_ff
            p["ffn"] = _ffn(n, d, f, dtype, device, gen)
        out.append(p)
    return tuple(out)


def init_params(cfg, seed: int = 0, device="cpu") -> dict:
    """Seeded random params with the reference's shapes, scales and dtypes
    (``init_params``); the numbers come from a ``torch.Generator``, so they
    differ from JAX's for the same seed. Made directly on ``device``."""
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    vp, d = padded_vocab(cfg), cfg.d_model
    p = {"embed": _normal((vp, d), 0.02, dtype, device, gen),
         "final_norm": torch.zeros((d,), dtype=dtype, device=device),
         "segments": tuple(_init_segment(seg, cfg, dtype, device, gen)
                           for seg in segments_of(cfg))}
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal((d, vp), d ** -0.5, dtype, device, gen)
    return p


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, cap: int, dtype=None, per_slot_len=False,
               device="cpu") -> dict:
    """``{"len", "segments"}`` with leaves (count, batch, cap, ...): GQA
    ``{"k", "v"}`` (..., Hkv, D), or MLA ``{"ckv", "k_rope"}`` (...,
    kv_lora) and (..., rope) when ``cfg.mla`` is set. ``per_slot_len=True``
    makes ``len`` a (batch,) vector: each row (decode slot) tracks its own
    sequence length."""
    dtype = dtype or torch_dtype(cfg.dtype)
    shape_len = (batch,) if per_slot_len else ()
    init_layer = (attn_mod.init_mla_cache if cfg.mla is not None
                  else attn_mod.init_attn_cache)
    segs = []
    for seg in segments_of(cfg):
        segs.append(tuple(
            {name: t.expand((seg.count,) + t.shape).clone()
             for name, t in init_layer(cfg, batch, cap, dtype,
                                       device).items()}
            for _ in seg.kinds))
    return {"len": torch.zeros(shape_len, dtype=torch.int32, device=device),
            "segments": tuple(segs)}


def merge_cache_slot(cache, sub, slot: int):
    """Write a batch-1 cache ``sub`` into row ``slot`` of a multi-slot cache
    (in place; leaves are (count, batch, ...), so the slot is axis 1) and set
    that slot's length. Returns ``cache``."""
    for seg_full, seg_sub in zip(cache["segments"], sub["segments"]):
        for full, new in zip(seg_full, seg_sub):
            for name in full:
                full[name][:, slot] = new[name][:, 0]
    cache["len"][slot] = sub["len"]
    return cache


def cache_leaves(cache):
    """Every tensor of a cache but ``len`` (K/V or MLA latent alike)."""
    return [t for seg in cache["segments"] for e in seg for t in e.values()]


def slice_cache_slot(cache, slot: int):
    """Batch-1 VIEW of row ``slot`` of a multi-slot cache, the inverse of
    ``merge_cache_slot``: leaves (count, 1, cap, ...) and a 0-d ``len``,
    all sharing storage with ``cache``. A prefill continuation run on the
    view writes the slot's row and fill level in place, so no merge copy
    follows (the reference returns a copy, continues it and merges it
    back; the cache ends up the same)."""
    segs = tuple(tuple({name: t[:, slot:slot + 1] for name, t in e.items()}
                       for e in seg) for seg in cache["segments"])
    return {"len": cache["len"][slot], "segments": segs}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_layer(kind, p, x, entry, *, cfg, kernels, mode, pos, length,
                 row_mask, collect_stats=False, replication=None, pc=None):
    """One layer. Returns (x, aux, counts): counts are the (B, S, E) routed
    choices of an E layer when ``collect_stats``, else None. The cache
    entry is updated in place. ``replication``: the physical layout of the
    MoE expert leaves (``moe.ReplicationSpec``, None = one copy each).
    ``pc``: the expert-parallel layout of the MoE layers
    (``layers.ParallelContext``, None = one device)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    block = attn_mod.mla_block if cfg.mla is not None else attn_mod.attn_block
    y = block(p["attn"], h, cfg=cfg, pos=pos, cache=entry, length=length,
              mode=mode, kernels=kernels, row_mask=row_mask)
    x = x + y
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    counts = None
    if kind == "E" and collect_stats:
        y2, aux, counts = moe_apply(p["moe"], h2, cfg.moe, cfg.act, kernels,
                                    return_counts=True,
                                    replication=replication, pc=pc)
    elif kind == "E":
        y2, aux = moe_apply(p["moe"], h2, cfg.moe, cfg.act, kernels,
                            replication=replication, pc=pc)
    else:
        y2, aux = ffn_apply(p["ffn"], h2, cfg.act), x.new_zeros((), dtype=torch.float32)
    return x + y2, aux, counts


def forward(params, cfg, *, tokens, mode, cache, kernels=None,
            continuation=False, row_mask=None, collect_moe_stats=False,
            replication=None, pc=None):
    """Run the decoder stack in "prefill" or "decode" mode.

    prefill: tokens (B, S), a fresh prefill written from cache position 0;
    with ``continuation=True`` it resumes at the fill level ``cache["len"]``
    (a scalar, or a (B,) vector: each row at its own offset): positions
    and cache writes start there and queries attend the cached prefix, so
    a prompt absorbed in chunks equals a one-shot prefill.
    decode: tokens (B, 1) at per-slot positions ``cache["len"]``.
    ``row_mask`` (decode only, (B,) bool): rows where it is False keep their
    cache contents and length; their logits are computed all the same.
    Returns (logits (B, S, padded_vocab), aux_loss); ``cache`` is updated
    in place (its ``len`` advances by S, or by 1 on unmasked decode rows).
    ``collect_moe_stats=True`` appends the (n_moe_layers, B, S, E) float32
    per-position routed-choice counts, in ``moe_layer_count`` order
    (callers mask pad positions before aggregating prefill traffic).
    ``replication``: the physical layout of every MoE layer's expert leaves
    (``moe.ReplicationSpec``); the counts stay in the logical frame.
    ``pc``: the expert-parallel layout (``layers.ParallelContext``): the
    MoE layers dispatch over its EP group, everything else runs replicated
    over the whole batch.
    """
    x = params["embed"][tokens]
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    b, s = x.shape[:2]
    if mode == "decode":
        length = cache["len"]
        pos = (length[:, None].expand(b, s) if length.ndim == 1
               else length.expand(b, s))
    elif continuation:
        length = cache["len"]
        pos = (length[..., None] + torch.arange(s, device=x.device)).expand(
            b, s)
    else:
        length = None
        pos = torch.arange(s, device=x.device)[None].expand(b, s)

    aux_total = x.new_zeros((), dtype=torch.float32)
    stats = []
    for si, seg in enumerate(segments_of(cfg)):
        seg_params = params["segments"][si]
        seg_cache = cache["segments"][si]
        per_kind = [[] for _ in seg.kinds]      # stats order: kind-major
        for blk in range(seg.count):
            for i, kind in enumerate(seg.kinds):
                p_l = _index_tree(seg_params[i], blk)
                entry = {name: t[blk] for name, t in seg_cache[i].items()}
                x, aux, counts = _apply_layer(
                    kind, p_l, x, entry, cfg=cfg, kernels=kernels, mode=mode,
                    pos=pos, length=length, row_mask=row_mask,
                    collect_stats=collect_moe_stats, replication=replication,
                    pc=pc)
                aux_total = aux_total + aux
                if counts is not None:
                    per_kind[i].append(counts)
        stats.extend(c for kind_stats in per_kind for c in kind_stats)

    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    if mode == "decode":
        inc = (row_mask.to(torch.int32) if row_mask is not None else 1)
        cache["len"] += inc
    else:
        cache["len"] += s
    if collect_moe_stats:
        moe_stats = (torch.stack(stats) if stats else torch.zeros(
            (0, b, s, 0), dtype=torch.float32, device=x.device))
        return logits, aux_total, moe_stats
    return logits, aux_total


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]
