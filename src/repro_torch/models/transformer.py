"""Decoder stack, encoder and hybrid stack of every family (port of
``repro/models/transformer.py``).

Layers are grouped into segments as in the reference, and params and caches
are stacked per segment: every leaf of a segment's per-position dict has a
leading ``count`` axis. The reference's ``lax.scan`` over that axis is a
Python loop over the stacked layers here.

Layer kinds: G (global attention + dense FFN), L (sliding-window
attention + dense FFN: gemma3's ``LLLLLG`` pattern; its cache is a ring of
``min(cap, sliding_window)`` positions), D (attention + dense FFN of
``dense_d_ff``: an MoE config's leading dense layers, DeepSeek-V3's first
three), E (attention + MoE FFN, with its shared expert when the config
has one), M (Mamba2, ``models.ssm``; its cache is the conv window and the
SSD state), A (zamba2's shared attention + FFN block: one parameter set,
``params["shared"]``, an empty dict at the A position of its segment, and
a KV cache of its own per use), C (a decoder layer with cross-attention
over the encoder output; its cache holds the self-attention ``k``/``v``
and the cross ``xk``/``xv`` of ``src_len`` source positions) and B (the
encoder's bidirectional layers, ``encode``). Attention is GQA (with
q/k-norm leaves when ``cfg.qk_norm``, M-RoPE when ``cfg.mrope_sections``),
or MLA when ``cfg.mla`` is set: then every layer's cache holds the latent
``{"ckv", "k_rope"}`` in place of ``{"k", "v"}``. Caches are updated in
place.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from . import attention as attn_mod
from . import ssm as ssm_mod
from .layers import ffn_apply, rmsnorm
from .moe import moe_apply

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class Segment:
    kinds: tuple[str, ...]
    count: int


def segments_of(cfg) -> list[Segment]:
    """Decoder-side segment decomposition of the layer stack: a layer
    pattern (or a hybrid's ``M...MA`` period) is one segment of
    ``n // len`` blocks, plus a one-block remainder segment of its first
    ``n % len`` kinds; an encoder-decoder's decoder is C layers."""
    n = cfg.n_layers
    if cfg.is_encoder_decoder:
        return [Segment(("C",), n)]
    if cfg.family == "ssm":
        return [Segment(("M",), n)]
    if cfg.family == "hybrid":
        q = cfg.hybrid_period + 1
        segs = [Segment(("M",) * cfg.hybrid_period + ("A",), n // q)]
        if n % q:
            segs.append(Segment(("M",) * (n % q), 1))
        return segs
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        k = cfg.moe.first_dense_layers
        return [Segment(("D",), k), Segment(("E",), n - k)]
    if cfg.moe is not None:
        return [Segment(("E",), n)]
    if cfg.layer_pattern:
        p = len(cfg.layer_pattern)
        segs = [Segment(tuple(cfg.layer_pattern), n // p)]
        if n % p:
            segs.append(Segment(tuple(cfg.layer_pattern[: n % p]), 1))
        return segs
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
    """GQA (with q/k-norm scales when ``cfg.qk_norm``) or MLA leaves at the
    reference's shapes and scales (``init_attn``, ``init_mla``), stacked
    over ``n`` layers."""
    d, h = cfg.d_model, cfg.n_heads
    m = cfg.mla
    if m is None:
        hkv, hd = cfg.n_kv_heads, cfg.head_dim
        p = {"wq": _normal((n, d, h, hd), d ** -0.5, dtype, device, gen),
             "wk": _normal((n, d, hkv, hd), d ** -0.5, dtype, device, gen),
             "wv": _normal((n, d, hkv, hd), d ** -0.5, dtype, device, gen),
             "wo": _normal((n, h, hd, d), (h * hd) ** -0.5, dtype, device,
                           gen)}
        if cfg.qk_norm:
            p["q_norm"] = torch.zeros((n, hd), dtype=dtype, device=device)
            p["k_norm"] = torch.zeros((n, hd), dtype=dtype, device=device)
        return p
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


def _init_layer(kind: str, n: int, cfg, dtype, device, gen) -> dict:
    """One segment position's leaves, stacked over ``n`` layers: the
    reference's ``_init_layer`` of ``kind`` under its ``vmap``."""
    d = cfg.d_model
    if kind == "M":
        return {"ln": torch.zeros((n, d), dtype=dtype, device=device),
                "mamba": ssm_mod.init_mamba(n, cfg, dtype, device, gen)}
    if kind == "A":
        return {}                       # the shared block's params are used
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
    if kind == "C":
        p["ln_x"] = torch.zeros((n, d), dtype=dtype, device=device)
        p["xattn"] = _attn(n, cfg, dtype, device, gen)
    return p


def _init_segment(seg: Segment, cfg, dtype, device, gen) -> tuple:
    return tuple(_init_layer(kind, seg.count, cfg, dtype, device, gen)
                 for kind in seg.kinds)


def init_params(cfg, seed: int = 0, device="cpu") -> dict:
    """Seeded random params with the reference's shapes, scales and dtypes
    (``init_params``); the numbers come from a ``torch.Generator``, so they
    differ from JAX's for the same seed. Made directly on ``device``. On
    ``meta`` (the dry run's abstract params: shapes and dtypes, no data)
    there is no generator and ``seed`` is unused."""
    dtype = torch_dtype(cfg.dtype)
    gen = (None if torch.device(device).type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    vp, d = padded_vocab(cfg), cfg.d_model
    p = {"embed": _normal((vp, d), 0.02, dtype, device, gen),
         "final_norm": torch.zeros((d,), dtype=dtype, device=device),
         "segments": tuple(_init_segment(seg, cfg, dtype, device, gen)
                           for seg in segments_of(cfg))}
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal((d, vp), d ** -0.5, dtype, device, gen)
    if cfg.family == "hybrid":          # zamba2's one shared block
        p["shared"] = _index_tree(
            _init_layer("G", 1, cfg, dtype, device, gen), 0)
    if cfg.is_encoder_decoder:
        enc = Segment(("B",), cfg.n_encoder_layers)
        p["encoder"] = {
            "segments": (_init_segment(enc, cfg, dtype, device, gen),),
            "final_norm": torch.zeros((d,), dtype=dtype, device=device)}
    if cfg.input_mode != "text":
        p["frontend_proj"] = _normal((cfg.frontend_dim, d),
                                     cfg.frontend_dim ** -0.5, dtype,
                                     device, gen)
    return p


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def entry_capacity(kind: str, cfg, cap: int) -> int:
    """Positions a layer's cache holds: a ring of ``min(cap,
    sliding_window)`` for an L layer, ``cap`` for any other."""
    return min(cap, cfg.sliding_window) if kind == "L" else cap


def _init_entry(kind: str, cfg, batch: int, cap: int, src_len: int, dtype,
                device) -> dict:
    """One layer's cache (the reference's ``_init_layer_cache``)."""
    if kind == "M":
        return ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
    if cfg.mla is not None:
        return attn_mod.init_mla_cache(cfg, batch, cap, dtype, device)
    entry = attn_mod.init_attn_cache(cfg, batch,
                                     entry_capacity(kind, cfg, cap), dtype,
                                     device)
    if kind == "C":
        shape = (batch, src_len, cfg.n_kv_heads, cfg.head_dim)
        entry["xk"] = torch.zeros(shape, dtype=dtype, device=device)
        entry["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return entry


def init_cache(cfg, batch: int, cap: int, src_len: int = 0, dtype=None,
               per_slot_len=False, device="cpu") -> dict:
    """``{"len", "segments"}`` with leaves (count, batch, ...): GQA
    ``{"k", "v"}`` (cap_l, Hkv, D), or MLA ``{"ckv", "k_rope"}`` (cap,
    kv_lora) and (cap, rope) when ``cfg.mla`` is set; an M layer's
    ``{"conv", "state"}`` (K-1, conv_dim) and (H, P, N) fp32; a C layer's
    ``k``/``v`` and the cross ``xk``/``xv`` of ``src_len`` positions.
    ``cap_l`` is ``entry_capacity``: ``cap``, or an L layer's ring.
    ``per_slot_len=True`` makes ``len`` a (batch,) vector: each row (decode
    slot) tracks its own sequence length."""
    dtype = dtype or torch_dtype(cfg.dtype)
    shape_len = (batch,) if per_slot_len else ()
    segs = []
    for seg in segments_of(cfg):
        segs.append(tuple(
            {name: t.expand((seg.count,) + t.shape).clone()
             for name, t in _init_entry(kind, cfg, batch, cap, src_len,
                                        dtype, device).items()}
            for kind in seg.kinds))
    return {"len": torch.zeros(shape_len, dtype=torch.int32, device=device),
            "segments": tuple(segs)}


def check_capacity(cfg, cache, cap: int) -> None:
    """Raise ValueError unless every attention entry of ``cache`` holds the
    positions ``init_cache(cfg, ..., cap)`` gives it (rings included; an M
    entry holds no positions)."""
    for seg, entries in zip(segments_of(cfg), cache["segments"]):
        for kind, entry in zip(seg.kinds, entries):
            if kind == "M":
                continue
            have = entry["ckv" if cfg.mla is not None else "k"].shape[2]
            want = entry_capacity(kind, cfg, cap)    # (count, B, cap_l)
            if have != want:
                raise ValueError(f"cap {cap} gives a {kind} layer {want} "
                                 f"positions; the cache holds {have}")


def merge_cache_slot(cache, sub, slot: int):
    """Write a batch-1 cache ``sub`` into row ``slot`` of a multi-slot cache
    (in place; leaves are (count, batch, ...), so the slot is axis 1) and set
    that slot's length. Entries are matched one to one, so each keeps its
    own capacity (global caches and rings alike). Returns ``cache``."""
    for seg_full, seg_sub in zip(cache["segments"], sub["segments"]):
        for full, new in zip(seg_full, seg_sub):
            for name in full:
                full[name][:, slot] = new[name][:, 0]
    cache["len"][slot] = sub["len"]
    return cache


def cache_leaves(cache):
    """Every tensor of a cache but ``len`` (K/V, MLA latent, SSM state and
    cross K/V alike)."""
    return [t for seg in cache["segments"] for e in seg for t in e.values()]


def slice_cache_slot(cache, slot: int):
    """Batch-1 VIEW of row ``slot`` of a multi-slot cache, the inverse of
    ``merge_cache_slot``: leaves (count, 1, cap_l, ...) and a 0-d ``len``,
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
                 row_mask, collect_stats=False, replication=None, pc=None,
                 pos3=None, shared=None, enc_out=None):
    """One layer. Returns (x, aux, counts): counts are the (B, S, E) routed
    choices of an E layer when ``collect_stats``, else None. The cache
    entry (None in "train" mode) is updated in place. ``replication``: the
    physical layout of the MoE expert leaves (``moe.ReplicationSpec``,
    None = one copy each). ``pc``: the expert-parallel layout of the MoE
    layers (``layers.ParallelContext``, None = one device). ``shared``: the
    hybrid's shared block, which an A layer runs. ``enc_out``: the encoder
    output a C layer's prefill attends (its decode reads the cached cross
    K/V)."""
    zero = x.new_zeros((), dtype=torch.float32)
    if kind == "M":
        h = rmsnorm(p["ln"], x, cfg.norm_eps)
        if mode == "decode":
            y = ssm_mod.mamba_decode(p["mamba"], h, cfg, entry, row_mask)
        else:
            # A prefill starts from the entry's conv window and state and
            # writes the final ones back: a chunked continuation is the
            # same code as a fresh prefill (whose entry is zero).
            y = ssm_mod.mamba_block(p["mamba"], h, cfg, entry)
        return x + y, zero, None
    pp = shared if kind == "A" else p
    mesh_pc = pc if pc is not None and pc.mesh is not None else None
    h = rmsnorm(pp["ln1"], x, cfg.norm_eps)
    if cfg.mla is not None:
        y = attn_mod.mla_block(pp["attn"], h, cfg=cfg, pos=pos, cache=entry,
                               length=length, mode=mode, kernels=kernels,
                               row_mask=row_mask, pc=mesh_pc)
    else:
        # A C entry hands attention its self-attention K/V only, so a
        # frozen row's restore never touches the cross K/V.
        attn_cache = entry
        if kind == "C" and entry is not None:
            attn_cache = {"k": entry["k"], "v": entry["v"]}
        y = attn_mod.attn_block(
            pp["attn"], h, cfg=cfg, pos=pos, cache=attn_cache, length=length,
            mode=mode, kernels=kernels, row_mask=row_mask,
            window=cfg.sliding_window if kind == "L" else None, pos3=pos3,
            causal=kind != "B", pc=mesh_pc)
    x = x + y
    if kind == "C":
        hx = rmsnorm(p["ln_x"], x, cfg.norm_eps)
        if mode == "decode":
            kv = {"k": entry["xk"], "v": entry["xv"]}
        else:            # fresh cross K/V from the encoder output
            kv = attn_mod.encode_cross_kv(p["xattn"], enc_out)
            if entry is not None:        # sized by init_cache(src_len=)
                entry["xk"].copy_(kv["k"])
                entry["xv"].copy_(kv["v"])
        x = x + attn_mod.cross_attn_block(p["xattn"], hx, kv)
    h2 = rmsnorm(pp["ln2"], x, cfg.norm_eps)
    counts = None
    if kind == "E" and collect_stats:
        y2, aux, counts = moe_apply(p["moe"], h2, cfg.moe, cfg.act, kernels,
                                    return_counts=True,
                                    replication=replication, pc=pc)
    elif kind == "E":
        y2, aux = moe_apply(p["moe"], h2, cfg.moe, cfg.act, kernels,
                            replication=replication, pc=pc)
    else:
        d_ff = cfg.moe.dense_d_ff if kind == "D" else cfg.d_ff
        y2, aux = ffn_apply(pp["ffn"], h2, cfg.act, mesh_pc, d_ff), zero
    return x + y2, aux, counts


def _frontend(params, inputs):
    """The stub frontend's projection of patch or frame embeddings. The
    embeddings are cast to the model dtype first (the reference's matmul
    of float32 embeddings with bf16 weights promotes to float32; in the
    fp32 reduced configs the two agree exactly)."""
    proj = params["frontend_proj"]
    return inputs.to(proj.dtype) @ proj


def encode(params, cfg, frames):
    """Encoder stack (audio): frames (B, S_src, frontend_dim) -> (B, S_src,
    d): the frontend projection, the bidirectional B layers (cacheless),
    the encoder's final norm."""
    x = _frontend(params, frames)
    b, s = x.shape[:2]
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    seg_params = params["encoder"]["segments"][0][0]
    for blk in range(cfg.n_encoder_layers):
        x, _, _ = _apply_layer("B", _index_tree(seg_params, blk), x, None,
                               cfg=cfg, kernels=None, mode="train", pos=pos,
                               length=None, row_mask=None)
    return rmsnorm(params["encoder"]["final_norm"], x, cfg.norm_eps)


def forward(params, cfg, *, tokens=None, mode, cache=None, kernels=None,
            continuation=False, row_mask=None, collect_moe_stats=False,
            replication=None, pc=None, embeds=None, pos3=None,
            enc_out=None, remat=False):
    """Run the decoder stack in "train", "prefill" or "decode" mode.

    train: tokens (B, S) (or ``embeds``) from position 0 with no cache
    (``cache`` is None, nothing is written). ``remat=True`` runs each block
    (one pass over a segment position's kinds, the reference's scanned
    ``block``) under ``torch.utils.checkpoint`` when grad is enabled: its
    activations are recomputed in the backward instead of kept, the
    reference's ``jax.checkpoint``; grads are the same.

    prefill: tokens (B, S), or for a patch-input config ``embeds`` (B, S,
    frontend_dim) through the frontend projection (no sqrt(d_model) scale,
    as in the reference); a fresh prefill written from cache position 0;
    with ``continuation=True`` it resumes at the fill level ``cache["len"]``
    (a scalar, or a (B,) vector: each row at its own offset): positions
    and cache writes start there and queries attend the cached prefix, so
    a prompt absorbed in chunks equals a one-shot prefill.
    decode: tokens (B, 1) at per-slot positions ``cache["len"]``.
    ``pos3``: (3, B, S) M-RoPE position streams (None: each equals the
    positions). ``enc_out``: the encoder output (encoder-decoder prefill).
    ``row_mask`` (decode only, (B,) bool): rows where it is False keep their
    cache contents and length; their logits are computed all the same.
    Returns (logits (B, S, padded_vocab), aux_loss); ``cache`` is updated
    in place (its ``len`` advances by S, or by 1 on unmasked decode rows;
    train mode has no cache).
    ``collect_moe_stats=True`` appends the (n_moe_layers, B, S, E) float32
    per-position routed-choice counts, in ``moe_layer_count`` order
    (callers mask pad positions before aggregating prefill traffic).
    ``replication``: the physical layout of every MoE layer's expert leaves
    (``moe.ReplicationSpec``); the counts stay in the logical frame.
    ``pc``: the expert-parallel layout (``layers.ParallelContext``): the
    MoE layers dispatch over its EP group, everything else runs replicated
    over the whole batch. A ``pc`` with a mesh runs the rank program
    instead: params, cache and inputs are this rank's shards
    (``sharding.rules``), the embedding is a masked lookup of this rank's
    vocab rows summed over ``model``, the logits come back gathered over
    the vocab, and the layers run their mesh forms.
    """
    if cfg.is_encoder_decoder or cfg.input_mode == "text" or embeds is None:
        x = _embed(params["embed"], tokens, cfg, pc)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    else:
        x = _frontend(params, embeds)
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

    shared = params.get("shared")
    aux_total = x.new_zeros((), dtype=torch.float32)
    stats = []
    layer_kw = dict(cfg=cfg, kernels=kernels, mode=mode, pos=pos,
                    length=length, row_mask=row_mask,
                    collect_stats=collect_moe_stats, replication=replication,
                    pc=pc, pos3=pos3, shared=shared, enc_out=enc_out)
    checkpointed = remat and torch.is_grad_enabled()
    for si, seg in enumerate(segments_of(cfg)):
        seg_params = params["segments"][si]
        seg_cache = cache["segments"][si] if cache is not None else None
        per_kind = [[] for _ in seg.kinds]      # stats order: kind-major
        for blk in range(seg.count):
            args = (seg.kinds, seg_params, seg_cache, blk, x)
            if checkpointed:
                x, aux, counts = torch.utils.checkpoint.checkpoint(
                    _block, *args, use_reentrant=False, **layer_kw)
            else:
                x, aux, counts = _block(*args, **layer_kw)
            aux_total = aux_total + aux
            for i, c in counts:
                per_kind[i].append(c)
        stats.extend(c for kind_stats in per_kind for c in kind_stats)

    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    if head.shape[1] != padded_vocab(cfg):        # the vocab over ``model``
        logits = pc.mesh.all_gather(logits, -1, pc.model_axis)
    if mode == "decode":
        inc = (row_mask.to(torch.int32) if row_mask is not None else 1)
        cache["len"] += inc
    elif mode == "prefill":
        cache["len"] += s
    if collect_moe_stats:
        moe_stats = (torch.stack(stats) if stats else torch.zeros(
            (0, b, s, 0), dtype=torch.float32, device=x.device))
        return logits, aux_total, moe_stats
    return logits, aux_total


def _embed(embed, tokens, cfg, pc):
    """The embedding rows of ``tokens``: a lookup, or on a mesh whose
    ``model`` axis splits the vocab, a lookup of this rank's rows (zero
    for tokens outside them) summed over ``model``."""
    n = embed.shape[0]
    if n == padded_vocab(cfg):
        return embed[tokens]
    local = tokens.long() - pc.mesh.axis_index(pc.model_axis) * n
    inside = ((local >= 0) & (local < n))[..., None]
    x = torch.where(inside, embed[torch.clamp(local, 0, n - 1)], 0.0)
    return pc.mesh.all_reduce(x, pc.model_axis)


def _block(kinds, seg_params, seg_cache, blk, x, **layer_kw):
    """Block ``blk`` of a segment: one pass over its kinds. Returns (x, aux,
    [(kind position, routed counts)] of its E layers when counted)."""
    aux = x.new_zeros((), dtype=torch.float32)
    counts = []
    for i, kind in enumerate(kinds):
        entry = (None if seg_cache is None else
                 {name: t[blk] for name, t in seg_cache[i].items()})
        x, a, c = _apply_layer(kind, _index_tree(seg_params[i], blk), x,
                               entry, **layer_kw)
        aux = aux + a
        if c is not None:
            counts.append((i, c))
    return x, aux, counts


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]
