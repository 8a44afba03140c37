"""Attention blocks with train, prefill and decode modes (port of
``repro/models/attention.py``: GQA with RoPE or M-RoPE, MLA and
encoder-decoder cross-attention).

Caches are fixed-capacity and updated IN PLACE (the reference returns a
new cache instead). GQA caches ``{"k", "v"}`` of shape (B, cap, Hkv, D):
global layers hold ``cap`` positions, sliding-window layers a ring of
``min(cap, window)`` (RoPE is applied at write time with absolute
positions, so ring slots need no re-rotation; q/k-norm, when the config
has it, runs before RoPE). MLA (DeepSeek-V3) caches the compressed latent
``{"ckv", "k_rope"}`` of shapes (B, cap, kv_lora) and (B, cap, rope),
trains and prefills in the direct form and decodes in the absorbed form.
The cacheless "train" mode is what training and the encoder run (the
encoder bidirectional with ``causal=False``). Cross-attention attends
precomputed encoder K/V through ``attention_core`` with no mask, as in
the reference (no Pallas kernel there, so none here).
"""

from __future__ import annotations

import torch

from ..kernels.ops import decode_attn_auto
from ..kernels.ref import decode_attn_ref
from .layers import (_NEG_INF, apply_mrope, apply_rope, attention_core,
                     rmsnorm, row_parallel, tp_splits)


def init_attn_cache(cfg, batch: int, cap: int, dtype, device) -> dict:
    shape = (batch, cap, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cache_write(cache_arr, new, slot):
    """Write one token per batch row in place: row i at sequence index
    ``slot[i]`` (a (B,) vector) or every row at the scalar ``slot``.
    new: (B, 1, ...), the cache's trailing dims."""
    new = new[:, 0].to(cache_arr.dtype)
    if slot.ndim == 1:
        rows = torch.arange(cache_arr.shape[0], device=cache_arr.device)
        cache_arr[rows, slot] = new
    else:                 # a 1-element index: no host read of ``slot``
        cache_arr[:, slot.reshape(1)] = new[:, None]


def _rope_qk(cfg, q, k, pos, pos3):
    """RoPE, or M-RoPE when ``cfg.mrope_sections`` is set; with ``pos3``
    None the three M-RoPE streams all equal ``pos`` (text)."""
    if cfg.mrope_sections is None:
        return (apply_rope(q, pos, cfg.rope_theta),
                apply_rope(k, pos, cfg.rope_theta))
    if pos3 is None:
        pos3 = pos[None].expand((3,) + tuple(pos.shape))
    return (apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections),
            apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections))


def attn_block(p, x, *, cfg, pos, cache, length=None, mode="prefill",
               kernels=None, row_mask=None, window=None, pos3=None,
               causal=True, pc=None):
    """GQA attention. x: (B, S, d); pos: (B, S) absolute positions.
    ``window``: the sliding window of an L layer (None for G layers).
    ``pos3``: (3, B, S) M-RoPE position streams (None: all equal ``pos``).

    mode "train": no cache (``cache`` is None); causal, or bidirectional
    with ``causal=False`` (the encoder's layers).

    mode "prefill" with ``length=None``: a fresh one-shot prefill; it
    attends its own keys (causal, within the window) and writes them to
    cache positions [0, S), or, into a cache smaller than the prompt (a
    ring), its last ``cap`` keys at ``pos % cap``.
    mode "prefill" with ``length`` (a scalar or a (B,) vector of fill
    levels): a chunked continuation; the chunk's keys land at positions
    [length, length + S) of each row, and its queries attend the cached
    prefix plus the causal part of the chunk (``causal_offset = length``,
    ``valid_len = length + S``). The caller keeps length + S <= cap (a
    continuation into a cache smaller than the chunk raises).
    mode "decode": S == 1; the token is written at ``length % cap`` on a
    ring (``window`` set and ``cap <= window``), else at ``min(length,
    cap - 1)``, and attends the first ``min(length + 1, cap)`` positions
    (the whole ring once it has wrapped); through ``ops.decode_attn_auto``
    when ``kernels`` is set.
    ``row_mask`` (decode, (B,) bool): rows where it is False attend with
    their token written, as in the reference, but keep their previous cache
    contents afterwards. ``pc`` with a mesh: the rank program
    (``attn_block_mesh``). Returns y (B, S, d); the cache is updated in
    place.
    """
    if pc is not None and pc.mesh is not None:
        return attn_block_mesh(p, x, cfg=cfg, pos=pos, cache=cache,
                               length=length, mode=mode, kernels=kernels,
                               row_mask=row_mask, window=window, pos3=pos3,
                               causal=causal, pc=pc)
    b, s, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q, k = _rope_qk(cfg, q, k, pos, pos3)

    if mode == "train":
        out = attention_core(q, k, v, causal_offset=0 if causal else None,
                             valid_len=None, window=window)
    elif mode == "prefill" and length is None:
        cap = cache["k"].shape[1]
        out = attention_core(q, k, v, causal_offset=0, valid_len=None,
                             window=window)
        if cap < s:
            # A ring smaller than the prompt keeps its last cap tokens; their
            # slots are consecutive mod cap, so the writes are unique.
            slots = pos[0, s - cap:] % cap
            cache["k"][:, slots] = k[:, s - cap:].to(cache["k"].dtype)
            cache["v"][:, slots] = v[:, s - cap:].to(cache["v"].dtype)
        else:
            cache["k"][:, :s] = k
            cache["v"][:, :s] = v
    elif mode == "prefill":
        cap = cache["k"].shape[1]
        if cap < s:
            raise ValueError("chunked prefill continuation into a cache "
                             f"smaller than the chunk ({cap} < {s})")
        # Positions come from the device-side fill level: index writes, no
        # host sync.
        start = length.to(torch.long)
        idx = start[..., None] + torch.arange(s, device=x.device)
        if start.ndim == 1:                  # (B,) offsets: one per row
            rows = torch.arange(b, device=x.device)[:, None]
            cache["k"][rows, idx] = k.to(cache["k"].dtype)
            cache["v"][rows, idx] = v.to(cache["v"].dtype)
        else:
            cache["k"][:, idx] = k.to(cache["k"].dtype)
            cache["v"][:, idx] = v.to(cache["v"].dtype)
        out = attention_core(q, cache["k"], cache["v"], causal_offset=start,
                             valid_len=start + s, window=window)
    elif mode == "decode":
        cap = cache["k"].shape[1]
        if window is not None and cap <= window:
            slot = torch.remainder(length, cap)            # ring
        else:
            slot = torch.clamp(length, max=cap - 1)
        old = _slot_contents(cache, slot, row_mask)
        _cache_write(cache["k"], k, slot)
        _cache_write(cache["v"], v, slot)
        valid = torch.clamp(length + 1, max=cap)
        if kernels is not None:
            out = decode_attn_auto(q[:, 0], cache["k"], cache["v"],
                                   valid)[:, None]
        else:
            out = attention_core(q, cache["k"], cache["v"],
                                 causal_offset=None, valid_len=valid)
        _restore_frozen(cache, old, row_mask, slot)
    else:
        raise ValueError(f"mode {mode!r} is not one of train, prefill, "
                         "decode")
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _slot_contents(cache, slot, row_mask):
    """Each row's cache contents at ``slot`` (cloned), or None without a
    ``row_mask``: what ``_restore_frozen`` puts back."""
    if row_mask is None:
        return None
    rows = torch.arange(row_mask.shape[0], device=row_mask.device)
    return {name: t[rows, slot].clone() for name, t in cache.items()}


def _restore_frozen(cache, old, row_mask, slot):
    """Every row rewrote its slot (no host sync on a data-dependent row
    count): rows where ``row_mask`` is False get their previous contents
    back, so their cache is as it was before the step (the reference's
    ``row_mask`` gate, ``transformer._apply_layer``)."""
    if old is None:
        return
    b = row_mask.shape[0]
    rows = torch.arange(b, device=row_mask.device)
    for name, prev in old.items():
        keep = row_mask.view((b,) + (1,) * (prev.ndim - 1))
        cache[name][rows, slot] = torch.where(
            keep, cache[name][rows, slot], prev)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------

def init_mla_cache(cfg, batch: int, cap: int, dtype, device) -> dict:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, cap, m.kv_lora_rank), dtype=dtype,
                               device=device),
            "k_rope": torch.zeros((batch, cap, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def _mla_qkv(p, x, cfg, pos):
    """(q_nope, q_rope, ckv, k_rope): per-head queries split into their
    non-rotated and rotated parts, and the token's normed latent and its
    one rotated key shared by every head."""
    m = cfg.mla
    cq = rmsnorm(p["q_norm"], x @ p["wq_a"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"])
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    ckv, k_rope = (x @ p["wkv_a"]).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], -1)
    ckv = rmsnorm(p["kv_norm"], ckv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], pos, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, ckv, k_rope


def mla_block(p, x, *, cfg, pos, cache, length=None, mode="prefill",
              kernels=None, row_mask=None, window=None, pc=None):
    """MLA attention. x: (B, S, d); pos: (B, S) absolute positions.

    mode "train" (no cache) and "prefill" (``length=None`` only): the
    direct form. K is each head's ``k_nope`` beside the shared ``k_rope``;
    V is zero-padded to the qk head size for ``attention_core`` and sliced
    back (exact). A prefill writes the latent and the rope key at cache
    positions [0, S); train writes nothing. A prefill
    that continues at a fill level raises ValueError: the reference writes
    at offset 0 whatever ``length`` says, and its engines refuse chunked
    prefill for MLA (``Model.chunkable_len`` is 0).
    mode "decode": the absorbed form over the latent cache. The token's
    latent and rope key are written at ``min(length, cap - 1)``;
    ``q_lat = q_nope W^UK``; scores ``q_lat.ckv + q_rope.k_rope`` times the
    scale, masked at ``min(length + 1, cap)``; softmax in float32, the
    probabilities cast back to the cache dtype; the latent context times
    ``W^UV``. ``row_mask`` as in ``attn_block``. Every product is plain
    PyTorch, as in the reference (no Pallas kernel there), so ``kernels``
    and ``window`` (an MLA stack has no sliding-window layers) are taken
    for ``attn_block``'s signature and not read. A prompt above 2048
    tokens prefills through ``flash_attention``, as in the reference.
    ``pc`` with a mesh: the rank program (``mla_block_mesh``). Returns y
    (B, S, d); the cache is updated in place.
    """
    if pc is not None and pc.mesh is not None:
        return mla_block_mesh(p, x, cfg=cfg, pos=pos, cache=cache,
                              length=length, mode=mode, row_mask=row_mask,
                              pc=pc)
    m = cfg.mla
    b, s, _ = x.shape
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, x, cfg, pos)

    if mode in ("train", "prefill"):
        if mode == "prefill" and length is not None:
            raise ValueError("MLA prefill cannot continue at a fill level: "
                             "its latent cache is written from position 0 "
                             "(chunked prefill is refused for MLA)")
        if mode == "prefill" and cache["ckv"].shape[1] < s:
            raise ValueError(f"prefill of {s} tokens exceeds the cache "
                             f"capacity {cache['ckv'].shape[1]}")
        k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["wk_b"])
        v = torch.einsum("bsr,rhk->bshk", ckv, p["wv_b"])
        h = k_nope.shape[2]
        k = torch.cat([k_nope, k_rope[:, :, None].expand(
            b, s, h, m.qk_rope_head_dim)], -1)
        q = torch.cat([q_nope, q_rope], -1)
        v_pad = torch.nn.functional.pad(v, (0, q.shape[-1] - m.v_head_dim))
        out = attention_core(q, k, v_pad, causal_offset=0,
                             valid_len=None)[..., :m.v_head_dim]
        if mode == "prefill":
            cache["ckv"][:, :s] = ckv
            cache["k_rope"][:, :s] = k_rope
    elif mode == "decode":
        cap = cache["ckv"].shape[1]
        slot = torch.clamp(length, max=cap - 1)
        old = _slot_contents(cache, slot, row_mask)
        _cache_write(cache["ckv"], ckv, slot)
        _cache_write(cache["k_rope"], k_rope, slot)
        cckv, ckr = cache["ckv"], cache["k_rope"]
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"])  # W^UK
        scores = (torch.einsum("bshr,btr->bhst", q_lat, cckv)
                  + torch.einsum("bshk,btk->bhst", q_rope, ckr)) * scale
        vl = torch.clamp(length + 1, max=cap)
        valid = (torch.arange(cap, device=x.device)
                 < vl.reshape(-1, 1)).reshape(-1, 1, 1, cap)
        scores = torch.where(valid, scores, _NEG_INF)
        probs = torch.softmax(scores.float(), dim=-1)
        ctx_lat = torch.einsum("bhst,btr->bshr", probs.to(cckv.dtype), cckv)
        out = torch.einsum("bshr,rhk->bshk", ctx_lat, p["wv_b"])   # W^UV
        _restore_frozen(cache, old, row_mask, slot)
    else:
        raise ValueError(f"mode {mode!r} is not one of train, prefill, "
                         "decode")
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------

def cross_attn_block(p, x, enc_kv, *, cfg=None, pc=None, decode=False):
    """Decoder cross-attention over precomputed encoder K/V
    ``{"k", "v"}`` (B, S_src, Hkv, D), every source position visible.
    ``pc`` with a mesh: the rank program (``cross_attn_block_mesh``), which
    reads ``cfg`` and whether this is a ``decode``."""
    if pc is not None and pc.mesh is not None:
        return cross_attn_block_mesh(p, x, enc_kv, cfg=cfg, pc=pc,
                                     decode=decode)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    out = attention_core(q, enc_kv["k"], enc_kv["v"], causal_offset=None,
                         valid_len=None)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def encode_cross_kv(p, enc_out, cache=None, *, cfg=None, pc=None):
    """Cross-attention K/V of the encoder output (once per request),
    written into ``cache``'s ``xk``/``xv`` when a cache is given. On a mesh
    (``pc.mesh``) they are the kv heads of this rank's ``wk``/``wv``
    leaves over every source position, and the cache takes its sequence
    shard of every kv head (``_to_seq_shards``)."""
    kv = {"k": torch.einsum("bsd,dhk->bshk", enc_out, p["wk"]),
          "v": torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])}
    if cache is None:
        return kv
    if pc is None or pc.mesh is None:
        cache["xk"].copy_(kv["k"])
        cache["xv"].copy_(kv["v"])
        return kv
    src = enc_out.shape[1]
    n, f, c = _seq_layout(pc, src, cache["xk"].shape[1])
    shard = _to_seq_shards(torch.stack([kv["k"], kv["v"]]), pc,
                           tp_splits(pc, cfg.n_kv_heads), src, None, n, f, c)
    cache["xk"].copy_(shard[0])
    cache["xv"].copy_(shard[1])
    return kv


# ---------------------------------------------------------------------------
# The rank program (the mesh layout of ``sharding.rules``)
# ---------------------------------------------------------------------------
#
# On a mesh every rank holds its batch rows (``pc.data_axes``), the heads
# its leaves hold (q and o by the query heads, k and v by the kv heads,
# each only where the head count divides ``model``) and a KV cache of all
# kv heads over its shard of the sequence (``pc.seq_axis``). A prefill
# computes attention over this rank's query heads, then moves K/V from
# heads to sequence shards; a decode gathers the token's queries and K/V
# over the heads, attends every head over this rank's positions and
# merges the shards' partial outputs by their log-sum-exps, the partial
# softmax GSPMD lowers the reference's seq-sharded decode to
# (``repro/sharding/rules.py``). The output projection is row-parallel:
# this rank's heads, then a sum over ``model``. The cacheless forward (the
# encoder's bidirectional layers) attends over this rank's query heads as
# a prefill does; cross-attention keeps its encoder K/V over the source
# sequence as the self-attention cache keeps its K/V.

def _seq_layout(pc, cap_l: int, local: int):
    """(n, index, c) of a cache of ``cap_l`` global positions of which
    this rank holds ``local``: n shards of c positions over
    ``pc.seq_axis``, this rank's the index-th; (1, 0, cap_l) when the
    sequence is not split."""
    if local == cap_l:
        return 1, 0, cap_l
    n = pc.mesh.axis_size(pc.seq_axis)
    if local * n != cap_l:
        raise ValueError(f"a cache shard of {local} positions is not 1/{n} "
                         f"of {cap_l}")
    return n, pc.mesh.axis_index(pc.seq_axis), local


def _heads(pc, n_heads: int):
    """(first, count) of the heads this rank's leaves hold: its block of
    n_heads / tp when the heads split over ``model``, else all."""
    if tp_splits(pc, n_heads):
        hq = n_heads // pc.tp
        return pc.mesh.axis_index(pc.model_axis) * hq, hq
    return 0, n_heads


def _kv_for(k, v, first: int, hq: int, g: int, k_split: bool):
    """K/V of the kv heads that query heads [first, first + hq) use (head
    h uses kv head h // g), in a layout ``attention_core`` groups right:
    this rank's own kv heads when they split too, or all of them when its
    query heads are all the heads; else one copy per query head."""
    if k_split or hq == g * k.shape[2]:
        return k, v
    idx = (torch.arange(first, first + hq, device=k.device) // g)
    return k[:, :, idx], v[:, :, idx]


def _row_proj(out, wo, pc, n_heads: int):
    """y = out . wo over this rank's heads, summed over ``model`` when the
    heads split (row-parallel: ``layers.row_parallel``); ``out`` holds
    this rank's heads or all."""
    first, hq = _heads(pc, n_heads)
    if out.shape[2] != hq:
        out = out[:, :, first:first + hq]
    if hq == n_heads:
        return torch.einsum("bshk,hkd->bsd", out, wo)
    b, s = out.shape[:2]
    return row_parallel(out.reshape(b, s, -1), wo.reshape(-1, wo.shape[-1]),
                        pc)


def _to_seq_shards(kv, pc, k_split: bool, cap_l: int, pos, n: int,
                   f: int, c: int):
    """This rank's sequence shard (2, B, c, Hkv, D) of a fresh prefill's
    K and V, from ``kv`` (2, B, S, h, D) over this rank's kv heads
    (``k_split``) or all of them, laid out over the global ``cap_l``
    positions (a ring smaller than the prompt keeps its last ``cap_l``
    tokens at ``pos % cap_l``). Positions past the prompt come back
    zero; the caller writes only the prompt's. Split heads move to
    sequence shards with one all-to-all over ``model``."""
    s = kv.shape[2]
    if cap_l < s:
        img = kv.new_empty(kv.shape[:2] + (cap_l,) + kv.shape[3:])
        img[:, :, pos[0, s - cap_l:] % cap_l] = kv[:, :, s - cap_l:]
    else:
        img = torch.nn.functional.pad(
            kv, (0, 0, 0, 0, 0, cap_l - s)) if cap_l > s else kv
    if not k_split:
        return img[:, :, f * c:(f + 1) * c]
    if n == 1:
        return pc.mesh.all_gather(img, 3, pc.model_axis)
    m = pc.tp
    base = f - pc.mesh.axis_index(pc.model_axis)   # model is the last axis
    row = img[:, :, base * c:(base + m) * c]
    return pc.mesh.all_to_all(row, 2, 3, pc.model_axis)


def _owner(slot, f: int, c: int, b: int):
    """(own, local): per batch row, whether this rank's shard [f*c,
    (f+1)*c) holds global position ``slot`` (a scalar or (B,)), and the
    position within the shard (clamped into it for the rows it does
    not)."""
    slot = slot.reshape(-1).expand(b)
    local = slot - f * c
    own = (local >= 0) & (local < c)
    return own, torch.clamp(local, 0, c - 1)


def _write_owned(cache, new, own, lslot):
    """Write each row's token into its slot where this rank owns it (the
    others keep theirs); returns the slots' previous contents."""
    rows = torch.arange(own.shape[0], device=own.device)
    old = {}
    for name, t in new.items():
        prev = cache[name][rows, lslot].clone()
        keep = own.view((-1,) + (1,) * (prev.ndim - 1))
        cache[name][rows, lslot] = torch.where(
            keep, t[:, 0].to(prev.dtype), prev)
        old[name] = prev
    return old


def _restore_owned(cache, old, own, lslot, row_mask):
    """Rows ``row_mask`` freezes get their slot's previous contents back on
    the shard that owns it (``_restore_frozen`` on a shard)."""
    if row_mask is None:
        return
    rows = torch.arange(own.shape[0], device=own.device)
    back = own & ~row_mask
    for name, prev in old.items():
        keep = back.view((-1,) + (1,) * (prev.ndim - 1))
        cache[name][rows, lslot] = torch.where(keep, prev,
                                               cache[name][rows, lslot])


def merge_partials(out, lse, pc):
    """Merge the sequence shards' partial attentions: out (B, H, D) and
    lse (B, H) fp32 of this rank's shard -> the attention over every
    shard, sum_i exp(lse_i - LSE) out_i with LSE the log-sum-exp of the
    lse_i (a shard with no live position has lse -inf and weighs 0)."""
    lses = pc.mesh.all_gather(lse[None], 0, pc.seq_axis)
    w = torch.exp(lse - torch.logsumexp(lses, 0))
    return pc.mesh.all_reduce(out.float() * w[..., None],
                              pc.seq_axis).to(out.dtype)


def _decode_lengths(length, cap_l: int, window, b: int):
    if window is not None and cap_l <= window:
        slot = torch.remainder(length, cap_l)            # ring
    else:
        slot = torch.clamp(length, max=cap_l - 1)
    valid = torch.clamp(length + 1, max=cap_l).reshape(-1).expand(b)
    return slot, valid


def attn_block_mesh(p, x, *, cfg, pos, cache, length, mode, kernels,
                    row_mask, window, pos3, causal=True, pc):
    """``attn_block``'s cacheless "train" mode (causal, or bidirectional
    with ``causal=False``: the encoder's layers), fresh prefill and decode
    as the rank program. x: this rank's rows (B, S, d), the same on every
    ``model`` rank."""
    if mode not in ("train", "prefill", "decode") or (
            mode == "prefill" and length is not None):
        raise ValueError(f"the mesh rank program runs the cacheless "
                         f"forward, a fresh prefill and decode, not {mode!r}"
                         + (" continued at a fill level" if mode == "prefill"
                            else "") + " (ROADMAP A4)")
    b, s, _ = x.shape
    h_all, hkv_all, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h_all // hkv_all
    first, hq = _heads(pc, h_all)
    k_split = tp_splits(pc, hkv_all)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q, k = _rope_qk(cfg, q, k, pos, pos3)
    if mode != "decode":
        ka, va = _kv_for(k, v, first, hq, g, k_split)
        out = attention_core(q, ka, va, causal_offset=0 if causal else None,
                             valid_len=None, window=window)
        if mode == "train":
            return _row_proj(out, p["wo"], pc, h_all)
    cap_l = min(pc.cap, window) if window is not None else pc.cap
    n, f, c = _seq_layout(pc, cap_l, cache["k"].shape[1])

    if mode == "prefill":
        shard = _to_seq_shards(torch.stack([k, v]), pc, k_split, cap_l,
                               pos, n, f, c)
        live = c if cap_l < s else max(0, min(c, s - f * c))
        cache["k"][:, :live] = shard[0, :, :live].to(cache["k"].dtype)
        cache["v"][:, :live] = shard[1, :, :live].to(cache["v"].dtype)
        return _row_proj(out, p["wo"], pc, h_all)

    if hq != h_all:
        q = pc.mesh.all_gather(q, 2, pc.model_axis)
    if k_split:
        k, v = pc.mesh.all_gather(torch.stack([k, v]), 3, pc.model_axis)
    slot, valid = _decode_lengths(length, cap_l, window, b)
    own, lslot = _owner(slot, f, c, b)
    old = _write_owned(cache, {"k": k, "v": v}, own, lslot)
    lvalid = torch.clamp(valid - f * c, 0, c)
    if n == 1:
        out = (decode_attn_auto(q[:, 0], cache["k"], cache["v"], lvalid)
               if kernels is not None else
               attention_core(q, cache["k"], cache["v"], causal_offset=None,
                              valid_len=lvalid)[:, 0])
    else:
        out, lse = (decode_attn_auto(q[:, 0], cache["k"], cache["v"],
                                     lvalid, return_lse=True)
                    if kernels is not None else
                    decode_attn_ref(q[:, 0], cache["k"], cache["v"], lvalid,
                                    return_lse=True))
        out = merge_partials(out, lse, pc)
    _restore_owned(cache, old, own, lslot, row_mask)
    return _row_proj(out[:, None], p["wo"], pc, h_all)


def cross_attn_block_mesh(p, x, enc_kv, *, cfg, pc, decode):
    """``cross_attn_block`` as the rank program, in plain PyTorch as the
    unsharded one is. At prefill ``enc_kv`` is ``encode_cross_kv``'s
    (this rank's kv heads, every source position) and this rank's query
    heads attend it. At decode it is the cache's ``xk``/``xv``: this
    rank's shard of ``pc.src_len`` source positions, every kv head; the
    queries are gathered over the heads, attend the shard and the shards'
    partial attentions are merged by their log-sum-exps
    (``merge_partials``). A source that is not split is attended by this
    rank's query heads, as at prefill. The output projection is
    row-parallel."""
    h_all, hkv_all = cfg.n_heads, cfg.n_kv_heads
    first, hq = _heads(pc, h_all)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k, v = enc_kv["k"], enc_kv["v"]
    n, _, c = (_seq_layout(pc, pc.src_len, k.shape[1]) if decode
               else (1, 0, k.shape[1]))
    if n == 1:           # every source position here: this rank's heads
        ka, va = _kv_for(k, v, first, hq, h_all // hkv_all,
                         not decode and tp_splits(pc, hkv_all))
        out = attention_core(q, ka, va, causal_offset=None, valid_len=None)
        return _row_proj(out, p["wo"], pc, h_all)
    if hq != h_all:
        q = pc.mesh.all_gather(q, 2, pc.model_axis)
    full = torch.full((q.shape[0],), c, dtype=torch.int32, device=q.device)
    out, lse = decode_attn_ref(q[:, 0], k, v, full, return_lse=True)
    out = merge_partials(out, lse, pc)[:, None]
    return _row_proj(out, p["wo"], pc, h_all)


def mla_block_mesh(p, x, *, cfg, pos, cache, length, mode, row_mask, pc):
    """``mla_block``'s cacheless "train" mode, prefill and decode as the
    rank program: ``wq_a`` split over its latent rank is gathered before
    ``q_norm`` (an rmsnorm over the whole rank); q, ``wk_b``, ``wv_b`` and
    ``wo`` by heads; the latent cache by sequence, written from the
    replicated latent (train writes nothing). The absorbed decode merges
    the shards' latent contexts by their log-sum-exps, in plain PyTorch
    as the unsharded decode is."""
    if mode not in ("train", "prefill", "decode") or (
            mode == "prefill" and length is not None):
        raise ValueError(f"the mesh rank program runs the cacheless "
                         f"forward, a fresh prefill and decode, not "
                         f"{mode!r} (ROADMAP A4)")
    m = cfg.mla
    b, s, _ = x.shape
    h_all = cfg.n_heads
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    cq = x @ p["wq_a"]
    if cq.shape[-1] != m.q_lora_rank:
        cq = pc.mesh.all_gather(cq, -1, pc.model_axis)
    cq = rmsnorm(p["q_norm"], cq, cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"])
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    ckv, k_rope = (x @ p["wkv_a"]).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], -1)
    ckv = rmsnorm(p["kv_norm"], ckv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], pos, cfg.rope_theta)[:, :, 0]

    if mode != "decode":
        if mode == "prefill" and pc.cap < s:
            raise ValueError(f"prefill of {s} tokens exceeds the cache "
                             f"capacity {pc.cap}")
        k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["wk_b"])
        v = torch.einsum("bsr,rhk->bshk", ckv, p["wv_b"])
        hq = k_nope.shape[2]
        kk = torch.cat([k_nope, k_rope[:, :, None].expand(
            b, s, hq, m.qk_rope_head_dim)], -1)
        qq = torch.cat([q_nope, q_rope], -1)
        v_pad = torch.nn.functional.pad(v, (0, qq.shape[-1] - m.v_head_dim))
        out = attention_core(qq, kk, v_pad, causal_offset=0,
                             valid_len=None)[..., :m.v_head_dim]
        if mode == "prefill":
            n, f, c = _seq_layout(pc, pc.cap, cache["ckv"].shape[1])
            live = max(0, min(c, s - f * c))
            cache["ckv"][:, :live] = ckv[:, f * c:f * c + live]
            cache["k_rope"][:, :live] = k_rope[:, f * c:f * c + live]
        return _row_proj(out, p["wo"], pc, h_all)

    n, f, c = _seq_layout(pc, pc.cap, cache["ckv"].shape[1])
    slot, valid = _decode_lengths(length, pc.cap, None, b)
    own, lslot = _owner(slot, f, c, b)
    old = _write_owned(cache, {"ckv": ckv, "k_rope": k_rope}, own, lslot)
    cckv, ckr = cache["ckv"], cache["k_rope"]
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"])  # W^UK
    hq = q_lat.shape[2]
    if hq != h_all:
        q_lat, q_rope = pc.mesh.all_gather(
            torch.cat([q_lat, q_rope], -1), 2, pc.model_axis).split(
                [m.kv_lora_rank, m.qk_rope_head_dim], -1)
    scores = (torch.einsum("bshr,btr->bhst", q_lat, cckv)
              + torch.einsum("bshk,btk->bhst", q_rope, ckr)) * scale
    lvalid = torch.clamp(valid - f * c, 0, c)
    live = (torch.arange(c, device=x.device)
            < lvalid.reshape(-1, 1)).reshape(-1, 1, 1, c)
    probs = torch.softmax(torch.where(live, scores, _NEG_INF).float(), -1)
    ctx = torch.einsum("bhst,btr->bshr", probs.to(cckv.dtype), cckv)
    if n > 1:
        lse = torch.logsumexp(torch.where(live, scores.float(), -torch.inf),
                              -1)[..., 0]                          # (B, H)
        ctx = merge_partials(ctx[:, 0], lse, pc)[:, None]
    first, hq = _heads(pc, h_all)
    ctx = ctx[:, :, first:first + hq]
    out = torch.einsum("bshr,rhk->bshk", ctx, p["wv_b"])        # W^UV
    _restore_owned(cache, old, own, lslot, row_mask)
    return _row_proj(out, p["wo"], pc, h_all)
