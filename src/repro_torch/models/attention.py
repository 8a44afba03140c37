"""Attention blocks with prefill and decode modes (port of the GQA and MLA
parts of ``repro/models/attention.py``).

Caches are fixed-capacity and updated IN PLACE (the reference returns a
new cache instead). GQA caches ``{"k", "v"}`` of shape (B, cap, Hkv, D).
MLA (DeepSeek-V3) caches the compressed latent ``{"ckv", "k_rope"}`` of
shapes (B, cap, kv_lora) and (B, cap, rope), prefills in the direct form
and decodes in the absorbed form. Cross-attention and sliding-window rings
are not ported.
"""

from __future__ import annotations

import torch

from ..kernels.ops import decode_attn_auto
from .layers import _NEG_INF, apply_rope, attention_core, rmsnorm


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
    else:
        cache_arr[:, slot] = new


def attn_block(p, x, *, cfg, pos, cache, length=None, mode="prefill",
               kernels=None, row_mask=None):
    """GQA attention. x: (B, S, d); pos: (B, S) absolute positions.

    mode "prefill" with ``length=None``: a fresh one-shot prefill; it
    attends its own keys and writes them to cache positions [0, S).
    mode "prefill" with ``length`` (a scalar or a (B,) vector of fill
    levels): a chunked continuation; the chunk's keys land at positions
    [length, length + S) of each row, and its queries attend the cached
    prefix plus the causal part of the chunk (``causal_offset = length``,
    ``valid_len = length + S``). The caller keeps length + S <= cap.
    mode "decode": S == 1, the token is written at ``min(length, cap - 1)``
    and attends the first ``min(length + 1, cap)`` positions; through
    ``ops.decode_attn_auto`` when ``kernels`` is set.
    ``row_mask`` (decode, (B,) bool): rows where it is False attend with
    their token written, as in the reference, but keep their previous cache
    contents afterwards. Returns y (B, S, d); the cache is updated in place.
    """
    b, s, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)

    if mode == "prefill" and length is None:
        cap = cache["k"].shape[1]
        if cap < s:
            raise ValueError(f"prefill of {s} tokens exceeds the cache "
                             f"capacity {cap}")
        out = attention_core(q, k, v, causal_offset=0, valid_len=None)
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
                             valid_len=start + s)
    elif mode == "decode":
        cap = cache["k"].shape[1]
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
        raise ValueError(f"mode {mode!r} is not ported (prefill | decode)")
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
              kernels=None, row_mask=None):
    """MLA attention. x: (B, S, d); pos: (B, S) absolute positions.

    mode "prefill" (``length=None`` only): the direct form. K is each
    head's ``k_nope`` beside the shared ``k_rope``; V is zero-padded to the
    qk head size for ``attention_core`` and sliced back (exact). The
    latent and the rope key land at cache positions [0, S). A prefill
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
    is taken for ``attn_block``'s signature and not read.
    Returns y (B, S, d); the cache is updated in place.
    """
    m = cfg.mla
    b, s, _ = x.shape
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, x, cfg, pos)

    if mode == "prefill":
        if length is not None:
            raise ValueError("MLA prefill cannot continue at a fill level: "
                             "its latent cache is written from position 0 "
                             "(chunked prefill is refused for MLA)")
        cap = cache["ckv"].shape[1]
        if cap < s:
            raise ValueError(f"prefill of {s} tokens exceeds the cache "
                             f"capacity {cap}")
        k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["wk_b"])
        v = torch.einsum("bsr,rhk->bshk", ckv, p["wv_b"])
        h = k_nope.shape[2]
        k = torch.cat([k_nope, k_rope[:, :, None].expand(
            b, s, h, m.qk_rope_head_dim)], -1)
        q = torch.cat([q_nope, q_rope], -1)
        v_pad = torch.nn.functional.pad(v, (0, q.shape[-1] - m.v_head_dim))
        out = attention_core(q, k, v_pad, causal_offset=0,
                             valid_len=None)[..., :m.v_head_dim]
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
        raise ValueError(f"mode {mode!r} is not ported (prefill | decode)")
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])
