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
from .layers import (_NEG_INF, apply_mrope, apply_rope, attention_core,
                     rmsnorm)


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
               causal=True):
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
    contents afterwards. Returns y (B, S, d); the cache is updated in place.
    """
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
              kernels=None, row_mask=None, window=None):
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
    Returns y (B, S, d); the cache is updated in place.
    """
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

def cross_attn_block(p, x, enc_kv):
    """Decoder cross-attention over precomputed encoder K/V
    ``{"k", "v"}`` (B, S_src, Hkv, D), every source position visible."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    out = attention_core(q, enc_kv["k"], enc_kv["v"], causal_offset=None,
                         valid_len=None)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def encode_cross_kv(p, enc_out):
    """Cross-attention K/V of the encoder output (once per request)."""
    return {"k": torch.einsum("bsd,dhk->bshk", enc_out, p["wk"]),
            "v": torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])}
