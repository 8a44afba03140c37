"""GQA attention block with prefill and decode modes (port of the GQA part of
``repro/models/attention.py``).

Caches are fixed-capacity ``{"k", "v"}`` tensors of shape (B, cap, Hkv, D)
and are updated IN PLACE (the reference returns a new cache instead). MLA,
cross-attention and sliding-window rings are not ported yet.
"""

from __future__ import annotations

import torch

from ..kernels.ops import decode_attn_auto
from .layers import apply_rope, attention_core


def init_attn_cache(cfg, batch: int, cap: int, dtype, device) -> dict:
    shape = (batch, cap, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cache_write(cache_arr, new, slot):
    """Write one token per batch row in place: row i at sequence index
    ``slot[i]`` (a (B,) vector) or every row at the scalar ``slot``.
    new: (B, 1, Hkv, D)."""
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
        old = None
        if row_mask is not None:
            rows = torch.arange(b, device=x.device)
            old = (cache["k"][rows, slot].clone(),
                   cache["v"][rows, slot].clone())
        _cache_write(cache["k"], k, slot)
        _cache_write(cache["v"], v, slot)
        valid = torch.clamp(length + 1, max=cap)
        if kernels is not None:
            out = decode_attn_auto(q[:, 0], cache["k"], cache["v"],
                                   valid)[:, None]
        else:
            out = attention_core(q, cache["k"], cache["v"],
                                 causal_offset=None, valid_len=valid)
        if old is not None:
            # Every row rewrites its slot (no host sync on a data-dependent
            # row count): frozen rows get their previous contents back.
            keep = row_mask.view(b, 1, 1)
            for name, prev in zip(("k", "v"), old):
                cache[name][rows, slot] = torch.where(
                    keep, cache[name][rows, slot], prev)
    else:
        raise ValueError(f"mode {mode!r} is not ported (prefill | decode)")
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])
