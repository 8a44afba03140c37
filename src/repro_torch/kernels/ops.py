"""Entry points the model layer calls (port of ``repro/kernels/ops.py``).

The device of the tensors picks the path, inside each wrapper: a CPU tensor
runs the plain PyTorch version, a CUDA tensor the hand-written kernel.
There is no fallback from the kernel to the plain version on the card.
"""

from __future__ import annotations

import torch

from .decode_attn import decode_attn
from .moe_gmm import moe_gmm


def moe_ffn(x, w_gate, w_up, w_down, act: str = "swiglu", group_sizes=None):
    """Grouped expert FFN over (E, C, d) buckets; rows at or past
    ``group_sizes[e]`` are zero (zero-padded buckets, FFN(0) == 0)."""
    return moe_gmm(x, w_gate, w_up, w_down, act=act, group_sizes=group_sizes)


def decode_attn_auto(q, k, v, valid_len, block_s: int = 256):
    """Decode-step attention over a per-slot cache.

    q: (B, H, D); k/v: (B, S, Hkv, D); valid_len scalar or (B,) fill levels
    (broadcast to every batch row). ``block_s`` is the reference's block of
    cache positions, kept so the signature mirrors it; the kernel reads
    nothing of it: its blocks split each row's live range among
    themselves, and ``decode_attn.geometry`` sizes their copy tiles from
    that share and from shared memory."""
    b = q.shape[0]
    valid_len = torch.as_tensor(valid_len, dtype=torch.int32,
                                device=q.device).reshape(-1).expand(b)
    return decode_attn(q, k, v, valid_len.contiguous())
