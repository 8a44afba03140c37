"""Single-query GQA decode attention: wrapper of ``csrc/decode_attn.cu``.

Port of ``repro/kernels/decode_attn.py``. A CPU tensor runs the plain
version (``ref.decode_attn_ref``); a CUDA tensor launches the split-S
flash-decoding kernel (chunks of ``block_s`` cache positions, then a
combine pass) or raises. ``decode_attn.launches`` counts the wrapper's
kernel runs.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 48 * 1024          # static launch limit without an opt-in


def _lib():
    lib = _build.load("decode_attn")
    fn = lib.decode_attn_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def decode_attn(q, k, v, valid_len, *, block_s: int = 64):
    """q: (B, H, D); k/v: (B, S, Hkv, D); valid_len: (B,) int -> (B, H, D).

    On the card every row needs ``valid_len >= 1`` (always true at decode,
    where the fill level counts the token just written)."""
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, s, hkv, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if tuple(valid_len.shape) != (b,):
        raise ValueError(f"valid_len has shape {tuple(valid_len.shape)}, "
                         f"want ({b},)")
    if q.device.type == "cpu":
        return ref.decode_attn_ref(q, k, v, valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn runs on cpu or cuda, not {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attn takes float32 or bfloat16 q/k/v, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d % 32 or d > 256:
        raise ValueError(f"head_dim {d} must be a multiple of 32, <= 256")
    g = h // hkv
    block_s = max(1, min(block_s, s))
    if (g * d + g * block_s) * 4 > _SMEM_LIMIT:
        raise ValueError(f"G={g}, D={d}, block_s={block_s} need more than "
                         f"{_SMEM_LIMIT} B of shared memory")
    valid_len = valid_len.to(torch.int32)
    for t in (q, k, v, valid_len):
        if t.device != q.device:
            raise ValueError(f"decode_attn inputs must all be on {q.device}")
        if not t.is_contiguous():
            raise ValueError("decode_attn inputs must be contiguous")
    n_split = -(-s // block_s)
    m_part = torch.empty((b, h, n_split), dtype=torch.float32, device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b, h, n_split, d), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.decode_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
        out.data_ptr(), b, h, hkv, s, d, block_s, d ** -0.5,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "decode_attn launch")
    decode_attn.launches += 1
    return out


decode_attn.launches = 0
