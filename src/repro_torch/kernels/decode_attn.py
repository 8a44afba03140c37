"""Single-query GQA decode attention: wrapper of ``csrc/decode_attn.cu``.

Port of ``repro/kernels/decode_attn.py``. A CPU tensor runs the plain
version (``ref.decode_attn_ref``); a CUDA tensor launches the kernel (one
launch: ``split`` blocks per (batch row, kv head) divide the row's live
range, and the row's last block to finish merges their partials) or
raises. ``geometry`` computes the launch's shape; ``decode_attn.launches``
counts the wrapper's kernel runs.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256                    # per block (csrc NT)
MAX_SPLIT = 32                   # blocks per (b, kv head) row
MIN_SHARE = 16                   # fewest cache positions worth a block
MAX_G = 8                        # query heads per kv head held in registers
SMEM_LIMIT = 227 * 1024          # H100 shared memory per block (opt-in)
SMS = 132                        # streaming multiprocessors of an H100

# Per (device, stream): one int32 counter per (b, kv head) row. The kernel
# leaves every counter at 0, so a buffer is zeroed once, when it grows.
# Calls on one stream are ordered, so they can share a buffer; calls on
# two streams run side by side and get one each.
_tickets: dict[tuple[torch.device, int], torch.Tensor] = {}


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def geometry(b: int, h: int, hkv: int, s: int, d: int, dtype) -> dict:
    """Launch shape of the kernel for q (b, h, d), k/v (b, s, hkv, d) of
    ``dtype``; raises ValueError on a shape the kernel cannot take.

    - ``split``: blocks per (b, kv head), doubled from 1 while the doubled
      grid still fits one block per SM and a block would still get
      ``MIN_SHARE`` positions of a full cache, at most ``MAX_SPLIT``. Each
      block carries a fixed chain of dependent steps (fill level, copies,
      merge, ticket), so fewer, larger blocks win at decode;
    - ``lpp``: lanes per cache position, 16 bytes each (D * itemsize / 16
      rounded up to a power of two, at most 32);
    - ``tile``: positions staged in shared memory per copy round: a
      block's largest share (ceil(s / split)) where it fits in shared
      memory, with ``buffers`` 1 (the whole share in one round); else as
      many as fit twice, with ``buffers`` 2 (the next tile copies during
      this one);
    - ``smem``: dynamic shared-memory bytes, as ``csrc`` lays them out;
    - ``work``: floats of the partials' workspace, (b * hkv, split, G * D
      + 2 G).
    """
    if dtype not in _DTYPES:
        raise ValueError(f"decode_attn takes float32 or bfloat16, not {dtype}")
    itemsize = dtype.itemsize
    if (d * itemsize) % 16 or d * itemsize > 32 * 16:
        raise ValueError(f"head_dim {d} in {dtype} must fill whole 16-byte "
                         f"chunks, at most 32 of them")
    if h % hkv or h // hkv > MAX_G:
        raise ValueError(f"H={h}, Hkv={hkv}: the kernel holds 1 to {MAX_G} "
                         f"query heads per kv head")
    g = h // hkv
    chunks = d * itemsize // 16
    lpp = _pow2_ceil(chunks)
    rows = b * hkv
    split = 1
    while (split < MAX_SPLIT and rows * split * 2 <= SMS
           and s >= 2 * split * MIN_SHARE):
        split *= 2
    share = -(-s // split)
    fixed = 4 * ((THREADS // 32) * g * (d + 2) + 2 * split * g)
    row = 2 * d * itemsize                       # K and V of one position
    tile = share
    if fixed + tile * row > SMEM_LIMIT:
        tile = (SMEM_LIMIT - fixed) // (2 * row)     # two buffers in turn
    buffers = 1 if tile == share else 2
    smem = buffers * tile * row + fixed
    return {"grid": (split, hkv, b), "split": split, "threads": THREADS,
            "lpp": lpp, "chunks": chunks, "tile": tile, "buffers": buffers,
            "smem": smem, "work": rows * split * g * (d + 2)}


def _tickets_for(device, stream, rows: int) -> torch.Tensor:
    key = (device, stream.cuda_stream)
    t = _tickets.get(key)
    if t is None or t.numel() < rows:
        t = torch.zeros(max(rows, 64), dtype=torch.int32, device=device)
        _tickets[key] = t
    return t


def _lib():
    lib = _build.load("decode_attn")
    fn = lib.decode_attn_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                       + [ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def decode_attn(q, k, v, valid_len):
    """q: (B, H, D); k/v: (B, S, Hkv, D); valid_len: (B,) int -> (B, H, D).

    A row with ``valid_len <= 0`` has every score masked, so it gets the
    mean of V over all S positions (as the reference does)."""
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
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}/{k.dtype}/{v.dtype}")
    geo = geometry(b, h, hkv, s, d, q.dtype)
    valid_len = valid_len.to(torch.int32)
    for t in (q, k, v, valid_len):
        if t.device != q.device:
            raise ValueError(f"decode_attn inputs must all be on {q.device}")
        if not t.is_contiguous():
            raise ValueError("decode_attn inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attn q/k/v must be 16-byte aligned")
    out = torch.empty_like(q)
    work = torch.empty(geo["work"], dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device)
    tickets = _tickets_for(q.device, stream, b * hkv)
    lib = _lib()
    err = lib.decode_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr(),
        out.data_ptr(), work.data_ptr(), tickets.data_ptr(), b, h, hkv, s, d,
        geo["split"], geo["lpp"],
        geo["tile"], geo["buffers"], geo["smem"], d ** -0.5,
        _DTYPES[q.dtype], stream.cuda_stream)
    _build.check(lib, err, "decode_attn launch")
    decode_attn.launches += 1
    return out


decode_attn.launches = 0
