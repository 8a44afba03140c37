"""Grouped expert FFN: wrapper of the CUDA kernel ``csrc/moe_gmm.cu``.

Port of ``repro/kernels/moe_gmm.py``. Per expert e over its capacity bucket

    y[e] = (act(x[e] @ w_gate[e]) * (x[e] @ w_up[e])) @ w_down[e]

with rows at or past ``group_sizes[e]`` equal to zero. A CPU tensor runs
the plain version (``ref.moe_ffn_ref``); a CUDA tensor launches the kernel
(two launches: gate/up into an (E, C, F) scratch, then down) or raises.
The dtype picks the route on the card: bfloat16 runs on the tensor cores
(``mma.sync`` fed by a ``cp.async`` ring), float32 on plain FMA.
``geometry`` computes the launch's shape; ``moe_gmm.launches`` counts the
wrapper's kernel runs.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"swiglu": 0, "geglu": 1}
SMEM_LIMIT = 227 * 1024          # H100 shared memory per block (opt-in)

# Tiles of csrc/moe_gmm.cu; the launch checks the geometry against them.
MMA = {"features": 64, "k": 64, "rows": 64, "stages": 4, "threads": 128}
FMA = {"features": 64, "rows": 8, "threads": 256}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def geometry(e: int, c: int, d: int, f: int, dtype) -> dict:
    """Launch shape for x (e, c, d), w_gate/w_up (e, d, f), w_down (e, f, d).

    Raises ValueError on a shape the kernel cannot take: bfloat16 needs d
    and f multiples of 8 (16-byte rows), float32 even ones.

    bfloat16 (route "mma"): grids (f/64, c/64, e) and (d/64, c/64, e), 64
    output features by up to 64 bucket rows per block, so every weight byte
    of a live expert is read once while c <= 64; each ring stage holds one
    64 x 64 weight tile per product (gate and up: two) and ``rows_pad``
    bucket rows of 64 reduction values. float32 (route "fma"): grids
    (f/64, c/8, e) and (d/64, c/8, e), static shared memory.
    """
    if dtype not in _DTYPES:
        raise ValueError(f"moe_gmm takes float32 or bfloat16, not {dtype}")
    width = 8 if dtype == torch.bfloat16 else 2
    if d % width or f % width:
        raise ValueError(f"moe_gmm in {dtype} needs d and F multiples of "
                         f"{width}, got d={d} F={f}")
    if dtype == torch.bfloat16:
        t = MMA
        rows_pad = 8 * _cdiv(min(c, t["rows"]), 8)
        x_bytes = rows_pad * t["k"] * 2
        w_tile = t["k"] * t["features"] * 2
        return {"route": "mma", "threads": t["threads"],
                "grid_up": (_cdiv(f, t["features"]), _cdiv(c, t["rows"]), e),
                "grid_down": (_cdiv(d, t["features"]), _cdiv(c, t["rows"]), e),
                "rows": t["rows"], "rows_pad": rows_pad,
                "stages": t["stages"],
                "smem_up": t["stages"] * (2 * w_tile + x_bytes),
                "smem_down": t["stages"] * (w_tile + x_bytes)}
    t = FMA
    return {"route": "fma", "threads": t["threads"],
            "grid_up": (_cdiv(f, t["features"]), _cdiv(c, t["rows"]), e),
            "grid_down": (_cdiv(d, t["features"]), _cdiv(c, t["rows"]), e),
            "rows": t["rows"], "rows_pad": t["rows"], "stages": 1,
            # static: staged x (256 x 8 fp32) and the 8 warps' partial sums
            "smem_up": (256 * 8 + 2 * 8 * 8 * 64) * 4,
            "smem_down": (256 * 8 + 8 * 8 * 64) * 4}


def _geo_ints(geo: dict):
    """The 8 ints ``moe_gmm_launch`` reads (csrc ``Geometry``)."""
    vals = (1 if geo["route"] == "mma" else 0, geo["grid_up"][0],
            geo["grid_down"][0], geo["grid_up"][1], geo["threads"],
            geo["rows_pad"], geo["smem_up"] if geo["route"] == "mma" else 0,
            geo["smem_down"] if geo["route"] == "mma" else 0)
    return (ctypes.c_int * 8)(*vals)


def align_capacity(cap: int, block_c: int) -> int:
    """Smallest padded capacity the kernel grid can tile with ``block_c``:
    a bucket that fits in one block is its own block; anything larger is
    padded up to whole blocks (the extra rows are zero padding that the
    ``group_sizes`` path skips)."""
    if cap <= block_c:
        return cap
    return -(-cap // block_c) * block_c


def _lib():
    lib = _build.load("moe_gmm")
    fn = lib.moe_gmm_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_args(x, w_gate, w_up, w_down, group_sizes, act):
    e, c, d = x.shape
    f = w_gate.shape[-1]
    want = {"w_gate": (e, d, f), "w_up": (e, d, f), "w_down": (e, f, d)}
    for name, t in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"want {want[name]} for x {tuple(x.shape)}")
    if act not in _ACTS:
        raise ValueError(f"act {act!r} is not one of {sorted(_ACTS)}")
    if group_sizes is not None and tuple(group_sizes.shape) != (e,):
        raise ValueError(f"group_sizes has shape {tuple(group_sizes.shape)}, "
                         f"want ({e},)")


def moe_gmm(x, w_gate, w_up, w_down, *, group_sizes=None,
            act: str = "swiglu"):
    """x: (E, C, d); w_gate/w_up: (E, d, F); w_down: (E, F, d) -> (E, C, d).

    ``group_sizes``: optional (E,) int count of real rows per bucket; None
    treats every row as real."""
    _check_args(x, w_gate, w_up, w_down, group_sizes, act)
    if x.device.type == "cpu":
        return ref.moe_ffn_ref(x, w_gate, w_up, w_down, act,
                               group_sizes=group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm runs on cpu or cuda, not {x.device}")
    _build.refuse_grad("moe_gmm", x, w_gate, w_up, w_down)
    e, c, d = x.shape
    f = w_gate.shape[-1]
    if group_sizes is None:
        group_sizes = torch.full((e,), c, dtype=torch.int32, device=x.device)
    group_sizes = group_sizes.to(torch.int32)
    geo = geometry(e, c, d, f, x.dtype)
    tensors = (x, w_gate, w_up, w_down, group_sizes)
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"moe_gmm inputs must all be on {x.device}")
        if not t.is_contiguous():
            raise ValueError("moe_gmm inputs must be contiguous")
    for t in tensors[1:4]:
        if t.dtype != x.dtype:
            raise ValueError(f"weights are {t.dtype}, x is {x.dtype}")
    width = 8 if geo["route"] == "mma" else 2
    if any(t.data_ptr() % (width * x.element_size()) for t in tensors[:4]):
        raise ValueError(f"moe_gmm inputs must be aligned to {width} "
                         f"elements")
    h = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    lib = _lib()
    err = lib.moe_gmm_launch(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        group_sizes.data_ptr(), h.data_ptr(), y.data_ptr(), e, c, d, f,
        _ACTS[act], _geo_ints(geo),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "moe_gmm launch")
    _build.count(moe_gmm)
    return y


moe_gmm.launches = 0
