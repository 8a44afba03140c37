"""Grouped expert FFN: wrapper of the CUDA kernel ``csrc/moe_gmm.cu``.

Port of ``repro/kernels/moe_gmm.py``. Per expert e over its capacity bucket

    y[e] = (act(x[e] @ w_gate[e]) * (x[e] @ w_up[e])) @ w_down[e]

with rows at or past ``group_sizes[e]`` equal to zero. A CPU tensor runs
the plain version (``ref.moe_ffn_ref``); a CUDA tensor launches the kernel
(two launches: gate/up into an (E, C, F) scratch, then down) or raises.
``moe_gmm.launches`` counts the wrapper's kernel runs.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"swiglu": 0, "geglu": 1}


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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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
    e, c, d = x.shape
    f = w_gate.shape[-1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"moe_gmm takes float32 or bfloat16, not {x.dtype}")
    if group_sizes is None:
        group_sizes = torch.full((e,), c, dtype=torch.int32, device=x.device)
    group_sizes = group_sizes.to(torch.int32)
    tensors = (x, w_gate, w_up, w_down, group_sizes)
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"moe_gmm inputs must all be on {x.device}")
        if not t.is_contiguous():
            raise ValueError("moe_gmm inputs must be contiguous")
    for t in tensors[1:4]:
        if t.dtype != x.dtype:
            raise ValueError(f"weights are {t.dtype}, x is {x.dtype}")
    # The kernel reads two neighbouring columns per lane.
    if f % 2 or d % 2:
        raise ValueError(f"moe_gmm needs even d and F, got d={d} F={f}")
    if any(t.data_ptr() % (2 * x.element_size()) for t in tensors[:4]):
        raise ValueError("moe_gmm inputs must be aligned to two elements")
    h = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    lib = _lib()
    err = lib.moe_gmm_launch(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        group_sizes.data_ptr(), h.data_ptr(), y.data_ptr(), e, c, d, f,
        _ACTS[act], _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "moe_gmm launch")
    moe_gmm.launches += 1
    return y


moe_gmm.launches = 0
