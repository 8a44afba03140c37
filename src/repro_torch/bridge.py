"""Move parameter and cache trees between the JAX package and the port.

Both sides hold nested dicts and tuples with the same keys, order and leaf
shapes: params from ``init_params`` and per-slot caches from
``init_cache(per_slot_len=True)``, stacked per segment. The JAX side hands
over its leaves as numpy arrays (``jax.tree.map(np.asarray, tree)``); this
module turns them into tensors on a device and back, bit for bit, keeping
every leaf path. bfloat16 crosses as its 16-bit pattern.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_bf16(dtype) -> bool:
    return getattr(dtype, "name", str(dtype)) == "bfloat16"


def leaf_to_torch(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if _is_bf16(a.dtype):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                  # numpy's bfloat16 dtype
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def map_tree(fn, tree):
    """``fn`` applied to every leaf of a dict/tuple/list tree."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def to_torch(tree, device="cpu"):
    """numpy-leaf tree -> tensor-leaf tree on ``device`` (same paths)."""
    return map_tree(lambda a: leaf_to_torch(a, device), tree)


def to_numpy(tree):
    """tensor-leaf tree -> numpy-leaf tree (same paths)."""
    return map_tree(leaf_to_numpy, tree)


def leaf_paths(tree, prefix=()) -> list[tuple]:
    """Every leaf's path (dict keys and tuple indices), in tree order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaf_paths(v, prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, prefix + (i,))]
    return [prefix]
