"""Move parameter and cache trees between the JAX package and the port.

Both sides hold nested dicts and tuples with the same keys, order and leaf
shapes: params from ``init_params`` and per-slot caches from
``init_cache(per_slot_len=True)``, stacked per segment. The JAX side hands
over its leaves as numpy arrays (``jax.tree.map(np.asarray, tree)``); this
module turns them into tensors on a device and back, bit for bit, keeping
every leaf path. bfloat16 crosses as its 16-bit pattern. Tensors land on
the card unless ``device="cpu"`` (or another device) is asked for
(``device.resolve_device``: no card, no fallback).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def _is_bf16(dtype) -> bool:
    return getattr(dtype, "name", str(dtype)) == "bfloat16"


def leaf_to_torch(a, device="cuda") -> torch.Tensor:
    device = resolve_device(device)
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


def to_torch(tree, device="cuda"):
    """numpy-leaf tree -> tensor-leaf tree on ``device`` (same paths)."""
    device = resolve_device(device)
    return map_tree(lambda a: leaf_to_torch(a, device), tree)


def to_numpy(tree):
    """tensor-leaf tree -> numpy-leaf tree (same paths)."""
    return map_tree(leaf_to_numpy, tree)


def tree_leaves(tree) -> list:
    """Every leaf in JAX's flatten order (``jax.tree.leaves``): dict keys
    sorted, tuples and lists in order. ``leaf_paths`` walks dicts in
    insertion order instead; the two differ once a dict's keys are not
    inserted sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves, in ``tree_leaves`` order,
    replaced by ``leaves``; the inverse of ``tree_leaves``."""
    leaves = list(leaves)
    n = len(tree_leaves(like))
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a structure of {n}")
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}            # keep like's key order
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def leaf_paths(tree, prefix=()) -> list[tuple]:
    """Every leaf's path (dict keys and tuple indices), in tree order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaf_paths(v, prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, prefix + (i,))]
    return [prefix]


# ---------------------------------------------------------------------------
# A rank's shards under the mesh layout (``sharding.param_specs`` /
# ``cache_specs`` / ``input_sharding``)
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's shard of a leaf of ``shape`` under
    ``spec`` (each sharded dim divided by the size of its axes)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes:
            n = mesh.axis_size(axes)
            if out[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"divide over {axes} ({n})")
            out[dim] //= n
    return tuple(out)


def shard_tensor(t: torch.Tensor, spec, mesh, rank: int) -> torch.Tensor:
    """Rank ``rank``'s shard of ``t`` under ``spec`` (a tuple, one entry
    per leading dim of ``t``: None, an axis name or a tuple of names), as
    a new contiguous tensor on ``t``'s device. ``mesh``: a
    ``launch.mesh.MeshLayout`` (or a bound ``RankMesh``)."""
    layout = getattr(mesh, "layout", mesh)
    out = t
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes:
            n = layout.axis_size(axes)
            size = t.shape[dim] // n
            if size * n != t.shape[dim]:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"divide over {axes} ({n})")
            out = out.narrow(dim, layout.axis_index(rank, axes) * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def spec_leaves(tree, specs) -> list:
    """``specs``' leaves (one tuple per leaf of ``tree``, which gives the
    structure: a spec is itself a tuple) in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k],
                                                              specs[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v, s in zip(tree, specs) for x in spec_leaves(v, s)]
    return [specs]


def shard_params(params, specs, mesh, rank: int):
    """Rank ``rank``'s shards of a params tree (the JAX package's carried
    params or the port's own) under ``sharding.param_specs``; AdamW
    moments, which lie like the params, take the same specs."""
    return _zip_map(lambda t, s: shard_tensor(t, s, mesh, rank), params,
                    specs)


def unshard_params(per_rank, specs, mesh):
    """The whole tree from every rank's shards (``per_rank``: one tree
    per rank of ``mesh``, a ``MeshLayout``, in rank order), each leaf
    reassembled by its spec: the inverse of ``shard_params``. A block
    that several ranks hold (a replicated dim) is taken from the first of
    them."""
    layout = getattr(mesh, "layout", mesh)

    def whole(r_leaves, spec):
        first = r_leaves[0]
        shape = list(first.shape)
        for dim, entry in enumerate(spec):
            if entry:
                shape[dim] *= layout.axis_size(_entry_axes(entry))
        out = first.new_empty(shape)
        done = set()
        for r, t in enumerate(r_leaves):
            at = tuple(layout.axis_index(r, _entry_axes(e)) if e else 0
                       for e in spec)
            if at in done:
                continue
            done.add(at)
            view = out
            for dim, i in enumerate(at):
                view = view.narrow(dim, i * t.shape[dim], t.shape[dim])
            view.copy_(t)
        return out

    leaves = [tree_leaves(t) for t in per_rank]
    specs_l = spec_leaves(per_rank[0], specs)
    return tree_unflatten(per_rank[0], [
        whole([rl[i] for rl in leaves], s) for i, s in enumerate(specs_l)])


def gather_tensor(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from this rank's shard ``t`` on a bound
    ``RankMesh``: gathered over the axes of each split dim, in group
    order (``shard_tensor``'s). Every rank calls it (a collective)."""
    for dim, entry in enumerate(spec):
        if entry:
            t = mesh.all_gather(t, dim, _entry_axes(entry))
    return t


def shard_cache(cache, specs, mesh, rank: int):
    """Rank ``rank``'s shard of a cache tree under ``sharding.cache_specs``.
    A per-slot ``len`` vector lies with its rows (the batch's axes), which
    ``cache_specs`` leaves replicated as the reference's does."""
    out = _zip_map(lambda t, s: shard_tensor(t, s, mesh, rank), cache, specs)
    lens = cache["len"]
    if lens.ndim == 1:
        seg_spec = next(s for seg in specs["segments"] for e in seg
                        for s in e.values())
        out["len"] = shard_tensor(lens, (seg_spec[1],), mesh, rank)
    return out
