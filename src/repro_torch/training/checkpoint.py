"""Checkpoints in the reference's format (port of
``repro/training/checkpoint.py``): ``arrays.npz`` holding ``leaf_{i}`` and
``manifest.json`` holding ``treedef``, ``n_leaves``, ``step`` and
``dtypes``.

Leaves are numbered in JAX's flatten order (``bridge.tree_leaves``: dict
keys sorted), so a checkpoint written by either package restores into the
other's tree. bfloat16 has no numpy dtype without ``ml_dtypes``: the
reference's ``np.savez`` writes a bf16 leaf as raw 2-byte void (``|V2``),
and so does this module (the 16-bit pattern); on restore, a leaf whose
manifest dtype is ``bfloat16`` is read back from its 16-bit pattern,
whether stored as ``|V2`` or as a 16-bit integer.

On a mesh (the rank program's training) ``shardings`` is ``(specs,
rank_mesh)``: a spec tree matching the tree (``sharding.param_specs``
for params and for AdamW moments, which lie like them; ``()`` for the
step) and this rank's bound ``RankMesh``. ``save_checkpoint`` then
gathers each leaf whole over the ranks (``bridge.gather_tensor``, one
leaf at a time; every rank calls it) and rank 0 writes the whole
leaves, so the files are the reference's whatever mesh wrote them;
``restore_checkpoint`` reads whole leaves and hands each rank its shards
(``bridge.shard_params``), the reference's re-sharding ``device_put``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..bridge import gather_tensor, shard_params, spec_leaves, \
    tree_leaves, tree_unflatten


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _treedef(tree) -> str:
    """The structure as ``str(jax.tree.structure(tree))`` prints it."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, (tuple, list)):
            inner = ", ".join(walk(v) for v in t)
            if isinstance(t, list):
                return f"[{inner}]"
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def save_checkpoint(path: str, tree, step: int | None = None,
                    shardings=None) -> None:
    """Write ``tree`` (with ``shardings``: this rank's shards; every rank
    calls it and rank 0 writes the whole leaves)."""
    leaves = tree_leaves(tree)
    if shardings is not None:
        specs, mesh = shardings
        arrays = {}
        for i, (t, spec) in enumerate(zip(leaves, spec_leaves(tree,
                                                               specs))):
            whole = gather_tensor(t, spec, mesh)
            if mesh.rank == 0:
                arrays[f"leaf_{i}"] = _to_numpy(whole)
        if mesh.rank != 0:
            return
    else:
        arrays = {f"leaf_{i}": _to_numpy(t) for i, t in enumerate(leaves)}
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    manifest = {"treedef": _treedef(tree), "n_leaves": len(leaves),
                "step": step, "dtypes": [_dtype_name(t) for t in leaves]}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _leaf(a: np.ndarray, dtype: str, like) -> torch.Tensor:
    if dtype == "bfloat16":
        if a.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf stored as {a.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)}, "
                         f"template leaf {tuple(like.shape)}")
    return t.to(like.device)


def restore_checkpoint(path: str, like_tree, shardings=None):
    """A new tree of ``like_tree``'s structure (a template of tensors: its
    shapes must match, and each leaf lands on its template's device) with
    the checkpoint's leaves in their stored dtypes; with ``shardings``
    (the template is then of the whole leaves), this rank's shards of
    them."""
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = json.load(f)["dtypes"]
    like = tree_leaves(like_tree)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        if len(like) != len(data.files):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, "
                             f"template has {len(like)}")
        leaves = [_leaf(data[f"leaf_{i}"], dtypes[i], t)
                  for i, t in enumerate(like)]
    tree = tree_unflatten(like_tree, leaves)
    if shardings is not None:
        specs, mesh = shardings
        tree = shard_params(tree, specs, mesh, mesh.rank)
    return tree


def checkpoint_step(path: str) -> int | None:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f).get("step")
