"""Seeded weights in the tree the program takes, made on the device.

The tree's shape (its leaves' names, shapes and dtypes) is the program's
own, read from ``repro_torch``'s parameter init on the ``meta`` device,
which allocates nothing. The values are the benchmark's: every leaf of a
dtype is a view into one flat buffer, filled by a seeded
``torch.Generator`` on the device in a few large calls, then each view
scaled: a projection by its fan-in ** -0.5, the embedding by 0.02, a
norm's scale (the program applies 1 + w) by 0.1, and the projections
that write into the residual stream (``wo``, ``w_down``) further by
(2 x layers) ** -0.5, as GPT-2 and Megatron initialise them. Without that
last factor some seeds give a model in which any rounding grows through
the layers: its bf16 outputs then stray as far from the fp32 reference
as float8 ones do, whatever computes them (PERF.md §2). The same buffers
can be filled again from another seed in place.
"""

from __future__ import annotations

import math

import torch

FILL_CHUNK = 1 << 30           # elements per generator call
ALIGN = 128                    # elements: every leaf starts 256-B aligned

# Leaves whose fan-in is not their second-to-last dim: (..., in, heads,
# head width) projections and the (..., heads, head width, out) output.
_FAN_IN_AT = {"wq": -3, "wk": -3, "wv": -3, "wq_b": -3, "wk_b": -3,
              "wv_b": -3}


_RESIDUAL = ("wo", "w_down")


def leaf_scale(name: str, shape, n_layers: int) -> float:
    if name == "embed":
        return 0.02
    if "norm" in name or name.startswith("ln"):
        return 0.1
    branch = (2 * n_layers) ** -0.5 if name in _RESIDUAL else 1.0
    if name == "wo":
        return branch * (shape[-3] * shape[-2]) ** -0.5
    return branch * shape[_FAN_IN_AT.get(name, -2)] ** -0.5


def _leaves(tree, name=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, name)
    else:
        yield name, tree


def _rebuild(tree, fn, name=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, name) for v in tree)
    return fn(name, tree)


class Weights:
    """``params``: the tree of views; ``fill(seed)`` writes the values.
    ``n_layers``: the decoder's depth, for the residual projections'
    scale."""

    def __init__(self, meta_tree, device, n_layers: int):
        self.device = torch.device(device)
        sizes: dict[torch.dtype, int] = {}
        slots = {}
        for i, (_, leaf) in enumerate(_leaves(meta_tree)):
            off = sizes.get(leaf.dtype, 0)
            slots[i] = (leaf.dtype, off)
            sizes[leaf.dtype] = off + math.ceil(leaf.numel() / ALIGN) * ALIGN
        self.buffers = {dt: torch.empty(n, dtype=dt, device=self.device)
                        for dt, n in sizes.items()}
        self._scaled = []
        counter = iter(range(len(slots)))

        def view(name, leaf):
            dt, off = slots[next(counter)]
            t = self.buffers[dt][off:off + leaf.numel()].view(leaf.shape)
            self._scaled.append((t, leaf_scale(name, leaf.shape, n_layers)))
            return t
        self.params = _rebuild(meta_tree, view)

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.buffers.values())

    @torch.no_grad()
    def fill(self, seed: int) -> None:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed & ((1 << 64) - 1))
        for dt in sorted(self.buffers, key=str):
            buf = self.buffers[dt]
            for a in range(0, buf.numel(), FILL_CHUNK):
                buf[a:a + FILL_CHUNK].normal_(generator=gen)
        for t, scale in self._scaled:
            t.mul_(scale)
