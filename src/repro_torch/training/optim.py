"""AdamW (port of ``repro/training/optim.py``).

The reference's update exactly: fp32 math, moments stored in
``state_dtype``, one global-norm clip over every leaf, linear warmup, bias
correction in fp32, weight decay only on leaves with ``ndim > 1`` (decided
on the stacked leaf, so a segment's (count, d) norm scales are decayed, as
in the reference) and an int32 step. The reference returns new trees; here
params and moments are updated in place under ``torch.no_grad()``, with
the same result. Each leaf is updated in slices of ``SLICE`` elements, so
the fp32 temporaries stay bounded however large the leaf (a full-width
stacked expert leaf is 3.4 GB in fp32).

On a mesh (the rank program's step, ``training.loop``) params, grads and
moments are this rank's shards, the moments shaped like its shards as
the reference's inherit the params' sharding, and the global grad norm
counts each element once: a leaf's sum of squares is summed over the
axes that split it (``sharding.split_axes``), never over its replicas.
"""

from __future__ import annotations

import dataclasses

import torch

from ..bridge import map_tree, spec_leaves, tree_leaves
from ..models.transformer import torch_dtype
from ..sharding import split_axes

SLICE = 1 << 24                    # elements per slice of a leaf's update


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100


def adamw_init(params, cfg: AdamWConfig):
    """Zero moments in ``state_dtype`` beside each leaf, and step 0."""
    dt = torch_dtype(cfg.state_dtype)
    leaf = tree_leaves(params)[0]
    return {"m": map_tree(lambda p: torch.zeros_like(p, dtype=dt), params),
            "v": map_tree(lambda p: torch.zeros_like(p, dtype=dt), params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def _slices(t):
    """Flat views of ``t`` of at most ``SLICE`` elements, in order."""
    return t.view(-1).split(SLICE)


def _global_sumsq(sq, grads, mesh, specs):
    """The sum of the leaves' sums of squares ``sq`` over the whole model:
    on a mesh, the leaves split over the same axes are summed and that
    sum all-reduced over those axes (a replicated leaf's is its own)."""
    if mesh is None:
        return sum(sq)
    groups = {}
    for s, spec in zip(sq, spec_leaves(grads, specs)):
        groups.setdefault(mesh.layout.axes(split_axes(spec)), []).append(s)
    return sum(mesh.all_reduce(torch.stack(parts).sum(), axes)
               for axes, parts in groups.items())


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, mesh=None,
                 specs=None):
    """One AdamW step with global-norm clipping, in place. Returns
    (params, state): the same trees, updated, with ``state["step"]`` a new
    int32 tensor. Every scalar stays a device tensor (no host sync).
    ``mesh`` (this rank's ``RankMesh``) and ``specs`` (the params'
    ``param_specs``): the rank program's step over this rank's shards."""
    step = state["step"] + 1
    lp, lg = tree_leaves(params), tree_leaves(grads)
    lm, lv = tree_leaves(state["m"]), tree_leaves(state["v"])
    sq = [sum(torch.sum(torch.square(s.float()))
              for s in _slices(g.contiguous())) for g in lg]
    gnorm = torch.sqrt(_global_sumsq(sq, grads, mesh, specs))
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    t = step.float()
    lr = cfg.lr * torch.clamp(t / max(cfg.warmup_steps, 1), max=1.0)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    for p, g, m, v in zip(lp, lg, lm, lv):
        decay = p.dim() > 1                 # no decay on norms/bias vectors
        for ps, gs, ms, vs in zip(_slices(p), _slices(g.contiguous()),
                                  _slices(m), _slices(v)):
            g32 = gs.float() * scale
            m32 = cfg.b1 * ms.float() + (1 - cfg.b1) * g32
            v32 = cfg.b2 * vs.float() + (1 - cfg.b2) * g32 * g32
            update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            p32 = ps.float()
            if decay:
                update = update + cfg.weight_decay * p32
            ps.copy_(p32 - lr * update)
            ms.copy_(m32)
            vs.copy_(v32)
    return params, {"m": state["m"], "v": state["v"], "step": step}
