"""Train step and loop (port of ``repro/training/loop.py``).

``make_train_step`` builds the (params, opt, batch) -> (params, opt,
metrics) step: the next-token loss and its grads through autograd, then
``adamw_update`` in place. It runs eagerly (the reference jits it), on
the model's device; ``train_loop`` moves each batch there.

A ``Model`` whose ``pc`` has a mesh (``sharding.make_pc``) trains as the
rank program, the reference's ``make_train_step`` on a mesh: every rank
runs the step on its shards of the params, the AdamW moments (shaped like
its shards) and the batch (its rows, ``sharding.input_sharding``). Its
grads follow ``distributed.mesh``'s convention: each rank seeds its
backward with its loss over the mesh size, and each leaf's grad is then
summed over the axes that replicate it (``reduce_replicas``); the
reported loss and metrics are their means over the ranks, so every rank
reports the global batch's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from ..bridge import shard_params, shard_tensor, spec_leaves, tree_leaves, \
    tree_unflatten
from ..models import Model, cross_entropy
from ..sharding import input_sharding, param_specs, replica_axes
from .optim import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any
    step: int = 0


def make_loss_fn(model: Model, aux_weight: float = 0.01) -> Callable:
    cfg = model.cfg

    def loss_fn(params, batch):
        logits, aux = model.train_logits(params, batch)
        # Next-token LM objective; labels are inputs shifted left.
        tokens = batch["tokens"]
        loss = cross_entropy(logits[:, :-1], tokens[:, 1:], cfg.vocab)
        return loss + aux_weight * aux, {"ce": loss, "aux": aux}

    return loss_fn


def mesh_of(model: Model):
    """The bound ``RankMesh`` a model's rank program runs over, or None."""
    pc = model.pc
    return pc.mesh if pc is not None and pc.mesh is not None else None


def reduce_replicas(grads, specs, mesh):
    """Each leaf's grad summed over the mesh axes that replicate it
    (``sharding.replica_axes`` of its spec): the convention's last step.
    The leaves that share those axes and a dtype go in one all-reduce."""
    leaves = tree_leaves(grads)
    groups = {}
    for i, (g, spec) in enumerate(zip(leaves, spec_leaves(grads, specs))):
        axes = replica_axes(spec, mesh)
        if mesh.axis_size(axes) > 1:
            groups.setdefault((axes, g.dtype), []).append(i)
    out = list(leaves)
    for (axes, _), idx in groups.items():
        flat = mesh.all_reduce(torch.cat([leaves[i].reshape(-1)
                                          for i in idx]), axes)
        for i, part in zip(idx, flat.split([leaves[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(leaves[i])
    return tree_unflatten(grads, out)


def _mesh_mean(mesh, values):
    """The mean over every rank of each scalar in ``values`` (one
    all-reduce)."""
    total = mesh.all_reduce(torch.stack([v.float() for v in values]),
                            mesh.axis_names) / mesh.layout.size
    return list(total.unbind(0))


def loss_and_grads(loss_fn, params, batch, mesh=None, specs=None):
    """(loss, metrics, grads): ``grads`` has ``params``' structure, with
    zeros for a leaf the loss does not reach (JAX's grad of an unused
    input, e.g. a patch-input model's ``frontend_proj`` on tokens). The
    params need grad for the call only. With ``mesh`` (this rank's
    ``RankMesh``; ``specs`` the params' ``param_specs``) it is the rank
    program's: every rank calls it on its shards, and gets the grads of
    its shards of the global loss and the global loss and metrics."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = loss_fn(params, batch)
        if mesh is None:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        else:
            grads = mesh.grad(loss / mesh.layout.size, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = tree_unflatten(params, [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(leaves, grads)])
    loss = loss.detach()
    metrics = {k: v.detach() for k, v in metrics.items()}
    if mesh is not None:
        grads = reduce_replicas(grads, specs, mesh)
        loss, *vals = _mesh_mean(mesh, [loss, *metrics.values()])
        metrics = dict(zip(metrics, vals))
    return loss, metrics, grads


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    aux_weight: float = 0.01) -> Callable:
    """The step of ``model`` (on a mesh ``pc``: this rank's step, which
    every rank runs on its shards)."""
    loss_fn = make_loss_fn(model, aux_weight)
    mesh = mesh_of(model)
    specs = param_specs(model.cfg, mesh) if mesh is not None else None
    on_mesh = {} if mesh is None else {"mesh": mesh, "specs": specs}

    def train_step(params, opt, batch):
        loss, metrics, grads = loss_and_grads(loss_fn, params, batch, mesh,
                                              specs)
        params, opt = adamw_update(params, grads, opt, opt_cfg, **on_mesh)
        metrics = dict(metrics, loss=loss)
        return params, opt, metrics

    return train_step


def train_loop(model: Model, data, steps: int,
               opt_cfg: AdamWConfig | None = None, log_every: int = 10,
               params=None, aux_weight: float = 0.01
               ) -> tuple[TrainState, list[dict]]:
    """Training loop. ``params`` default to ``model.init(0)`` (the
    reference's ``init(PRNGKey(0))``); the history holds ``ce``, ``aux``,
    ``loss``, ``step`` and ``wall`` (seconds since the start) every
    ``log_every`` steps and at the last. On a mesh ``pc`` every rank runs
    it with the same ``data`` stream: ``params`` are this rank's shards
    (by default its shards of ``model.init(0)``) and each batch is cut to
    this rank's rows by ``sharding.input_sharding``."""
    opt_cfg = opt_cfg or AdamWConfig()
    mesh = mesh_of(model)
    if params is None:
        params = model.init(0)
        if mesh is not None:
            params = shard_params(params, param_specs(model.cfg, mesh),
                                  mesh, mesh.rank)
    opt = adamw_init(params, opt_cfg)
    step_fn = make_train_step(model, opt_cfg, aux_weight)

    history = []
    t0 = time.time()
    for i, batch in zip(range(steps), data):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        if mesh is not None:
            spec = input_sharding(model.cfg, mesh,
                                  batch["tokens"].shape[0])
            batch = {k: shard_tensor(v, spec, mesh, mesh.rank)
                     for k, v in batch.items()}
        params, opt, metrics = step_fn(params, opt, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["wall"] = time.time() - t0
            history.append(m)
    return TrainState(params=params, opt=opt, step=steps), history
