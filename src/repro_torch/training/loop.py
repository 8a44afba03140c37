"""Train step and loop (port of ``repro/training/loop.py``).

``make_train_step`` builds the (params, opt, batch) -> (params, opt,
metrics) step: the next-token loss and its grads through autograd, then
``adamw_update`` in place. It runs eagerly (the reference jits it), on
the model's device; ``train_loop`` moves each batch there.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from ..bridge import tree_leaves, tree_unflatten
from ..models import Model, cross_entropy
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


def loss_and_grads(loss_fn, params, batch):
    """(loss, metrics, grads): ``grads`` has ``params``' structure, with
    zeros for a leaf the loss does not reach (JAX's grad of an unused
    input, e.g. a patch-input model's ``frontend_proj`` on tokens). The
    params need grad for the call only."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    aux_weight: float = 0.01) -> Callable:
    loss_fn = make_loss_fn(model, aux_weight)

    def train_step(params, opt, batch):
        loss, metrics, grads = loss_and_grads(loss_fn, params, batch)
        params, opt = adamw_update(params, grads, opt, opt_cfg)
        metrics = dict(metrics, loss=loss)
        return params, opt, metrics

    return train_step


def train_loop(model: Model, data, steps: int,
               opt_cfg: AdamWConfig | None = None, log_every: int = 10,
               params=None, aux_weight: float = 0.01
               ) -> tuple[TrainState, list[dict]]:
    """Single-device training loop. ``params`` default to ``model.init(0)``
    (the reference's ``init(PRNGKey(0))``); the history holds ``ce``,
    ``aux``, ``loss``, ``step`` and ``wall`` (seconds since the start)
    every ``log_every`` steps and at the last."""
    opt_cfg = opt_cfg or AdamWConfig()
    if params is None:
        params = model.init(0)
    opt = adamw_init(params, opt_cfg)
    step_fn = make_train_step(model, opt_cfg, aux_weight)

    history = []
    t0 = time.time()
    for i, batch in zip(range(steps), data):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        params, opt, metrics = step_fn(params, opt, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["wall"] = time.time() - t0
            history.append(m)
    return TrainState(params=params, opt=opt, step=steps), history
