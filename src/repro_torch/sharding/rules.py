"""Expert-parallel layout of a config over an EP group (the EP part of
``repro/sharding/rules.py``).

MoE experts shard over the group's ranks in contiguous blocks of E/n
(expert e on rank ``e // (E / n)``), when n divides E. The reference's
rules for tensor-parallel attention and FFN, vocab, batch and KV-cache
sharding have no counterpart: the port's dense part runs replicated on
every rank.
"""

from __future__ import annotations

from ..models.layers import ParallelContext


def ep_size_for(cfg, group) -> int | None:
    """The EP rank count the experts of ``cfg`` shard over on ``group``
    (the counterpart of ``ep_axes_for``), or None when the config has no
    MoE layers or its expert count does not divide the group."""
    if cfg.moe is None or group is None:
        return None
    return group.n if cfg.moe.n_experts % group.n == 0 else None


def make_pc(cfg, group, moe_impl: str = "ep",
            aurora_rounds=None) -> ParallelContext:
    """ParallelContext for this (config, group). Falls back to dense
    dispatch, silently as the reference does, when the experts do not
    shard over the group (``serving.distributed.distribute`` refuses that
    case loudly)."""
    impl = moe_impl if ep_size_for(cfg, group) is not None else "dense"
    return ParallelContext(group=group, moe_impl=impl,
                           aurora_rounds=aurora_rounds)
