"""Expert-parallel layout of a config over an EP group (the EP part of
``repro/sharding/rules.py``).

MoE experts shard over the group's ranks in contiguous blocks of E/n
(expert e on rank ``e // (E / n)``), when n divides E. The reference's
rules for tensor-parallel attention and FFN, vocab, batch and KV-cache
sharding have no counterpart: the port's dense part runs replicated on
every rank, over the whole batch and the whole cache
(``serving.distributed``), so ``cache_specs`` and ``input_sharding``
have none either.
"""

from __future__ import annotations

from ..models.layers import ParallelContext


def ep_size_for(cfg, group) -> int | None:
    """The EP rank count the experts of ``cfg`` shard over on ``group``
    (the counterpart of ``ep_axes_for``), or None when the config has no
    MoE layers or its expert count does not divide the group. ``group``
    may also be a rank count."""
    if cfg.moe is None or group is None:
        return None
    n = group if isinstance(group, int) else group.n
    return n if cfg.moe.n_experts % n == 0 else None


def param_specs(cfg, n: int):
    """A tree shaped like ``init_params(cfg)`` whose leaves say how each
    param leaf lies over ``n`` EP ranks: -3 (the expert axis of a stacked
    (count, E, d, f) expert leaf, split in blocks of E/n) when the experts
    shard (``ep_size_for``), else None (replicated on every rank)."""
    from ..models.transformer import init_params
    split = -3 if ep_size_for(cfg, n) is not None else None

    def walk(tree, inside=False):
        if isinstance(tree, dict):
            return {k: walk(v, inside or k == "experts")
                    for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, inside) for v in tree)
        return split if inside else None
    return walk(init_params(cfg, device="meta"))


def make_pc(cfg, group, moe_impl: str = "ep",
            aurora_rounds=None) -> ParallelContext:
    """ParallelContext for this (config, group). Falls back to dense
    dispatch, silently as the reference does, when the experts do not
    shard over the group (``serving.distributed.distribute`` refuses that
    case loudly)."""
    impl = moe_impl if ep_size_for(cfg, group) is not None else "dense"
    return ParallelContext(group=group, moe_impl=impl,
                           aurora_rounds=aurora_rounds)
