"""Aurora colocated serving (§6 of the paper, as a runtime): port of
``repro/serving/colocated.py``.

The paper colocates experts of two (or N) different models on each device,
so that one model's compute can overlap another model's all-to-all. The
expert->device pairing comes from ``AuroraPlanner.plan_colocated`` (or
``plan_multi`` for N tenants) and is realised by permuting a tenant's
expert weights and router columns together (``apply_pairing``): placement
changes where an expert sits, never the function the model computes.

On one card every device slot is a position along the expert axis, so a
pairing moves no work between devices: the engines here serve N tenants
in lockstep and close the re-planning loop, and what placement buys waits
for expert parallelism. The lockstep step runs the tenants' decode calls
one after the other on the current stream (the reference fuses them into
one XLA program).

Re-seating a pairing (``reseat_pairing``) works IN PLACE: the old and the
new pairing are composed into one permutation and each stacked expert leaf
is permuted one layer slice at a time, so the transient stays at one
(E, d, F) slab. A params tree handed to an engine is the engine's to
re-seat.

Tenants. Any family but the encoder-decoder colocates, as in the
reference: an MoE model, a dense one, mamba2 (SSM), zamba2 (Mamba2 blocks
and a shared attention block) and qwen2-vl (M-RoPE positions, which are
the token positions here: the engines pass tokens only). Each tenant's
cache is its own (KV, an SSM conv window and fp32 state, or both); the
lockstep step freezes the rows of vacant slots and in-flight chunked
prefills through the row masks (``Model.decode_step(row_mask=...)``), as a
tenant's ``ContinuousEngine`` does alone. A tenant without experts gets no
pairing: the dual-model pairing defaults to the identity over tenant B's
experts (empty when B has none), the N-tenant groups to the identity over
tenant 0's, and re-planning refuses. SeamlessM4T is refused
(``engine.refuse_encoder_decoder``; the continuous engines through their
``ContinuousEngine`` pools): its encoder needs frames, which the engines
do not pass.

The lockstep decode is a step callable like the pools' own: it passes
through ``EngineConfig.step_wrapper`` and, with a telemetry hub, becomes a
``lockstep_decode`` span inside a ``lockstep_step`` span; adoptions are
recorded on the hub, which the pools and the re-planner share.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.errors import PlanError
from ..models import Model
from ..models.moe import expert_leaves, expert_slabs
from .config import (EngineConfig, TenantSpec, coerce_config,
                     scale_admission)
from .engine import refuse_encoder_decoder, wrap_step_callable
from .telemetry import record_adoption

__all__ = ["ColocatedContinuousEngine", "ColocatedEngine",
           "MultiTenantContinuousEngine", "apply_pairing",
           "build_lockstep_step", "inverse_pair", "reseat_pairing"]


def _pool_config_for(config: EngineConfig, spec: TenantSpec | None):
    """Single-tenant pool view of a (possibly multi-tenant) EngineConfig:
    kernels off (the engine kernelizes each model once, up front; a pool
    kernelizing again would wrap twice), the tenant's own ``TenantSpec``
    installed so the pool stamps its deadlines, and the shared admission
    budget scaled by the tenant's ``rate_share``."""
    admission = config.resolve_admission()
    if spec is not None and spec.rate_share is not None:
        admission = scale_admission(admission, spec.rate_share)
    # The resolved policy subsumes the chunk/budget/bucket shorthand:
    # clear those fields so the replaced config stays consistent.
    return dataclasses.replace(
        config, kernels=False, admission=admission, prefill_chunk=None,
        step_token_budget=None, bucket_policy="pow2",
        tenants=(spec,) if spec is not None else ())


def _map_leaves(fn, tree, names=()):
    """``fn(leaf, axis)`` over every leaf, rebuilt into a tree of the same
    structure. ``axis`` is the expert axis of the leaves that carry one
    (stacked expert weights (count, E, ...): 1; a router (count, d, E): its
    last), else None."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, names + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v, names) for v in tree)
    if "experts" in names:
        return fn(tree, 1)
    if names and names[-1] == "router":
        return fn(tree, tree.ndim - 1)
    return fn(tree, None)


def _routers(tree, key=None) -> list:
    """Every router leaf of ``tree``, (count, d, E) each."""
    if isinstance(tree, dict):
        return [r for k, v in tree.items() for r in _routers(v, k)]
    if isinstance(tree, (tuple, list)):
        return [r for v in tree for r in _routers(v, key)]
    return [tree] if key == "router" else []


def _index(perm, leaf):
    return torch.as_tensor(perm, dtype=torch.long, device=leaf.device)


def apply_pairing(params_b, pair: list[int], cfg_b):
    """Permute model B's expert axis so b-expert ``pair[k]`` lands on the
    device slot of a-expert k (the planner's colocation choice). The
    router's output columns take the SAME permutation, so routing follows
    the moved experts. Returns a new tree (the expert leaves and routers
    are new tensors, the rest is shared); ``apply_pairing(.,
    inverse_pair(pair), .)`` afterwards gives the original params back."""
    return _map_leaves(
        lambda leaf, axis: (leaf if axis is None
                            else leaf.index_select(axis, _index(pair, leaf))),
        params_b)


def inverse_pair(pair: list[int]) -> list[int]:
    """The permutation that undoes ``apply_pairing(., pair, .)``."""
    inv = [0] * len(pair)
    for slot, expert in enumerate(pair):
        inv[expert] = slot
    return inv


def reseat_pairing(params, old_pair, new_pair, cfg):
    """Re-realise a slot->expert pairing IN PLACE: the permutation baked
    into ``params`` (``old_pair``) is replaced by ``new_pair``. Returns
    ``params``.

    This is the one placement-identity checkpoint of every adoption path
    (re-pair, re-group, re-assign). Both maps must be permutations of the
    expert ids (anything else would duplicate or drop experts). The
    reference undoes the old pairing and applies the new one; here the two
    are composed into one permutation (slot k takes the expert now at slot
    ``inverse_pair(old_pair)[new_pair[k]]``) and applied once, each
    stacked leaf one layer slice at a time, so no second copy of the
    weights is ever made. The values only move, so the result is bit-equal
    to the two-step version."""
    old_pair, new_pair = list(old_pair), list(new_pair)
    n = len(old_pair)
    ids = list(range(n))
    for name, pair in (("current", old_pair), ("new", new_pair)):
        if sorted(pair) != ids:
            raise PlanError(
                f"{name} pairing {pair} is not a permutation of the expert "
                f"ids 0..{n - 1} — re-seating it would duplicate/drop "
                "experts")
    if old_pair == new_pair:
        return params
    inv_old = inverse_pair(old_pair)
    composed = [inv_old[e] for e in new_pair]

    with torch.no_grad():
        for leaf in expert_leaves(params):
            for slab in expert_slabs(leaf):      # (E, ...) per layer
                slab.copy_(slab.index_select(0, _index(composed, slab)))
        for router in _routers(params):
            for layer in router:                 # (d, E) per layer
                layer.copy_(layer.index_select(1, _index(composed, layer)))
    return params


def build_lockstep_step(models: list[Model], collect_stats: bool):
    """One decode step over N tenants: ``step(params_list, tokens_list,
    caches_list, masks_list)`` runs every tenant's decode in turn on the
    current stream and returns ``(logits_list, caches_list)``, plus a
    per-tenant list of (n_moe_layers, B, E) routing counts when
    ``collect_stats``. ``masks_list`` holds one (B,) bool row mask per
    tenant: vacant slots and in-flight chunked prefills keep their cache
    rows. Caches are updated in place."""
    if collect_stats:
        def step(params, tokens, caches, masks):
            outs = [m.decode_step_stats(p, t, c, mask)
                    for m, p, t, c, mask
                    in zip(models, params, tokens, caches, masks)]
            return ([o[0] for o in outs], [o[1] for o in outs],
                    [o[2] for o in outs])
    else:
        def step(params, tokens, caches, masks):
            outs = [m.decode_step(p, t, c, mask)
                    for m, p, t, c, mask
                    in zip(models, params, tokens, caches, masks)]
            return [o[0] for o in outs], [o[1] for o in outs]
    return step


def _rounds_of(model: Model):
    """A model's current permutation rounds (None off the "aurora" path)."""
    return model.pc.aurora_rounds if model.pc is not None else None


def _share_hub(replan, config: EngineConfig) -> None:
    """The re-planner publishes on the engine's hub unless it has one."""
    if replan is not None and config.telemetry is not None \
            and getattr(replan, "telemetry", None) is None:
        replan.telemetry = config.telemetry


def _row_masks(pools):
    """Host (B,) bool occupancy of each pool, and its device copy."""
    masks = [np.array([r is not None for r in p.slots], bool) for p in pools]
    return masks, [torch.from_numpy(m).to(p.device)
                   for m, p in zip(masks, pools)]


def _require_replannable(models, what: str):
    """Re-planning pairs experts across tenants layer by layer: every model
    needs MoE layers, one expert count and one MoE layer count. A dense,
    SSM, hybrid or vlm tenant has no experts to pair, so it is refused
    with the reference's message (``what``: "re-planning" for the
    dual-model engine, "re-grouping" for the N-tenant one)."""
    cfgs = [m.cfg for m in models]
    if (any(c.moe is None for c in cfgs)
            or len({c.moe.n_experts for c in cfgs}) != 1):
        who, unit = (("two MoE models", "pairing") if what == "re-planning"
                     else ("MoE tenants", "grouping"))
        raise ValueError(f"online {what} needs {who} with equal expert "
                         f"counts (the {unit} is expert<->expert)")
    if len({m.n_moe_layers for m in models}) != 1:
        raise ValueError(f"online {what} needs equal MoE layer counts "
                         "(the planner simulates the traces layer-by-layer)")


@dataclasses.dataclass
class ColocatedEngine:
    """Serve two models on one card, one static batch each, their decode
    steps in lockstep."""

    model_a: Model
    model_b: Model
    params_a: object
    params_b: object

    def __post_init__(self):
        for m in (self.model_a, self.model_b):
            refuse_encoder_decoder(m, "ColocatedEngine")

    def serve(self, prompts_a, prompts_b, max_new_tokens: int,
              cache_cap: int):
        """Greedy-decode both batches in lockstep (no left padding: every
        prompt of a batch has one length). Returns (out_a, out_b), (B, T)
        int64 tensors on the models' devices."""
        ma, mb = self.model_a, self.model_b
        ta = torch.as_tensor(np.asarray(prompts_a), device=ma.device)
        tb = torch.as_tensor(np.asarray(prompts_b), device=mb.device)
        ca = ma.init_cache(ta.shape[0], cache_cap)
        cb = mb.init_cache(tb.shape[0], cache_cap)
        la, ca = ma.prefill(self.params_a, {"tokens": ta}, ca)
        lb, cb = mb.prefill(self.params_b, {"tokens": tb}, cb)
        va, vb = ma.cfg.vocab, mb.cfg.vocab
        tok_a = torch.argmax(la[:, -1:, :va], dim=-1)
        tok_b = torch.argmax(lb[:, -1:, :vb], dim=-1)
        out_a, out_b = [tok_a], [tok_b]
        for _ in range(max_new_tokens - 1):
            la, ca = ma.decode_step(self.params_a, tok_a, ca)
            lb, cb = mb.decode_step(self.params_b, tok_b, cb)
            tok_a = torch.argmax(la[:, :, :va], dim=-1)
            tok_b = torch.argmax(lb[:, :, :vb], dim=-1)
            out_a.append(tok_a)
            out_b.append(tok_b)
        return torch.cat(out_a, 1), torch.cat(out_b, 1)


class ColocatedContinuousEngine:
    """Continuous batching for the dual-model runtime.

    Two ``ContinuousEngine`` slot pools, one per model, admit from their
    own queues and decode in lockstep (``build_lockstep_step``); each
    pool's slots fill and drain with its own traffic.

    ``pair`` is the pairing already realised in ``params_b`` (identity when
    None). With ``replan=OnlineReplanner(...)`` both pools feed live
    routing counts into ``TrafficMonitor``s and every ``replan.interval``
    lockstep decodes the planner re-pairs from the live traces; an adopted
    plan is re-seated in pool B's params in place (``reseat_pairing``),
    placement-only, so a mid-stream re-plan changes no emitted token.
    """

    def __init__(self, model_a: Model, model_b: Model, params_a, params_b,
                 batch_slots: int, cache_cap: int,
                 config: EngineConfig | None = None,
                 pair: list[int] | None = None,
                 replan=None, monitor_halflife: float = 128.0, **legacy):
        from .engine import ContinuousEngine
        from .monitor import TrafficMonitor

        config = coerce_config(config, legacy, type(self).__name__)
        self.config = config
        # Kernelize once, before the pools and the lockstep step exist.
        model_a = config.kernelize(model_a)
        model_b = config.kernelize(model_b)
        self.model_a, self.model_b = model_a, model_b
        self.replan = replan
        self.monitor_a = self.monitor_b = None
        if replan is not None:
            _require_replannable([model_a, model_b], "re-planning")
            ca, cb = model_a.cfg, model_b.cfg
            self.monitor_a = TrafficMonitor(
                ca.moe.n_experts, model_a.n_moe_layers, name=ca.arch_id,
                halflife=monitor_halflife)
            self.monitor_b = TrafficMonitor(
                cb.moe.n_experts, model_b.n_moe_layers, name=cb.arch_id,
                halflife=monitor_halflife)
        n_e = model_b.cfg.moe.n_experts if model_b.cfg.moe else 0
        self.pair = list(pair) if pair is not None else list(range(n_e))
        self.plan = None                        # last adopted online plan
        if self.monitor_b is not None:
            # Pool B's stats arrive in SLOT space (its router columns are
            # permuted); the monitor maps them back to expert ids.
            self.monitor_b.slot_to_expert = list(self.pair)
        if config.tenants and len(config.tenants) != 2:
            raise ValueError(
                f"{len(config.tenants)} TenantSpecs for the dual-model "
                "engine — declare exactly two (model A then model B) or "
                "none")
        self.tenant_specs = (list(config.tenants) if config.tenants
                             else [None, None])
        self.pool_a = ContinuousEngine(
            model_a, params_a, batch_slots, cache_cap,
            config=_pool_config_for(config, self.tenant_specs[0]),
            monitor=self.monitor_a)
        self.pool_b = ContinuousEngine(
            model_b, params_b, batch_slots, cache_cap,
            config=_pool_config_for(config, self.tenant_specs[1]),
            monitor=self.monitor_b)
        self._telemetry = config.telemetry
        _share_hub(replan, config)
        self._build_lockstep()
        self.decode_steps = 0

    def _build_lockstep(self) -> None:
        """(Re)build the lockstep step from the current models (rebuilt
        when a distributed engine swaps its permutation rounds)."""
        self._step = wrap_step_callable(build_lockstep_step(
            [self.model_a, self.model_b],
            collect_stats=self.replan is not None),
            "lockstep_decode", self.config,
            rounds=lambda: _rounds_of(self.model_a))

    @property
    def replan_events(self) -> list:
        return [] if self.replan is None else list(self.replan.events)

    def adopt(self, plan) -> None:
        """Adopt a colocation ``Plan`` mid-stream: re-seat its pairing in
        pool B's params (``reseat_pairing``, in place, placement-only)."""
        new_pair = list(plan.pair)
        self.pool_b.params = reseat_pairing(self.pool_b.params, self.pair,
                                            new_pair, self.model_b.cfg)
        self.pair = new_pair
        if self.monitor_b is not None:
            self.monitor_b.slot_to_expert = list(new_pair)
        self.plan = plan
        record_adoption(self._telemetry, "pairing", step=self.decode_steps,
                        pair=new_pair)

    def _adopt_online(self, plan) -> None:
        """Seam for the re-planning loop (the distributed engine refreshes
        its permutation rounds on top)."""
        self.adopt(plan)

    def _maybe_replan(self) -> None:
        new = self.replan.maybe_replan(self.decode_steps, self.monitor_a,
                                       self.monitor_b, self.pair)
        if new is not None:
            self._adopt_online(new)

    def step(self) -> bool:
        """Admission ticks of both pools, one lockstep decode, the routing
        observations, both pools' bookkeeping, then re-planning (the
        reference's order: vacant slots' stale tokens take part in MoE
        capacity, so the sub-calls keep it). Returns False when idle."""
        tel = self._telemetry
        if tel is None or not tel.enabled:
            return self._step_impl()
        with tel.span("lockstep_step", step=self.decode_steps):
            return self._step_impl()

    def _step_impl(self) -> bool:
        a, b = self.pool_a, self.pool_b
        worked_a = a._admit_tick()
        worked_b = b._admit_tick()
        if a.num_active == 0 and b.num_active == 0:
            return worked_a or worked_b
        masks, dev_masks = _row_masks((a, b))
        out = self._step([a.params, b.params], [a.tokens, b.tokens],
                         [a.cache, b.cache], dev_masks)
        (la, lb), (a.cache, b.cache) = out[0], out[1]
        if self.replan is not None:
            for pool, stats, mask in zip((a, b), out[2], masks):
                pool._observe_decode_routing(stats, mask)
        self.decode_steps += 1
        a._postdecode(la)
        b._postdecode(lb)
        if self.replan is not None:
            self._maybe_replan()
        return True

    def serve(self, reqs_a, reqs_b):
        """Run both request streams to completion (``Request.arrival`` in
        lockstep-step units). Returns (reqs_a, reqs_b)."""
        from .engine import serve_stream

        serve_stream(self.step, [(self.pool_a, reqs_a),
                                 (self.pool_b, reqs_b)])
        return reqs_a, reqs_b


class MultiTenantContinuousEngine:
    """Continuous batching over N >= 2 colocated tenants.

    The dual-model engine generalised: one ``ContinuousEngine`` slot pool
    per tenant, each admitting from its own queue, all decoding in lockstep
    (``build_lockstep_step``).

    ``groups[g] = (e_0, .., e_{N-1})`` is the planner's k-way colocation
    choice (``AuroraPlanner.plan_multi``): tenant t's expert ``groups[g][t]``
    sits on device slot g, tenant 0 anchoring the slots
    (``groups[g][0] == g``). The caller realises a grouping by permuting
    tenant t's params with ``apply_pairing(params_t, [g[t] for g in
    groups])``. Alternatively the engine is built from ``config.tenants``
    alone: each ``TenantSpec`` carries its model, LOGICAL params and
    ``pair``; the engine realises the pairings (``apply_pairing``, new
    tensors) and derives ``groups``.

    With ``replan=OnlineReplanner(...)`` every tenant feeds its own
    ``TrafficMonitor`` and the planner periodically re-groups from the N
    live traces (``OnlineReplanner.maybe_regroup``); an adopted grouping
    is re-seated per tenant in place, placement-only. ``admit_tenant`` and
    ``evict_tenant`` change the tenant set between steps.
    """

    def __init__(self, models: list[Model] | None = None,
                 params: list | None = None, batch_slots: int = None,
                 cache_cap: int = None, config: EngineConfig | None = None,
                 groups: list[tuple[int, ...]] | None = None,
                 replan=None, monitor_halflife: float = 128.0, **legacy):
        from .engine import ContinuousEngine
        from .monitor import TrafficMonitor

        if batch_slots is None or cache_cap is None:
            raise TypeError("batch_slots and cache_cap are required")
        config = coerce_config(config, legacy, type(self).__name__)
        self.config = config
        if models is None:
            # Config-driven construction: every tenant (model, params,
            # placement) comes from one validated TenantSpec.
            if params is not None:
                raise ValueError("params without models — declare both on "
                                 "the TenantSpecs instead")
            if groups is not None:
                raise ValueError("groups conflict with config-driven "
                                 "construction — declare per-tenant "
                                 "placement via TenantSpec.pair")
            specs = list(config.tenants)
            if len(specs) < 2:
                raise ValueError(
                    "config-driven construction needs >= 2 TenantSpecs in "
                    "config.tenants (or pass models/params explicitly)")
            missing = [t for t, s in enumerate(specs)
                       if s.model is None or s.params is None]
            if missing:
                raise ValueError(
                    f"TenantSpecs {missing} declare no model/params — "
                    "config-driven construction needs both on every spec")
            models = [s.model for s in specs]
            n_e = (models[0].cfg.moe.n_experts
                   if models[0].cfg.moe is not None else 0)
            pairs = [list(s.pair) if s.pair is not None else list(range(n_e))
                     for s in specs]
            if pairs and pairs[0] != list(range(len(pairs[0]))):
                raise ValueError("tenant 0 anchors the slots — its "
                                 "TenantSpec.pair must be the identity")
            params = [apply_pairing(s.params, p, s.model.cfg)
                      if p != list(range(len(p))) else s.params
                      for s, p in zip(specs, pairs)]
            groups = [tuple(p[g] for p in pairs)
                      for g in range(len(pairs[0]) if pairs else 0)] or None
        else:
            specs = list(config.tenants)
            if specs and len(specs) != len(models):
                raise ValueError(f"{len(specs)} TenantSpecs for "
                                 f"{len(models)} models — declare one per "
                                 "tenant or none")
        self.tenant_specs = specs or [None] * len(models)
        if len(models) < 2:
            raise ValueError("MultiTenantContinuousEngine needs >= 2 tenants "
                             "(use ContinuousEngine for one)")
        if len(params) != len(models):
            raise ValueError("one params tree per model required")
        models = [config.kernelize(m) for m in models]
        self.models = list(models)
        self.n_tenants = len(models)
        self.batch_slots = batch_slots
        self.cache_cap = cache_cap
        self.monitor_halflife = monitor_halflife
        self.replan = replan
        self.monitors = None
        if replan is not None:
            _require_replannable(models, "re-grouping")
            self.monitors = [
                TrafficMonitor(m.cfg.moe.n_experts, m.n_moe_layers,
                               name=f"{m.cfg.arch_id}#{t}",
                               halflife=monitor_halflife)
                for t, m in enumerate(models)]
        n_e = models[0].cfg.moe.n_experts if models[0].cfg.moe else 0
        if groups is None:
            groups = [(g,) * self.n_tenants for g in range(n_e)]
        self.groups = [tuple(g) for g in groups]
        if n_e and len(self.groups) != n_e:
            raise ValueError(f"{len(self.groups)} groups for {n_e} experts "
                             "(one device slot per expert group)")
        for g, grp in enumerate(self.groups):
            if len(grp) != self.n_tenants:
                raise ValueError(f"group {g} has {len(grp)} entries for "
                                 f"{self.n_tenants} tenants")
            if grp[0] != g:
                raise ValueError("tenant 0 anchors the slots: "
                                 f"groups[{g}][0] must be {g}, got {grp[0]}")
        for t in range(1, self.n_tenants):
            if sorted(g[t] for g in self.groups) != list(
                    range(len(self.groups))):
                raise ValueError(f"tenant {t}'s column is not a permutation "
                                 "of the expert ids (each expert must sit "
                                 "on exactly one slot)")
        self.plan = None                        # last adopted online plan
        if self.monitors is not None:
            # Permuted tenants' stats arrive in SLOT space; each monitor
            # maps them back to expert ids (tenant 0 is the anchor).
            for t in range(1, self.n_tenants):
                self.monitors[t].slot_to_expert = self.tenant_pair(t)
        self.pools = [
            ContinuousEngine(m, p, batch_slots, cache_cap,
                             config=_pool_config_for(
                                 config, self.tenant_specs[t]),
                             monitor=(self.monitors[t] if self.monitors
                                      else None))
            for t, (m, p) in enumerate(zip(models, params))]
        self._telemetry = config.telemetry
        _share_hub(replan, config)
        self._build_lockstep()
        self.decode_steps = 0

    def _build_lockstep(self) -> None:
        """(Re)build the N-tenant step from the current models (tenant
        churn changes the list; a distributed engine's rounds swap too)."""
        self._step = wrap_step_callable(build_lockstep_step(
            self.models, collect_stats=self.replan is not None),
            "lockstep_decode", self.config,
            rounds=lambda: _rounds_of(self.models[0]))

    @property
    def replan_events(self) -> list:
        return [] if self.replan is None else list(self.replan.events)

    def tenant_pair(self, t: int) -> list[int]:
        """Slot->expert permutation realised for tenant t."""
        return [g[t] for g in self.groups]

    def adopt(self, plan) -> None:
        """Adopt a k-way grouping ``Plan`` mid-stream: per tenant, re-seat
        the realised slot->expert permutation to the plan's, in place
        (``reseat_pairing``). Placement-only. Every tenant is re-seated,
        tenant 0 included (after churn its column need not be the
        identity)."""
        new_groups = [tuple(g) for g in plan.groups]
        if any(len(g) != self.n_tenants for g in new_groups):
            raise PlanError(
                f"plan groups tenant count {[len(g) for g in new_groups]} "
                f"!= engine tenant count {self.n_tenants}")
        for t in range(self.n_tenants):
            old_p = self.tenant_pair(t)
            new_p = [g[t] for g in new_groups]
            if old_p == new_p:
                continue
            self.pools[t].params = reseat_pairing(
                self.pools[t].params, old_p, new_p, self.models[t].cfg)
            if self.monitors is not None:
                self.monitors[t].slot_to_expert = new_p
        self.groups = new_groups
        self.plan = plan
        record_adoption(self._telemetry, "grouping", step=self.decode_steps,
                        groups=new_groups)

    def _adopt_online(self, plan) -> None:
        """Seam for the re-grouping loop (the distributed engine refreshes
        its permutation rounds on top)."""
        self.adopt(plan)

    def _maybe_regroup(self) -> None:
        new = self.replan.maybe_regroup(self.decode_steps, self.monitors,
                                        self.groups)
        if new is not None:
            self._adopt_online(new)

    # -- tenant churn ------------------------------------------------------
    def admit_tenant(self, model: Model | TenantSpec = None, params=None, *,
                     pair: list[int] | None = None,
                     spec: TenantSpec | None = None) -> int:
        """Admit a NEW tenant into the live engine; returns its index.

        Takes a ``TenantSpec`` carrying model/params/pair (and SLO targets,
        honoured by the new pool), or the unbundled ``(model, params,
        pair=...)``. ``params`` are in the LOGICAL frame; ``pair`` (identity
        when omitted) is realised here with ``apply_pairing``. The tenant
        gets its own slot pool and, under a replanner, its own monitor; the
        groups gain its column. Every incumbent's pool, cache and token
        stream are untouched.
        """
        from .engine import ContinuousEngine
        from .monitor import TrafficMonitor

        if isinstance(model, TenantSpec):
            if spec is not None:
                raise ValueError("pass the TenantSpec once (positionally "
                                 "or as spec=, not both)")
            spec, model = model, None
        if spec is not None:
            if model is not None or params is not None or pair is not None:
                raise ValueError("pass EITHER a TenantSpec or unbundled "
                                 "model/params/pair — not both")
            if spec.model is None or spec.params is None:
                raise ValueError("admit_tenant needs model and params on "
                                 "the TenantSpec")
            model, params, pair = spec.model, spec.params, spec.pair
        elif model is None or params is None:
            raise TypeError("admit_tenant needs a TenantSpec or "
                            "(model, params)")
        model = self.config.kernelize(model)
        cfg = model.cfg
        n_e = len(self.groups)
        if self.replan is not None:
            _require_replannable([self.models[0], model], "re-grouping")
        pair = list(pair) if pair is not None else list(range(n_e))
        if n_e and sorted(pair) != list(range(n_e)):
            raise ValueError(f"pair {pair} is not a permutation of the "
                             f"expert ids 0..{n_e - 1}")
        if pair != list(range(n_e)):
            params = apply_pairing(params, pair, cfg)
        t = self.n_tenants
        monitor = None
        if self.monitors is not None:
            monitor = TrafficMonitor(n_e, model.n_moe_layers,
                                     name=f"{cfg.arch_id}#{t}",
                                     halflife=self.monitor_halflife)
            monitor.slot_to_expert = list(pair)
        # The pool first: a tenant it refuses (an encoder-decoder) leaves
        # the engine as it was.
        pool = ContinuousEngine(
            model, params, self.batch_slots, self.cache_cap,
            config=_pool_config_for(self.config, spec), monitor=monitor)
        if monitor is not None:
            self.monitors.append(monitor)
        self.models.append(model)
        self.pools.append(pool)
        self.tenant_specs.append(spec)
        self.groups = [grp + (pair[g],) for g, grp in enumerate(self.groups)]
        self.n_tenants += 1
        self._build_lockstep()
        return t

    def evict_tenant(self, t: int):
        """Remove tenant ``t``; returns its detached slot pool (still
        serveable alone). Its queued and in-flight requests leave with the
        pool; its column, monitor and lockstep row disappear. The surviving
        tenants' pools and caches are untouched."""
        if not 0 <= t < self.n_tenants:
            raise ValueError(f"no tenant {t} (have {self.n_tenants})")
        if self.n_tenants <= 1:
            raise ValueError("cannot evict the last tenant")
        if self.n_tenants == 2 and self.replan is not None:
            raise ValueError(
                "eviction would leave one tenant — nothing to re-group; "
                "drop the replanner (or keep >= 2 tenants)")
        pool = self.pools.pop(t)
        self.models.pop(t)
        self.tenant_specs.pop(t)
        if self.monitors is not None:
            self.monitors.pop(t)
        self.groups = [g[:t] + g[t + 1:] for g in self.groups]
        self.n_tenants -= 1
        self._build_lockstep()
        return pool

    def step(self) -> bool:
        """Admission ticks of every pool, one lockstep decode, the routing
        observations, every pool's bookkeeping, then re-grouping."""
        tel = self._telemetry
        if tel is None or not tel.enabled:
            return self._step_impl()
        with tel.span("lockstep_step", step=self.decode_steps,
                      tenants=self.n_tenants):
            return self._step_impl()

    def _step_impl(self) -> bool:
        worked = [p._admit_tick() for p in self.pools]
        if all(p.num_active == 0 for p in self.pools):
            return any(worked)
        masks, dev_masks = _row_masks(self.pools)
        out = self._step([p.params for p in self.pools],
                         [p.tokens for p in self.pools],
                         [p.cache for p in self.pools], dev_masks)
        if self.replan is not None:
            for pool, stats, mask in zip(self.pools, out[2], masks):
                pool._observe_decode_routing(stats, mask)
        for p, c in zip(self.pools, out[1]):
            p.cache = c
        self.decode_steps += 1
        for p, lg in zip(self.pools, out[0]):
            p._postdecode(lg)
        if self.replan is not None:
            self._maybe_regroup()
        return True

    def serve(self, streams: list[list]) -> list[list]:
        """Run one request stream per tenant to completion
        (``Request.arrival`` in lockstep-step units)."""
        from .engine import serve_stream

        if len(streams) != self.n_tenants:
            raise ValueError(f"{self.n_tenants} tenants need "
                             f"{self.n_tenants} request streams")
        serve_stream(self.step, list(zip(self.pools, streams)))
        return streams
