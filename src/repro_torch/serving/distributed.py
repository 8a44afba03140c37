"""Expert-parallel serving: the continuous engines over an EP group (port of
``repro/serving/distributed.py``).

The three continuous engines run their host-side schedulers unchanged;
only their models change:

- the MoE layers dispatch expert-parallel over the group's ranks
  (``moe_impl="ep"``: the monolithic all-to-all; ``"aurora"``: the paper's
  BvN permutation rounds; ``overlap=True``: the rounds pipelined with the
  grouped expert FFN, ``repro_torch.distributed.overlap``); the dense part
  runs replicated on every rank over the whole batch;
- live routing counts keep flowing to ``TrafficMonitor`` (gathered from
  the ranks), so online re-planning works distributed;
- a re-plan **also refreshes the rounds**: ``adopt(plan)`` recomputes
  ``aurora_schedule`` -> ``aurora_rounds_from_schedule`` at rank
  granularity and swaps them in. The swap is placement-only: rounds
  change *when* bytes move, never what arrives, so token streams are
  unaffected.

The group is the caller's choice (``distributed.DistGroup``: one process
per card over ``torch.distributed``; ``distributed.LocalGroup(n, device)``:
n in-process ranks on one device). Where the reference rebuilds a mesh and
recompiles, the port swaps the model's ``ParallelContext`` and rebuilds the
step callables (``_rebind``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.errors import FaultError, PlanError
from ..core.schedule import aurora_schedule
from ..core.traffic import MoETrace, strip_diagonal
from ..distributed.alltoall import (aurora_rounds_from_schedule,
                                    round_robin_rounds,
                                    validate_rounds_cover)
from ..models import Model
from ..sharding import make_pc
from .colocated import ColocatedContinuousEngine, MultiTenantContinuousEngine
from .config import EngineConfig
from .engine import ContinuousEngine
from .telemetry import record_adoption

__all__ = ["DistributedColocatedEngine", "DistributedEngine",
           "DistributedMultiTenantEngine", "device_traffic", "distribute",
           "ep_size", "resolve_rounds", "rounds_from_plan",
           "rounds_from_trace", "rounds_from_traffic"]


# ---------------------------------------------------------------------------
# Rounds derivation: expert-granularity plans -> rank-granularity rounds
# ---------------------------------------------------------------------------

def device_traffic(d: np.ndarray, n_devices: int) -> np.ndarray:
    """Aggregate an (E, E) expert-granularity traffic matrix onto the EP
    ranks hosting the experts.

    Experts shard over the ranks in contiguous blocks (expert e on rank
    ``e // (E / n_devices)``), so rank-pair traffic is the block sum. The
    diagonal (now including intra-rank expert pairs) is stripped:
    self-traffic never crosses the network.
    """
    d = np.asarray(d, dtype=np.float64)
    e = d.shape[0]
    if d.ndim != 2 or d.shape[1] != e:
        raise ValueError(f"traffic matrix must be square, got {d.shape}")
    if n_devices <= 0 or e % n_devices:
        raise ValueError(f"{e} experts do not shard over {n_devices} devices")
    epd = e // n_devices
    agg = d.reshape(n_devices, epd, n_devices, epd).sum(axis=(1, 3))
    return strip_diagonal(agg)


def rounds_from_traffic(d: np.ndarray, n_ep: int):
    """BvN permutation rounds for an expert- or rank-granularity matrix."""
    d = np.asarray(d, dtype=np.float64)
    if d.shape[0] != n_ep:
        d = device_traffic(d, n_ep)
    sched = aurora_schedule(strip_diagonal(d))
    return aurora_rounds_from_schedule(sched, n_ep)


def rounds_from_plan(plan, n_ep: int):
    """Rank-granularity rounds from a planner ``Plan``: its per-layer
    ``CommSchedule``s' realised traffic (``CommSchedule.traffic``),
    averaged over layers (one round sequence serves every MoE layer) and
    re-scheduled at rank granularity."""
    mats = [s.traffic() for s in plan.schedules if s.slots]
    if not mats:
        return round_robin_rounds(n_ep)
    return rounds_from_traffic(np.mean(mats, axis=0), n_ep)


def rounds_from_trace(trace: MoETrace, n_ep: int):
    """Rank-granularity rounds from a (historical or live) ``MoETrace``."""
    return rounds_from_traffic(np.mean(trace.layers, axis=0), n_ep)


def resolve_rounds(source, n_ep: int):
    """Rounds from whatever traffic evidence the caller has: a ``Plan``
    (its schedules), a ``MoETrace``, or a raw square traffic matrix.

    Literal round sequences are NOT accepted: an (R, n) stack of dst
    vectors is indistinguishable from a traffic matrix when R == n.
    Callers holding literal rounds use ``swap_rounds`` or the ``rounds=``
    constructor argument, which validate a full cover.
    """
    if hasattr(source, "schedules"):
        return rounds_from_plan(source, n_ep)
    if isinstance(source, MoETrace):
        return rounds_from_trace(source, n_ep)
    arr = np.asarray(source)
    if arr.ndim == 2 and arr.dtype != object and arr.shape[0] == arr.shape[1]:
        return rounds_from_traffic(arr, n_ep)
    raise TypeError(
        "adopt()/resolve_rounds take traffic evidence — a Plan, a MoETrace, "
        f"or a square traffic matrix — got {type(source).__name__}; to "
        "install literal permutation rounds, call swap_rounds (or pass "
        "rounds=... at construction)")


# ---------------------------------------------------------------------------
# Model distribution
# ---------------------------------------------------------------------------

def ep_size(pc) -> int:
    """The EP rank count of a ``ParallelContext`` (1 without expert
    parallelism)."""
    return pc.group.n if pc is not None and pc.expert_parallel else 1


def distribute(model: Model, group, moe_impl: str = "aurora",
               overlap: bool = False) -> Model:
    """``model`` with an EP ``ParallelContext`` over ``group`` bound.

    Unlike ``make_pc``'s silent dense fallback, this *demands* expert
    parallelism: a config whose expert count does not divide the group is
    an error (the caller asked for a distributed MoE server)."""
    if model.cfg.moe is None:
        raise ValueError(f"{model.cfg.arch_id} has no MoE layers — "
                         "distributed EP serving needs experts to shard")
    if group.device != model.device:
        raise ValueError(f"the EP group runs on {group.device}, the model "
                         f"on {model.device}")
    pc = make_pc(model.cfg, group, moe_impl=moe_impl)
    if not pc.expert_parallel:
        raise ValueError(
            f"{model.cfg.moe.n_experts} experts do not shard over the "
            f"{group.n}-rank EP group: the expert count must be a multiple "
            "of the rank count")
    return dataclasses.replace(model,
                               pc=dataclasses.replace(pc, ep_overlap=overlap))


def _ctor_rounds(rounds, plan, n_ep: int):
    """Shared constructor logic of the three Distributed* engines: literal
    rounds win (validated as a full cover), else derive them from the
    plan's traffic evidence; None means round robin until adoption."""
    if rounds is None and plan is not None:
        return resolve_rounds(plan, n_ep)
    if rounds is not None:
        return validate_rounds_cover(rounds, n_ep)
    return None


def _with_rounds(model: Model, rounds) -> Model:
    return dataclasses.replace(
        model, pc=dataclasses.replace(model.pc, aurora_rounds=rounds))


def _require_aurora(pc) -> None:
    """Rounds only steer the "aurora" dispatch path; the monolithic
    all-to-all of "ep" never reads them."""
    if pc.moe_impl != "aurora":
        raise ValueError("rounds only exist on the 'aurora' dispatch path, "
                         f"this engine runs '{pc.moe_impl}'")


def _require_phys_divides(replication, n_ep: int) -> None:
    """A replication's physical expert count must shard over the ranks."""
    if replication is None:
        return
    n_phys = sum(len(h) if hasattr(h, "__len__") else int(h)
                 for h in replication)
    if n_phys % n_ep:
        raise PlanError(
            f"plan replicates to {n_phys} physical experts, which do not "
            f"shard over the {n_ep}-rank EP group — plan with "
            f"total_multiple={n_ep}")


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

class DistributedEngine(ContinuousEngine):
    """``ContinuousEngine`` whose MoE layers run expert-parallel over
    ``group``.

    ``moe_impl="aurora"`` (default) runs the scheduled permutation rounds
    (round robin until a plan is adopted); ``overlap=True`` pipelines the
    grouped expert FFN with in-flight rounds. ``adopt(plan)`` refreshes
    the rounds from a fresh plan, trace or traffic matrix mid-stream
    (placement-only: never changes a token).
    """

    def __init__(self, model: Model, params, batch_slots: int,
                 cache_cap: int, *, group, moe_impl: str = "aurora",
                 rounds=None, plan=None, overlap: bool = False,
                 config: EngineConfig | None = None, monitor=None):
        model = distribute(model, group, moe_impl=moe_impl, overlap=overlap)
        self.group = group
        self.n_ep = ep_size(model.pc)
        rounds = _ctor_rounds(rounds, plan, self.n_ep)
        if rounds is not None:
            model = _with_rounds(model, rounds)
        super().__init__(model, params, batch_slots, cache_cap,
                         config=config, monitor=monitor)

    @property
    def rounds(self):
        return self.model.pc.aurora_rounds

    def planner_devices(self, rank: int) -> list[int]:
        """The planner's devices rank ``rank`` stands for: its block of
        expert slots (the planner sees one device per expert)."""
        epd = self.model.cfg.moe.n_experts // self.n_ep
        return list(range(rank * epd, (rank + 1) * epd))

    def swap_rounds(self, rounds) -> None:
        """Swap the permutation rounds: placement-only, serving state
        (cache, slots, queue) is untouched and token streams are unchanged
        (the rounds decide WHEN buckets move, never what arrives)."""
        _require_aurora(self.model.pc)
        pc = dataclasses.replace(
            self.model.pc,
            aurora_rounds=validate_rounds_cover(rounds, self.n_ep))
        self._rebind(dataclasses.replace(self.model, pc=pc))
        record_adoption(self._telemetry, "rounds", step=self.decode_steps,
                        n_rounds=len(pc.aurora_rounds))

    def adopt(self, plan):
        """Refresh the rounds from a fresh ``Plan``, ``MoETrace`` or traffic
        matrix. A full ``Plan`` also carries placement: an exclusive plan
        whose only content is an expert->device assignment re-seats the
        expert leaves first, and its hot-expert replication (whose
        physical count must shard over the ranks) is adopted next; then
        the rounds swap, so one adoption moves placement AND schedule
        together, placement-only. Returns the adopted rounds."""
        if hasattr(plan, "schedules"):
            if (plan.pair is None and plan.groups is None
                    and plan.replication is None
                    and self.assignment is not None
                    and len(plan.expert_to_device) == len(self.assignment)):
                self.adopt_assignment(plan.expert_to_device)
            _require_phys_divides(plan.replication, self.n_ep)
            self.adopt_replication(plan.replication)
        rounds = resolve_rounds(plan, self.n_ep)
        self.swap_rounds(rounds)
        return rounds

    def adopt_degraded(self, plan) -> None:
        """Adopt a survivor-only degraded ``Plan`` (``AuroraPlanner
        .plan_degraded(ep_compatible=True)``): rebuild the EP group over
        the surviving ranks and carry the serving state across.

        ``plan.survivors`` are the planner's devices; rank r stands for
        ``planner_devices(r)``, so the surviving ranks are those hosting a
        survivor. The params drop back to the logical frame (no
        replication, the identity assignment) through the placement-only
        paths; the group is rebuilt (``dist.new_group(survivors)`` under a
        ``DistGroup``, a smaller ``LocalGroup`` in-process); the cache and
        the token buffer are kept as they are, bit for bit; the rounds come
        from the plan's degraded schedules and its replication counts are
        re-adopted. Requests resident on lost ranks must be ``requeue``d by
        the caller (``ChaosHarness`` does both, in order). A process whose
        rank did not survive leaves the group and gets ``FaultError``."""
        survivors = getattr(plan, "survivors", None)
        if survivors is None:
            raise PlanError(
                "adopt_degraded needs a degraded Plan (built by "
                "AuroraPlanner.plan_degraded) — this plan has no "
                ".survivors device list")
        n_e = self.model.cfg.moe.n_experts
        epd = n_e // self.n_ep
        surv = [int(s) for s in survivors]
        if any(not 0 <= s < n_e for s in surv):
            raise PlanError(f"plan survivors {surv} do not index the "
                            f"planner's {n_e} devices")
        ranks = sorted({s // epd for s in surv})
        if n_e % len(ranks):
            raise PlanError(
                f"{n_e} experts do not shard over the {len(ranks)} "
                f"surviving ranks {ranks} — plan with "
                "plan_degraded(ep_compatible=True)")
        if self.model.replication is not None:
            self.adopt_replication(None)
        if self.assignment != list(range(n_e)):
            self.adopt_assignment(list(range(n_e)))
        group = _survivor_group(self.group, ranks)
        model = distribute(dataclasses.replace(self.model, pc=None), group,
                           moe_impl=self.model.pc.moe_impl,
                           overlap=self.model.pc.ep_overlap)
        self.group = group
        self.n_ep = ep_size(model.pc)
        if model.pc.moe_impl == "aurora":
            model = _with_rounds(model, resolve_rounds(plan, self.n_ep))
        self._rebind(model)
        _require_phys_divides(plan.replication, self.n_ep)
        self.adopt_replication(plan.replication)
        record_adoption(self._telemetry, "degraded", step=self.decode_steps,
                        survivors=surv, ranks=ranks)


def _survivor_group(group, ranks):
    """The EP group over the surviving ``ranks`` of ``group``."""
    from ..distributed.group import DistGroup, LocalGroup
    if isinstance(group, LocalGroup):
        return LocalGroup(len(ranks), group.device)
    if isinstance(group, DistGroup):
        import torch.distributed as dist
        members = [group.members[r] for r in ranks]
        pg = dist.new_group(members)
        if group.rank not in ranks:
            raise FaultError(f"rank {group.rank} did not survive: it left "
                             f"the EP group (survivors {ranks})")
        return DistGroup(pg, group.device, members=members)
    raise TypeError(f"cannot rebuild a {type(group).__name__}")


class DistributedColocatedEngine(ColocatedContinuousEngine):
    """Aurora dual-model continuous serving, expert-parallel over ``group``.

    Both tenants' MoE layers dispatch over the same group in one lockstep
    step. With ``replan=OnlineReplanner(...)`` the engine closes the whole
    distributed loop: live routing counts -> monitors -> re-pairing, and
    every ADOPTED re-plan also refreshes the rounds from the plan's
    schedules (``refresh_rounds=False`` opts out; the swap is
    placement-only either way).
    """

    def __init__(self, model_a: Model, model_b: Model, params_a, params_b,
                 batch_slots: int, cache_cap: int, *, group,
                 moe_impl: str = "aurora", rounds=None, plan=None,
                 overlap: bool = False, refresh_rounds: bool = True,
                 config: EngineConfig | None = None, **kw):
        model_a = distribute(model_a, group, moe_impl=moe_impl,
                             overlap=overlap)
        model_b = distribute(model_b, group, moe_impl=moe_impl,
                             overlap=overlap)
        self.group = group
        self.n_ep = ep_size(model_a.pc)
        self.refresh_rounds = refresh_rounds
        rounds = _ctor_rounds(rounds, plan, self.n_ep)
        if rounds is not None:
            model_a, model_b = (_with_rounds(m, rounds)
                                for m in (model_a, model_b))
        if plan is not None and kw.get("pair") is None and plan.pair:
            kw["pair"] = list(plan.pair)
        super().__init__(model_a, model_b, params_a, params_b, batch_slots,
                         cache_cap, config=config, **kw)

    @property
    def rounds(self):
        return self.model_a.pc.aurora_rounds

    def swap_rounds(self, rounds) -> None:
        """Swap both tenants' rounds and rebuild the lockstep step:
        placement-only (see ``DistributedEngine``)."""
        _require_aurora(self.model_a.pc)
        rounds = validate_rounds_cover(rounds, self.n_ep)
        for pool in (self.pool_a, self.pool_b):
            pool._rebind(_with_rounds(pool.model, rounds))
        self.model_a, self.model_b = self.pool_a.model, self.pool_b.model
        self._build_lockstep()
        record_adoption(self._telemetry, "rounds", step=self.decode_steps,
                        n_rounds=len(rounds))

    def adopt(self, source):
        """One adoption surface for placement AND schedule: a full ``Plan``
        re-seats its pairing on pool B (placement-only) and then refreshes
        the rounds from its schedules; a ``MoETrace`` or traffic matrix
        refreshes the rounds only. Returns the adopted rounds."""
        if hasattr(source, "schedules") and source.pair:
            ColocatedContinuousEngine.adopt(self, source)
        rounds = resolve_rounds(source, self.n_ep)
        self.swap_rounds(rounds)
        return rounds

    def _adopt_online(self, plan) -> None:
        ColocatedContinuousEngine.adopt(self, plan)
        if self.refresh_rounds and self.model_a.pc.moe_impl == "aurora":
            # The plan was computed from the LIVE traces, so its schedules
            # reflect current traffic under the new pairing.
            self.swap_rounds(resolve_rounds(plan, self.n_ep))


class DistributedMultiTenantEngine(MultiTenantContinuousEngine):
    """N-tenant colocated continuous serving, expert-parallel over
    ``group``, with the rounds refreshed on every adopted re-grouping (the
    N-way counterpart of ``DistributedColocatedEngine``)."""

    def __init__(self, models: list[Model], params: list, batch_slots: int,
                 cache_cap: int, *, group, moe_impl: str = "aurora",
                 rounds=None, plan=None, overlap: bool = False,
                 refresh_rounds: bool = True,
                 config: EngineConfig | None = None, **kw):
        models = [distribute(m, group, moe_impl=moe_impl, overlap=overlap)
                  for m in models]
        self.group = group
        self.n_ep = ep_size(models[0].pc)
        self.refresh_rounds = refresh_rounds
        rounds = _ctor_rounds(rounds, plan, self.n_ep)
        if rounds is not None:
            models = [_with_rounds(m, rounds) for m in models]
        if plan is not None and kw.get("groups") is None and plan.groups:
            kw["groups"] = [tuple(g) for g in plan.groups]
        super().__init__(models, params, batch_slots, cache_cap,
                         config=config, **kw)

    @property
    def rounds(self):
        return self.models[0].pc.aurora_rounds

    def swap_rounds(self, rounds) -> None:
        _require_aurora(self.models[0].pc)
        rounds = validate_rounds_cover(rounds, self.n_ep)
        for pool in self.pools:
            pool._rebind(_with_rounds(pool.model, rounds))
        self.models = [p.model for p in self.pools]
        self._build_lockstep()
        record_adoption(self._telemetry, "rounds", step=self.decode_steps,
                        n_rounds=len(rounds))

    def adopt(self, source):
        """One adoption surface: a full ``Plan`` re-seats every tenant to
        its grouping (placement-only) and refreshes the rounds; a
        ``MoETrace`` or traffic matrix refreshes the rounds only. Returns
        the adopted rounds."""
        if hasattr(source, "schedules") and source.groups:
            MultiTenantContinuousEngine.adopt(self, source)
        rounds = resolve_rounds(source, self.n_ep)
        self.swap_rounds(rounds)
        return rounds

    def _adopt_online(self, plan) -> None:
        MultiTenantContinuousEngine.adopt(self, plan)
        if self.refresh_rounds and self.models[0].pc.moe_impl == "aurora":
            self.swap_rounds(resolve_rounds(plan, self.n_ep))
