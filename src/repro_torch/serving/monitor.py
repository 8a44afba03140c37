"""Live traffic monitoring and online re-planning (port of
``repro/serving/monitor.py``).

The planner's placements (pairing, grouping, expert->device assignment)
are computed from traffic traces; the continuous engines observe every
request's live routing. ``TrafficMonitor`` folds the per-step routing
counts of ``Model.decode_step_stats`` / ``prefill(collect_moe_stats=True)``
into an exponentially weighted per-layer expert-popularity estimate and
turns it into a ``MoETrace`` on demand. ``OnlineReplanner`` periodically
re-runs ``AuroraPlanner`` on that live trace and recommends a new placement
when it beats the current one, re-simulated on the SAME live trace, by a
margin.

Re-planning is placement-only: a new pairing permutes a model's expert
weights and router columns together (``colocated.reseat_pairing``), never
the function it computes, so a mid-stream re-plan cannot change emitted
tokens.

``OnlineReplanner.maybe_replicate`` picks a hot-expert replication from the
live (or, with ``predictive=True``, the forecast) trace; an engine adopts
it with ``adopt``, placement-only as well. With a telemetry hub attached,
every decision point is counted and published on its bus.

Pure numpy: the engines copy the counts to the host before ``observe``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.planner import AuroraPlanner, Plan, PlanDiff
from ..core.traffic import (MoETrace, identity_replication,
                            trace_from_counts)
from .events import RingBuffer


class TrafficMonitor:
    """EWMA accumulator of per-layer expert routing counts.

    ``observe`` takes the (n_layers, B, E) count arrays of the stats model
    methods, masks out inactive slots, and folds the per-step totals into a
    decayed sum with a matching decayed weight (bias-corrected EWMA:
    ``rates = counts / weight`` is a tokens-per-observation estimate from
    the first step on). ``halflife`` is measured in observations.
    """

    def __init__(self, n_experts: int, n_layers: int,
                 halflife: float = 128.0, name: str = "live"):
        if n_layers <= 0:
            raise ValueError("TrafficMonitor needs a model with MoE layers")
        self.n_experts = n_experts
        self.n_layers = n_layers
        self.name = name
        self.decay = 0.5 ** (1.0 / float(halflife))
        self.counts = np.zeros((n_layers, n_experts), np.float64)
        self.weight = 0.0
        # Predictive side-channels (``predicted_rates``): a faster EWMA
        # (halflife/4) that reacts to drift sooner than the planning EWMA,
        # and per-layer-pair router affinities (EWMA of the co-routing mass
        # between layer l's experts and layer l+1's, at the slow decay).
        self.decay_fast = 0.5 ** (4.0 / float(halflife))
        self.fast_counts = np.zeros((n_layers, n_experts), np.float64)
        self.fast_weight = 0.0
        self.affinity = np.zeros((max(n_layers - 1, 0), n_experts, n_experts),
                                 np.float64)
        self.observations = 0
        self.slot_to_expert = None

    @property
    def slot_to_expert(self) -> list[int] | None:
        """Expert-index frame: the stats of a model whose experts were
        permuted (``apply_pairing``) arrive in SLOT space, column k being
        original expert ``slot_to_expert[k]``. Every observation is
        translated back to original-expert space, so the EWMA stays in one
        frame across re-plans. None = identity (unpermuted model)."""
        return self._slot_to_expert

    @slot_to_expert.setter
    def slot_to_expert(self, value) -> None:
        # A wrong-length or non-permutation map would misindex silently.
        if value is None:
            self._slot_to_expert = None
            return
        perm = [int(v) for v in value]
        if sorted(perm) != list(range(self.n_experts)):
            raise ValueError(
                f"slot_to_expert must be a permutation of "
                f"range({self.n_experts}) — the monitor's stats frame is "
                f"(n_layers={self.n_layers}, B, E={self.n_experts}) — "
                f"got {value!r}")
        self._slot_to_expert = perm

    def observe(self, stats, mask=None) -> None:
        """stats: (n_layers, B, E) routed-choice counts of one engine step
        (host array); mask: (B,) truthy for rows that hold a real request
        (None = all)."""
        arr = np.asarray(stats, np.float64)
        if arr.shape[0] != self.n_layers or arr.shape[-1] != self.n_experts:
            raise ValueError(f"stats shape {arr.shape} does not match "
                             f"({self.n_layers}, B, {self.n_experts})")
        if mask is not None:
            arr = arr * np.asarray(mask, np.float64)[None, :, None]
        if self.slot_to_expert is not None:
            orig = np.empty_like(arr)
            orig[..., np.asarray(self.slot_to_expert)] = arr
            arr = orig
        totals = arr.sum(axis=1)
        self.counts = self.decay * self.counts + totals
        self.weight = self.decay * self.weight + 1.0
        self.fast_counts = self.decay_fast * self.fast_counts + totals
        self.fast_weight = self.decay_fast * self.fast_weight + 1.0
        if self.n_layers > 1:
            # Per-slot co-occurrence: which layer-(l+1) experts fire for the
            # batch rows feeding each layer-l expert.
            self.affinity = (self.decay * self.affinity
                             + np.einsum("lbe,lbf->lef", arr[:-1], arr[1:]))
        self.observations += 1

    @property
    def rates(self) -> np.ndarray:
        """(n_layers, E) EWMA routed tokens per observation."""
        return self.counts / max(self.weight, 1e-12)

    @property
    def fast_rates(self) -> np.ndarray:
        """(n_layers, E) fast-EWMA (halflife/4) rates, drift-sensitive."""
        return self.fast_counts / max(self.fast_weight, 1e-12)

    def predicted_rates(self) -> np.ndarray:
        """(n_layers, E) next-layer router prediction.

        Layer 0 takes the fast EWMA; every deeper layer pushes the fast
        estimate of the layer above through the learned row-normalised
        affinity matrix, rescaled to its own observed mass. Layers whose
        affinity rows carry no mass yet fall back to their fast estimate."""
        fast = self.fast_rates
        out = np.empty_like(fast)
        out[0] = fast[0]
        for layer in range(1, self.n_layers):
            aff = self.affinity[layer - 1]
            row = aff.sum(axis=1, keepdims=True)
            trans = np.divide(aff, row, out=np.zeros_like(aff),
                              where=row > 1e-12)
            pred = fast[layer - 1] @ trans
            total, target = pred.sum(), fast[layer].sum()
            if total <= 1e-12 or target <= 1e-12:
                out[layer] = fast[layer]
            else:
                out[layer] = pred * (target / total)
        return out

    def trace(self, tokens_per_device: float = 1024.0, **times) -> MoETrace:
        """Live ``MoETrace`` from the current popularity estimate. ``times``
        forwards gate/ffn_per_token/agg/ffn_fixed to ``trace_from_counts``."""
        return trace_from_counts(self.name, self.rates,
                                 tokens_per_device=tokens_per_device, **times)

    def predicted_trace(self, tokens_per_device: float = 1024.0,
                        **times) -> MoETrace:
        """``trace`` built from ``predicted_rates``."""
        return trace_from_counts(self.name + "+pred", self.predicted_rates(),
                                 tokens_per_device=tokens_per_device, **times)


@dataclasses.dataclass
class ReplanEvent:
    """One re-plan decision point (kept on ``OnlineReplanner.events``)."""

    step: int
    stale_time: float          # current placement re-simulated on live trace
    candidate_time: float      # fresh plan's prediction on the same trace
    pair: list[int]            # candidate pairing (2-tenant view)
    applied: bool
    baseline_time: float | None = None   # frozen baseline on same trace
    # Re-grouping events carry the candidate grouping (groups[g][t] =
    # tenant-t expert on slot g); None for pair events.
    groups: list[tuple[int, ...]] | None = None
    # Replication events carry the candidate host map (replication[e] =
    # devices hosting expert e, home first).
    replication: tuple[tuple[int, ...], ...] | None = None
    # Re-assignment events carry the candidate expert->device map.
    assignment: tuple[int, ...] | None = None


class OnlineReplanner:
    """Traffic-driven re-planning policy for the continuous engines.

    Every ``interval`` decode steps (once every monitor has at least
    ``warmup`` observations), plan fresh from the live traces and compare
    against the CURRENT placement evaluated on the same traces. Recommend
    the switch only when the placement changes and the predicted inference
    time improves by more than ``threshold`` (relative): hysteresis against
    churn on noisy traffic. ``baseline_pair``/``baseline_groups``/
    ``baseline_assignment``/``baseline_replication`` are frozen reference
    placements scored on the live trace at every checkpoint.
    ``predictive=True`` makes ``maybe_replicate`` plan on the monitor's
    forecast (``TrafficMonitor.predicted_trace``) instead of the slow EWMA.
    ``events`` keeps the newest ``event_capacity`` decision points
    (drop-oldest); ``telemetry`` (a ``serving.Telemetry``, wired by the
    engines from their config) also counts and publishes each one.
    """

    def __init__(self, planner: AuroraPlanner, interval: int = 64,
                 threshold: float = 0.02, warmup: int | None = None,
                 tokens_per_device: float = 1024.0,
                 baseline_pair: list[int] | None = None,
                 baseline_groups: list[tuple[int, ...]] | None = None,
                 predictive: bool = False,
                 baseline_replication=None,
                 baseline_assignment=None,
                 telemetry=None,
                 event_capacity: int = 4096):
        if interval <= 0:
            raise ValueError("interval must be positive")
        self.planner = planner
        self.interval = interval
        self.threshold = threshold
        self.warmup = interval if warmup is None else warmup
        self.tokens_per_device = tokens_per_device
        self.baseline_pair = (None if baseline_pair is None
                              else list(baseline_pair))
        self.baseline_groups = (None if baseline_groups is None
                                else [tuple(g) for g in baseline_groups])
        self.predictive = predictive
        self.baseline_replication = (
            None if baseline_replication is None
            else tuple(tuple(h) for h in baseline_replication))
        self.baseline_assignment = (
            None if baseline_assignment is None
            else [int(d) for d in baseline_assignment])
        self.events: RingBuffer = RingBuffer(event_capacity)
        self.telemetry = telemetry

    def _record(self, ev: ReplanEvent) -> None:
        self.events.append(ev)
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.count("serving_replans_total",
                      help="re-plan checkpoints by outcome",
                      applied=ev.applied)
            tel.publish("replan", ev, step=ev.step)

    def _due(self, step: int, monitors) -> bool:
        return (step != 0 and step % self.interval == 0
                and min(m.observations for m in monitors) >= self.warmup)

    def _traces(self, monitors) -> list[MoETrace]:
        return [m.trace(tokens_per_device=self.tokens_per_device)
                for m in monitors]

    def maybe_replan(self, step: int, monitor_a: TrafficMonitor,
                     monitor_b: TrafficMonitor,
                     current_pair: list[int]) -> Plan | None:
        """The new colocation plan to apply, or None to keep the current
        pairing."""
        if not self._due(step, (monitor_a, monitor_b)):
            return None
        tr_a, tr_b = self._traces((monitor_a, monitor_b))
        stale = self.planner.evaluate_colocated(tr_a, tr_b, current_pair)
        cand = self.planner.plan_colocated(tr_a, tr_b)
        diff = PlanDiff(
            pair_changed=list(cand.pair) != list(current_pair),
            assignment_changed=False,     # homogeneous pairing re-plan only
            old_time=stale.inference_time,
            new_time=cand.predicted.inference_time)
        apply = diff.pair_changed and diff.rel_improvement > self.threshold
        base_t = None
        if self.baseline_pair is not None:
            base_t = self.planner.evaluate_colocated(
                tr_a, tr_b, self.baseline_pair).inference_time
        self._record(ReplanEvent(
            step=step, stale_time=stale.inference_time,
            candidate_time=cand.predicted.inference_time,
            pair=list(cand.pair), applied=apply, baseline_time=base_t))
        return cand if apply else None

    def maybe_reassign(self, step: int, monitor: TrafficMonitor,
                       current_assignment) -> Plan | None:
        """Exclusive-deployment re-ASSIGNMENT (scenario 2): re-run Thm 5.1
        on the live trace against the CURRENT expert->device map evaluated
        on the same trace. On homogeneous clusters ``plan_exclusive``
        returns the identity, so this only fires on heterogeneous ones."""
        if not self._due(step, (monitor,)):
            return None
        tr, = self._traces((monitor,))
        cur = [int(d) for d in current_assignment]
        stale = self.planner.evaluate_exclusive(tr, cur)
        cand = self.planner.plan_exclusive(tr)
        cand_e2d = [int(d) for d in cand.expert_to_device]
        diff = PlanDiff(
            pair_changed=False,
            assignment_changed=cand_e2d != cur,
            old_time=stale.inference_time,
            new_time=cand.predicted.inference_time)
        apply = (diff.assignment_changed
                 and diff.rel_improvement > self.threshold)
        base_t = None
        if self.baseline_assignment is not None:
            base_t = self.planner.evaluate_exclusive(
                tr, self.baseline_assignment).inference_time
        self._record(ReplanEvent(
            step=step, stale_time=stale.inference_time,
            candidate_time=cand.predicted.inference_time,
            pair=[], applied=apply, baseline_time=base_t,
            assignment=tuple(cand_e2d)))
        return cand if apply else None

    def maybe_regroup(self, step: int, monitors: list[TrafficMonitor],
                      current_groups: list[tuple[int, ...]]) -> Plan | None:
        """N-tenant ``maybe_replan``: a fresh k-way grouping from the N live
        traces against the CURRENT grouping evaluated on the same traces."""
        if not self._due(step, monitors):
            return None
        traces = self._traces(monitors)
        cur = [tuple(g) for g in current_groups]
        stale = self.planner.evaluate_multi(traces, cur)
        cand = self.planner.plan_multi(traces)
        cand_groups = [tuple(g) for g in cand.groups]
        n = len(cand_groups)
        s2d = np.asarray(cand.expert_to_device)
        if not np.array_equal(s2d, np.arange(n)):
            # Heterogeneous plan: group k belongs on device s2d[k]. The
            # engine's slots are devices (identity frame), so realise the
            # matching as a row permutation (the group matched to device d
            # moves to slot d) and hand over an identity-assignment plan;
            # every tenant's column stays a permutation.
            inv = np.empty(n, dtype=int)
            inv[s2d] = np.arange(n)
            cand_groups = [cand_groups[int(inv[d])] for d in range(n)]
            cand = dataclasses.replace(
                cand, expert_to_device=np.arange(n),
                groups=tuple(cand_groups),
                pair=([g[1] for g in cand_groups]
                      if cand.pair is not None else None))
        # Score the candidate as the engine will realise it: identity
        # slot->device over the (possibly re-matched) groups.
        cand_time = self.planner.evaluate_multi(
            traces, cand_groups).inference_time
        diff = PlanDiff(
            pair_changed=cand_groups != cur,
            assignment_changed=False,     # placement-only re-grouping
            old_time=stale.inference_time,
            new_time=cand_time)
        apply = diff.pair_changed and diff.rel_improvement > self.threshold
        base_t = None
        if self.baseline_groups is not None:
            base_t = self.planner.evaluate_multi(
                traces, self.baseline_groups).inference_time
        self._record(ReplanEvent(
            step=step, stale_time=stale.inference_time,
            candidate_time=cand_time,
            pair=list(cand.pair) if cand.pair is not None else [],
            applied=apply, baseline_time=base_t, groups=cand_groups))
        return cand if apply else None

    def maybe_replicate(self, step: int, monitor: TrafficMonitor,
                        current_replication=None, *,
                        tolerance: float = 0.1,
                        max_total_replicas: int | None = None,
                        total_multiple: int | None = None) -> Plan | None:
        """Exclusive-deployment re-replication: a fresh hot-expert
        replication from the live (or, if ``self.predictive``, forecast)
        trace against the CURRENT host map (``Plan.replication`` tuples;
        None = no replicas) scored on the same trace. The plan to adopt, or
        None to keep. ``total_multiple`` forwards to the planner (a
        physical expert count divisible by an EP device count)."""
        if not self._due(step, (monitor,)):
            return None
        kw = dict(tokens_per_device=self.tokens_per_device)
        tr = (monitor.predicted_trace(**kw) if self.predictive
              else monitor.trace(**kw))
        cur = (identity_replication(monitor.n_experts)
               if current_replication is None
               else tuple(tuple(h) for h in current_replication))
        stale = self.planner.evaluate_replicated(tr, cur)
        cand = self.planner.plan_replicated(
            tr, tolerance=tolerance, max_total_replicas=max_total_replicas,
            total_multiple=total_multiple)
        changed = cand.replication != cur
        diff = PlanDiff(
            pair_changed=changed,
            assignment_changed=False,     # placement-only replication
            old_time=stale.inference_time,
            new_time=cand.predicted.inference_time)
        apply = changed and diff.rel_improvement > self.threshold
        base_t = None
        if self.baseline_replication is not None:
            base_t = self.planner.evaluate_replicated(
                tr, self.baseline_replication).inference_time
        self._record(ReplanEvent(
            step=step, stale_time=stale.inference_time,
            candidate_time=cand.predicted.inference_time,
            pair=[], applied=apply, baseline_time=base_t,
            replication=cand.replication))
        return cand if apply else None
