"""AuroraPlanner: the four-scenario dispatcher (Fig 2).

Given historical model statistics (traces) and a cluster description, produce
a deployment + scheduling plan:

  scenario 1  Exclusive  + Homogeneous   → transmission schedule (Thm 4.2)
  scenario 2  Exclusive  + Heterogeneous → GPU assignment (Thm 5.1) + schedule
  scenario 3  Colocating + Homogeneous   → expert pairing (Thm 6.2 / bottleneck
                                           matching) + schedule
  scenario 4  Colocating + Heterogeneous → decoupled 3D matching (§7.2):
                                           pairing then pair→GPU matching

The plan carries everything the runtime needs: per-layer CommSchedules (BvN
permutation rounds for the ppermute lowering), the expert→device map, and the
predicted inference time from the Table-2 simulator.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .assignment import aurora_assignment, expert_loads
from .cluster import Cluster
from .colocation import (aurora_grouping, aurora_pairing, aggregate_traffic,
                         aggregate_traffic_multi, case2_pairing, group_pairs)
from .errors import FaultError
from .matching import bottleneck_perfect_matching
from .schedule import CommSchedule, aurora_schedule
from .simulator import (SimResult, colocated_inference_time,
                        degraded_inference_time, exclusive_inference_time,
                        multi_colocated_inference_time,
                        replicated_inference_time)
from .traffic import (MoETrace, degraded_traffic, identity_replication,
                      replicated_ffn_loads, replicated_traffic,
                      validate_degraded_hosts, validate_replication)
from .assignment import apply_assignment


@dataclasses.dataclass(frozen=True)
class Plan:
    scenario: str
    expert_to_device: np.ndarray              # model a (or the only model)
    pair: list[int] | None                    # b-expert colocated per slot
    schedules: tuple[CommSchedule, ...]       # per layer, dispatch phase
    predicted: SimResult
    # N-tenant plans (scenario "multi+..."): groups[g][t] = tenant-t expert
    # on slot g, tenant 0 the identity anchor. For two tenants this carries
    # the same information as ``pair`` (groups[g] == (g, pair[g])).
    groups: tuple[tuple[int, ...], ...] | None = None
    # Replicated plans (scenario "...+replicated"): replication[e] lists the
    # devices hosting a copy of expert e, HOME device first. Tokens split
    # evenly across copies (the shard-of-token rule), so this is pure
    # deployment data — the routed function never changes. None = no
    # replication (every expert only on its home device).
    replication: tuple[tuple[int, ...], ...] | None = None
    # Degraded plans (scenario "degraded+..."): survivors[j] is the ORIGINAL
    # cluster index of survivor j — every other per-device field of this
    # plan (expert_to_device, replication hosts, schedules) is expressed in
    # the 0..len(survivors)-1 survivor frame, and replication hosts need not
    # start with the expert's own index (the expert↔device bijection died
    # with the failed devices). None = healthy plan in the original frame.
    survivors: tuple[int, ...] | None = None

    @property
    def replication_counts(self) -> tuple[int, ...] | None:
        """Per-expert replication factor (len of each host tuple)."""
        if self.replication is None:
            return None
        return tuple(len(h) for h in self.replication)

    @property
    def n_layers(self) -> int:
        return len(self.schedules)

    @property
    def n_tenants(self) -> int:
        if self.groups is not None:
            return len(self.groups[0])
        return 2 if self.pair is not None else 1


@dataclasses.dataclass(frozen=True)
class PlanDiff:
    """What changed between two plans, and how much it is predicted to buy.

    ``rel_improvement`` > 0 means the new plan is predicted faster. For an
    apples-to-apples online decision, re-evaluate the OLD plan's placement on
    the live trace first (``AuroraPlanner.evaluate_colocated``) — the stale
    plan's stored prediction was computed against the historical trace it
    was planned from, not against current traffic.
    """

    pair_changed: bool
    assignment_changed: bool
    old_time: float
    new_time: float

    @property
    def placement_changed(self) -> bool:
        return self.pair_changed or self.assignment_changed

    @property
    def rel_improvement(self) -> float:
        if self.old_time <= 0.0:
            return 0.0
        return (self.old_time - self.new_time) / self.old_time


def diff_plans(old: Plan, new: Plan,
               old_time: float | None = None) -> PlanDiff:
    """Compare two plans' placements and predicted inference times.

    ``old_time`` overrides the stale plan's stored prediction — pass the old
    placement re-simulated on the live trace when diffing for re-planning.
    """
    pair_changed = (old.pair is None) != (new.pair is None) or (
        old.pair is not None and list(old.pair) != list(new.pair))
    assignment_changed = not np.array_equal(
        np.asarray(old.expert_to_device), np.asarray(new.expert_to_device))
    return PlanDiff(
        pair_changed=pair_changed,
        assignment_changed=assignment_changed,
        old_time=float(old.predicted.inference_time
                       if old_time is None else old_time),
        new_time=float(new.predicted.inference_time),
    )


def _mean_sim(sims: list[SimResult]) -> SimResult:
    """Whole-model prediction: per-layer simulations averaged."""
    return SimResult(
        float(np.mean([s.inference_time for s in sims])),
        float(np.mean([s.utilization for s in sims])),
        {"per_layer": [s.inference_time for s in sims]},
    )


class AuroraPlanner:
    """Plans deployment + communication scheduling per the paper's four cases."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        cluster.validate()

    # -- scenarios 1 & 2 ----------------------------------------------------
    def plan_exclusive(self, trace: MoETrace) -> Plan:
        cl = self.cluster
        n = trace.n
        if cl.homogeneous:
            scenario = "exclusive+homogeneous"
            e2d = np.arange(n)  # observation 1: assignment is irrelevant
        else:
            scenario = "exclusive+heterogeneous"
            # Thm 5.1 on aggregate load across layers (the deployment is one
            # decision for the whole model; per-layer loads are averaged).
            mean_d = np.mean([trace.layer(l) for l in range(len(trace.layers))],
                             axis=0)
            e2d = aurora_assignment(mean_d, cl)
        bw = np.asarray(cl.bandwidths, float)
        schedules = tuple(
            aurora_schedule(apply_assignment(trace.layer(l), e2d), bw)
            for l in range(len(trace.layers))
        )
        pred = _mean_sim([
            exclusive_inference_time(trace, l, cl, e2d, policy="aurora")
            for l in range(len(trace.layers))
        ])
        return Plan(scenario, e2d, None, schedules, pred)

    # -- scenarios 3 & 4 ----------------------------------------------------
    def plan_colocated(self, trace_a: MoETrace, trace_b: MoETrace) -> Plan:
        cl = self.cluster
        n = trace_a.n
        mean_a = np.mean([trace_a.layer(l) for l in range(len(trace_a.layers))],
                         axis=0)
        mean_b = np.mean([trace_b.layer(l) for l in range(len(trace_b.layers))],
                         axis=0)
        if cl.homogeneous:
            scenario = "colocating+homogeneous"
            pair = aurora_pairing(mean_a, mean_b)
            s2d = np.arange(n)
        else:
            scenario = "colocating+heterogeneous"
            # §7.2 decoupling. Step 1: expert↔expert bottleneck matching.
            pair, _ = case2_pairing(mean_a, mean_b)
            # Step 2: pair↔device bottleneck matching; the edge weight is the
            # pair's inference-time contribution on that device: compute
            # (gate+agg+ffn of both experts) scaled by 1/compute plus its
            # send/recv bottleneck scaled by 1/bandwidth.
            d_agg = aggregate_traffic(mean_a, mean_b, pair)
            send = d_agg.sum(axis=1)
            recv = d_agg.sum(axis=0)
            loads_a = expert_loads(mean_a)
            loads_b = expert_loads(mean_b)[np.asarray(pair)]
            comp_fixed = (trace_a.gate + trace_a.agg + trace_b.gate + trace_b.agg)
            comp_tok = (trace_a.ffn_per_token * loads_a
                        + trace_b.ffn_per_token * loads_b)
            w = np.empty((n, n))
            for k in range(n):
                for dev in range(n):
                    dt = cl.devices[dev]
                    w[k, dev] = ((comp_fixed + comp_tok[k]) / dt.compute
                                 + max(send[k], recv[k]) / dt.bandwidth)
            match, _ = bottleneck_perfect_matching(w)
            s2d = np.asarray(match)
        bw = np.asarray(cl.bandwidths, float)
        schedules = tuple(
            aurora_schedule(
                apply_assignment(
                    aggregate_traffic(trace_a.layer(l), trace_b.layer(l), pair),
                    s2d),
                bw)
            for l in range(len(trace_a.layers))
        )
        pred = self.evaluate_colocated(trace_a, trace_b, pair,
                                       None if cl.homogeneous else s2d)
        return Plan(scenario, np.arange(n) if cl.homogeneous else s2d,
                    pair, schedules, pred)

    # -- expert replication (exclusive + hot-expert copies) ------------------
    def plan_replicated(self, trace: MoETrace, tolerance: float = 0.1,
                        max_total_replicas: int | None = None,
                        total_multiple: int | None = None) -> Plan:
        """Exclusive deployment with the hottest experts replicated.

        Greedy: while the hottest device's FFN load exceeds the mean by more
        than ``tolerance`` (relative), copy the expert with the largest
        per-replica token share onto the least-loaded device not already
        hosting it — each copy halves (r→r+1) that expert's per-device
        share under the shard-of-token rule. Stops when balanced, when no
        copy improves the bottleneck, or after ``max_total_replicas`` extra
        copies (default: one per device). ``total_multiple`` then pads the
        total physical expert count up to a multiple (EP sharding needs the
        physical axis divisible by the device count) with the best legal
        copies even when already balanced.

        Replication is placement-only: replicas are pure weight copies and
        routing stays in the logical expert frame, so the plan changes WHERE
        routed tokens are computed, never which tokens are routed where.
        """
        cl = self.cluster
        n = trace.n
        if cl.n != n:
            raise ValueError("one home device per expert required")
        if not cl.homogeneous:
            raise ValueError("plan_replicated supports homogeneous clusters")
        mean_d = np.mean([trace.layer(l) for l in range(len(trace.layers))],
                         axis=0)
        col = mean_d.sum(axis=0)
        replicas = [[e] for e in range(n)]
        budget = n if max_total_replicas is None else int(max_total_replicas)

        def best_copy(loads):
            """(expert, host) whose copy most lowers the peak load, or None."""
            share = np.array([col[e] / len(replicas[e]) for e in range(n)])
            best = None
            for e in np.argsort(-share):
                hosts = [d for d in np.argsort(loads)
                         if d not in replicas[e]]
                if not hosts:
                    continue
                host = int(hosts[0])
                new_share = col[e] / (len(replicas[e]) + 1)
                peak = max(float(loads[host] + new_share),
                           *(float(loads[d] - share[e] + new_share)
                             for d in replicas[e]),
                           *(float(loads[d]) for d in range(n)
                             if d != host and d not in replicas[e]))
                if best is None or peak < best[0]:
                    best = (peak, int(e), host)
            return best

        extra = 0
        while extra < budget:
            loads = replicated_ffn_loads(mean_d, replicas)
            if loads.max() <= (1.0 + tolerance) * loads.mean():
                break
            cand = best_copy(loads)
            if cand is None or cand[0] >= loads.max() - 1e-12:
                break                       # no copy improves the bottleneck
            _, e, host = cand
            replicas[e].append(host)
            extra += 1
        if total_multiple is not None and total_multiple > 0:
            while sum(len(r) for r in replicas) % total_multiple:
                cand = best_copy(replicated_ffn_loads(mean_d, replicas))
                if cand is None:
                    raise ValueError(
                        f"cannot pad replication to a multiple of "
                        f"{total_multiple}: every expert is everywhere")
                _, e, host = cand
                replicas[e].append(host)

        rep = validate_replication([tuple(r) for r in replicas], n)
        bw = np.asarray(cl.bandwidths, float)
        schedules = tuple(
            aurora_schedule(replicated_traffic(trace.layer(l), rep), bw)
            for l in range(len(trace.layers)))
        pred = self.evaluate_replicated(trace, rep)
        return Plan("exclusive+homogeneous+replicated", np.arange(n), None,
                    schedules, pred, replication=rep)

    # -- degraded re-planning (fail-stop device loss) ------------------------
    def plan_degraded(self, trace: MoETrace, failed_devices,
                      replication=None, ep_compatible: bool = False,
                      total_multiple: int | None = None) -> Plan:
        """Survivor-only plan after fail-stop device loss.

        ``failed_devices`` are original cluster indices now gone. Failover
        is two-tier: experts with a surviving replica (``replication`` is
        the healthy plan's host map, identity when None) keep their
        surviving copies — lossless, only the shard-of-token split widens
        back to fewer copies — while experts whose every host died are
        re-homed greedily onto the least-loaded survivor (load measured in
        FFN time, so slow devices attract less on heterogeneous clusters).
        Schedules and the predicted time come from the survivor-frame
        traffic (``degraded_traffic`` / ``degraded_inference_time``).

        ``ep_compatible=True`` restricts the plan to the fastest survivor
        subset whose size divides the expert count (EP sharding needs
        experts-per-device integral) and pads total replica count to a
        multiple of it, so distributed engines can adopt the plan on a
        shrunken mesh. ``total_multiple`` overrides the padding multiple.

        Raises ``FaultError`` when no device survives, when a failed index
        is out of range, or when padding is impossible.
        """
        cl = self.cluster
        n = trace.n
        if cl.n != n:
            raise FaultError(
                f"plan_degraded plans from the healthy one-device-per-expert "
                f"frame: cluster has {cl.n} devices for {n} experts")
        failed = sorted({int(d) for d in failed_devices})
        for d in failed:
            if not 0 <= d < n:
                raise FaultError(f"failed device {d} out of range({n})")
        alive = [d for d in range(n) if d not in failed]
        if not alive:
            raise FaultError("no surviving devices to re-plan onto")
        if ep_compatible:
            k = max(s for s in range(1, len(alive) + 1) if n % s == 0)
            order = [d for d in cl.sorted_indices_by_performance()
                     if d in alive]
            chosen = sorted(order[:k])
        else:
            chosen = alive
        k = len(chosen)
        surv = cl.subcluster(chosen)
        pos = {d: j for j, d in enumerate(chosen)}

        rep = (identity_replication(n) if replication is None
               else validate_replication(replication, n))
        mean_d = np.mean([trace.layer(l) for l in range(len(trace.layers))],
                         axis=0)
        col = mean_d.sum(axis=0)
        comp = np.asarray(surv.computes, float)

        hosts: list[list[int]] = [
            [pos[d] for d in rep[e] if d in pos] for e in range(n)]
        loads = np.zeros(k)
        for e in range(n):
            if hosts[e]:
                for h in hosts[e]:
                    loads[h] += col[e] / len(hosts[e])
        # Re-home orphaned experts, hottest first, onto the least-loaded
        # survivor (in time units — heterogeneous survivors differ).
        orphans = [e for e in range(n) if not hosts[e]]
        for e in sorted(orphans, key=lambda e: -col[e]):
            h = int(np.argmin(loads / comp))
            hosts[e] = [h]
            loads[h] += col[e]

        multiple = total_multiple if total_multiple is not None else (
            k if ep_compatible else None)
        if multiple:
            while sum(len(h) for h in hosts) % multiple:
                cand = None
                for e in np.argsort(-col / [len(h) for h in hosts]):
                    free = [j for j in np.argsort(loads / comp)
                            if j not in hosts[e]]
                    if free:
                        cand = (int(e), int(free[0]))
                        break
                if cand is None:
                    raise FaultError(
                        f"cannot pad degraded replication to a multiple of "
                        f"{multiple}: every expert is on every survivor")
                e, h = cand
                share_old = col[e] / len(hosts[e])
                for j in hosts[e]:
                    loads[j] -= share_old
                hosts[e].append(h)
                share_new = col[e] / len(hosts[e])
                for j in hosts[e]:
                    loads[j] += share_new

        host_map = validate_degraded_hosts([tuple(h) for h in hosts], n, k)
        # Failed devices' token streams land round-robin on survivors.
        sources = [pos[i] if i in pos else pos[chosen[i % k]]
                   for i in range(n)]
        bw = np.asarray(surv.bandwidths, float)
        schedules = tuple(
            aurora_schedule(
                degraded_traffic(trace.layer(l), host_map, sources, k), bw)
            for l in range(len(trace.layers)))
        pred = _mean_sim([
            degraded_inference_time(trace, l, surv, host_map, sources,
                                    policy="aurora")
            for l in range(len(trace.layers))
        ])
        scenario = ("degraded+homogeneous" if surv.homogeneous
                    else "degraded+heterogeneous")
        e2d = np.asarray([h[0] for h in host_map])
        return Plan(scenario, e2d, None, schedules, pred,
                    replication=host_map, survivors=tuple(chosen))

    def evaluate_replicated(self, trace: MoETrace, replicas) -> SimResult:
        """Predicted inference time of an EXISTING replica placement on
        (possibly new) traces — the scoring leg of online re-replication."""
        rep = validate_replication(replicas, trace.n)
        return _mean_sim([
            replicated_inference_time(trace, l, self.cluster, rep,
                                      policy="aurora")
            for l in range(len(trace.layers))
        ])

    # -- plan evaluation (re-planning support) ------------------------------
    def evaluate_exclusive(self, trace: MoETrace,
                           expert_to_device) -> SimResult:
        """Predicted inference time of an EXISTING expert→device assignment
        on (possibly new) traces — ``plan_exclusive``'s simulator leg without
        re-planning; the scoring leg of online re-assignment (scenario 2)."""
        e2d = np.asarray(expert_to_device)
        return _mean_sim([
            exclusive_inference_time(trace, l, self.cluster, e2d,
                                     policy="aurora")
            for l in range(len(trace.layers))
        ])

    def evaluate_colocated(self, trace_a: MoETrace, trace_b: MoETrace,
                           pair: list[int],
                           slot_to_device: np.ndarray | None = None
                           ) -> SimResult:
        """Predicted inference time of an EXISTING pairing on (possibly new)
        traces — the simulator leg of ``plan_colocated`` without re-planning.

        This is how online re-planning scores a stale plan against live
        traffic: evaluate the current pairing and a fresh plan on the SAME
        live trace, and switch only when the fresh plan wins by a margin.
        """
        cl = self.cluster
        n = trace_a.n
        s2d = (np.arange(n) if slot_to_device is None
               else np.asarray(slot_to_device))
        return _mean_sim([
            colocated_inference_time(trace_a, trace_b, l, cl, list(pair),
                                     s2d, policy="aurora")
            for l in range(len(trace_a.layers))
        ])

    # -- multi-tenant colocation (N >= 2) ------------------------------------
    def plan_multi(self, traces: list[MoETrace]) -> Plan:
        """N-tenant colocation plan: greedy k-way grouping (§7.2 decoupling
        applied tenant-by-tenant), then — heterogeneous only — group↔device
        bottleneck matching with the same inference-time edge weight as
        scenario 4. For two tenants this reproduces ``plan_colocated``.
        """
        cl = self.cluster
        nt = len(traces)
        if nt < 2:
            raise ValueError("plan_multi needs at least two tenants "
                             "(use plan_exclusive for one)")
        n = traces[0].n
        if any(tr.n != n for tr in traces):
            raise ValueError("all tenants must have equal expert counts")
        means = [np.mean([tr.layer(l) for l in range(len(tr.layers))], axis=0)
                 for tr in traces]
        if cl.homogeneous:
            scenario = "multi+homogeneous"
            groups = aurora_grouping(means)
            s2d = np.arange(n)
        else:
            scenario = "multi+heterogeneous"
            groups = aurora_grouping(means, use_case1=False)
            # Group↔device matching: the group's inference-time contribution
            # on a device is its combined compute (all tenants' gate + agg +
            # token-scaled FFN) over the device's compute, plus its send/recv
            # bottleneck over the device's bandwidth — scenario 4's weight
            # with the pair replaced by the k-group.
            d_agg = aggregate_traffic_multi(means, groups)
            send = d_agg.sum(axis=1)
            recv = d_agg.sum(axis=0)
            perms = group_pairs(groups)
            comp_fixed = sum(tr.gate + tr.agg for tr in traces)
            comp_tok = sum(
                traces[t].ffn_per_token
                * expert_loads(means[t])[np.asarray(perms[t])]
                for t in range(nt))
            w = np.empty((n, n))
            for k in range(n):
                for dev in range(n):
                    dt = cl.devices[dev]
                    w[k, dev] = ((comp_fixed + comp_tok[k]) / dt.compute
                                 + max(send[k], recv[k]) / dt.bandwidth)
            match, _ = bottleneck_perfect_matching(w)
            s2d = np.asarray(match)
        bw = np.asarray(cl.bandwidths, float)
        schedules = tuple(
            aurora_schedule(
                apply_assignment(
                    aggregate_traffic_multi(
                        [tr.layer(l) for tr in traces], groups),
                    s2d),
                bw)
            for l in range(len(traces[0].layers))
        )
        pred = self.evaluate_multi(traces, groups,
                                   None if cl.homogeneous else s2d)
        pair = [g[1] for g in groups] if nt == 2 else None
        return Plan(scenario, np.arange(n) if cl.homogeneous else s2d,
                    pair, schedules, pred, groups=tuple(groups))

    def evaluate_multi(self, traces: list[MoETrace],
                       groups: list[tuple[int, ...]],
                       slot_to_device: np.ndarray | None = None) -> SimResult:
        """Predicted inference time of an EXISTING grouping on (possibly new)
        traces — ``evaluate_colocated`` generalized to N tenants; the scoring
        leg of online re-grouping."""
        cl = self.cluster
        n = traces[0].n
        s2d = (np.arange(n) if slot_to_device is None
               else np.asarray(slot_to_device))
        return _mean_sim([
            multi_colocated_inference_time(traces, l, cl,
                                           [tuple(g) for g in groups],
                                           s2d, policy="aurora")
            for l in range(len(traces[0].layers))
        ])
