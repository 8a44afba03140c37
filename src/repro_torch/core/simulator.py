"""Inference-time simulator for the four Aurora scenarios (Eqn 1–4, Table 2).

Timing semantics follow the paper:

- Exclusive (Eqn 3, generalized to heterogeneous devices):
  ``t = max_i G_i + N + max_i F_i + C + max_i A_i`` where N and C are the two
  all-to-all times under the chosen scheduling policy.
- Colocated (Table 2 recurrence): model b's gate overlaps model a's dispatch,
  each model's FFN overlaps the other model's communication, etc. Component
  end-times are the maxima across devices, exactly as Table 2 collapses the
  per-GPU index. Aggregated communication completions follow §6.2:
  ``End(N^b) = |overline{N^a+N^b}|`` and
  ``End(C^b) = |overline{N^a+N^b}| + |overline{C^a+C^b}|`` (N and C phases are
  disjoint in time, separated by the FFNs), each additionally floored by the
  compute dependencies (a phase cannot end before its producer finished plus
  its own duration).

Computation-time model: ``trace.gate`` / ``trace.agg`` are per-device times on
a reference (compute=1.0) device; FFN time is ``ffn_per_token × tokens
received``; a device with relative compute c runs all of these 1/c as fast.
GPU utilization is compute-busy time divided by inference time, averaged over
devices (§8.1 metrics).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .assignment import apply_assignment
from .cluster import Cluster
from .colocation import aggregate_traffic, aggregate_traffic_multi, lina_packing
from .schedule import comm_time
from .traffic import (MoETrace, degraded_ffn_loads, degraded_traffic,
                      replicated_ffn_loads, replicated_traffic, strip_diagonal)


@dataclasses.dataclass(frozen=True)
class SimResult:
    inference_time: float
    utilization: float
    detail: dict


def _device_arrays(cluster: Cluster) -> tuple[np.ndarray, np.ndarray]:
    return (np.asarray(cluster.bandwidths, float),
            np.asarray(cluster.computes, float))


def exclusive_inference_time(
    trace: MoETrace,
    layer: int,
    cluster: Cluster,
    expert_to_device: np.ndarray | None = None,
    policy: str = "aurora",
    seed: int = 0,
) -> SimResult:
    """One MoE layer, one model per cluster (scenarios 1 and 2)."""
    d_exp = trace.layer(layer)
    n = d_exp.shape[0]
    if cluster.n != n:
        raise ValueError("one device per expert required in exclusive mode")
    e2d = (np.arange(n) if expert_to_device is None
           else np.asarray(expert_to_device))
    d_dev = apply_assignment(d_exp, e2d)
    bw, comp = _device_arrays(cluster)

    recv_tokens = strip_diagonal(d_dev).sum(axis=0)  # per-device FFN load
    gate = trace.gate / comp
    ffn = trace.ffn_time(recv_tokens) / comp
    agg = trace.agg / comp
    n_time = comm_time(d_dev, policy, bw, seed=seed)
    c_time = comm_time(d_dev.T, policy, bw, seed=seed + 1)

    t = float(gate.max() + n_time + ffn.max() + c_time + agg.max())
    busy = gate + ffn + agg
    util = float(np.mean(busy / t)) if t > 0 else 1.0
    return SimResult(t, util, dict(
        gate=float(gate.max()), N=n_time, ffn=float(ffn.max()),
        C=c_time, agg=float(agg.max()),
    ))


def replicated_inference_time(
    trace: MoETrace,
    layer: int,
    cluster: Cluster,
    replicas,
    policy: str = "aurora",
    seed: int = 0,
) -> SimResult:
    """Exclusive scenario with hot experts replicated across devices.

    ``replicas[e]`` lists the devices hosting a copy of expert e (home
    first); tokens split evenly across copies (the shard-of-token rule), so
    a device hosting r copies of a hot expert receives 1/r of its column —
    both the all-to-all bottleneck column and the FFN straggler shrink.
    Shares absorbed by a replica on the token's own source device never
    cross the network but still count as FFN load.
    """
    d_exp = trace.layer(layer)
    n = d_exp.shape[0]
    if cluster.n != n:
        raise ValueError("one home device per expert required")
    d_dev = replicated_traffic(d_exp, replicas)
    ffn_tokens = replicated_ffn_loads(d_exp, replicas)
    bw, comp = _device_arrays(cluster)

    gate = trace.gate / comp
    ffn = trace.ffn_time(ffn_tokens) / comp
    agg = trace.agg / comp
    n_time = comm_time(d_dev, policy, bw, seed=seed)
    c_time = comm_time(d_dev.T, policy, bw, seed=seed + 1)

    t = float(gate.max() + n_time + ffn.max() + c_time + agg.max())
    busy = gate + ffn + agg
    util = float(np.mean(busy / t)) if t > 0 else 1.0
    return SimResult(t, util, dict(
        gate=float(gate.max()), N=n_time, ffn=float(ffn.max()),
        C=c_time, agg=float(agg.max()),
        n_replicas=int(sum(len(h) for h in replicas)),
    ))


def degraded_inference_time(
    trace: MoETrace,
    layer: int,
    survivors: Cluster,
    hosts,
    sources,
    policy: str = "aurora",
    seed: int = 0,
) -> SimResult:
    """Exclusive scenario on a survivor-only cluster after device loss.

    Unlike ``exclusive_inference_time``/``replicated_inference_time``, the
    device count ``m = survivors.n`` may be SMALLER than the expert count:
    ``hosts[e]`` lists the survivor indices computing expert e (several
    experts share a device, replicas still shard tokens evenly) and
    ``sources[i]`` maps each ORIGINAL device's token stream onto the
    survivor that inherited it. The timing law is still Eqn 3 — the failure
    changes the deployment, not the phase structure.
    """
    d_exp = trace.layer(layer)
    m = survivors.n
    d_dev = degraded_traffic(d_exp, hosts, sources, m)
    ffn_tokens = degraded_ffn_loads(d_exp, hosts, m)
    bw, comp = _device_arrays(survivors)

    gate = trace.gate / comp
    ffn = trace.ffn_time(ffn_tokens) / comp
    agg = trace.agg / comp
    n_time = comm_time(d_dev, policy, bw, seed=seed)
    c_time = comm_time(d_dev.T, policy, bw, seed=seed + 1)

    t = float(gate.max() + n_time + ffn.max() + c_time + agg.max())
    busy = gate + ffn + agg
    util = float(np.mean(busy / t)) if t > 0 else 1.0
    return SimResult(t, util, dict(
        gate=float(gate.max()), N=n_time, ffn=float(ffn.max()),
        C=c_time, agg=float(agg.max()), n_survivors=m,
    ))


def colocated_inference_time(
    trace_a: MoETrace,
    trace_b: MoETrace,
    layer: int,
    cluster: Cluster,
    pair: list[int],
    slot_to_device: np.ndarray | None = None,
    policy: str = "aurora",
    seed: int = 0,
) -> SimResult:
    """Two models colocated, one expert of each per device (scenarios 3, 4).

    Slot k hosts a-expert k and b-expert ``pair[k]``; ``slot_to_device`` maps
    slots onto physical devices (identity on homogeneous clusters).
    """
    da = trace_a.layer(layer)
    db = trace_b.layer(layer)
    n = da.shape[0]
    if db.shape[0] != n:
        raise ValueError("colocated models must have equal expert counts (§6 fn 3)")
    if cluster.n != n:
        raise ValueError("one device per expert pair required")
    s2d = (np.arange(n) if slot_to_device is None
           else np.asarray(slot_to_device))
    p = np.asarray(pair)

    # Device-space matrices.
    da_dev = apply_assignment(da, s2d)                      # a-expert k -> slot k
    db_dev = apply_assignment(db[np.ix_(p, p)], s2d)        # b-expert pair[k] -> slot k
    d_agg = apply_assignment(aggregate_traffic(da, db, pair), s2d)
    bw, comp = _device_arrays(cluster)

    # Communication times under the policy.
    na = comm_time(da_dev, policy, bw, seed=seed)
    nb = comm_time(db_dev, policy, bw, seed=seed + 1)
    n_agg = comm_time(d_agg, policy, bw, seed=seed + 2)     # |overline{Na+Nb}|
    ca = comm_time(da_dev.T, policy, bw, seed=seed + 3)
    cb = comm_time(db_dev.T, policy, bw, seed=seed + 4)
    c_agg = comm_time(d_agg.T, policy, bw, seed=seed + 5)   # |overline{Ca+Cb}|

    # Per-device compute times.
    recv_a = strip_diagonal(da_dev).sum(axis=0)
    recv_b = strip_diagonal(db_dev).sum(axis=0)
    ga = trace_a.gate / comp
    gb = trace_b.gate / comp
    fa = trace_a.ffn_time(recv_a) / comp
    fb = trace_b.ffn_time(recv_b) / comp
    aa = trace_a.agg / comp
    ab = trace_b.agg / comp

    # Table 2 recurrence (maxima across devices).
    e_gb = float(gb.max())
    e_na = na                                    # End(N^a) = |N̄^a|
    e_fa = max(e_gb, e_na) + float(fa.max())
    e_nb = max(n_agg, e_gb + nb)                 # End(N^b) = |overline{Na+Nb}|
    e_fb = max(e_fa, e_nb) + float(fb.max())
    e_ca = max(e_nb, e_fa) + ca                  # network frees at E_Nb; §6.2:
    #   |overline{Na+Nb+Ca}| = |overline{Na+Nb}| + |C̄a|, floored by E_Fa.
    e_aa = max(e_fb, e_ca) + float(aa.max())
    # End(C^b) = |overline{Na+Nb}| + |overline{Ca+Cb}| (the two return
    # all-to-alls overlap), floored by its compute producer and by E_Ca.
    e_cb = max(e_nb + c_agg, e_fb + cb, e_ca)
    e_ab = max(e_aa, e_cb) + float(ab.max())
    t = e_ab + float(ga.max())  # Eqn 4: + |G^a| of the next round

    busy = ga + gb + fa + fb + aa + ab
    util = float(np.mean(busy / t)) if t > 0 else 1.0
    return SimResult(t, util, dict(
        Na=na, Nb=nb, Nagg=n_agg, Ca=ca, Cb=cb,
        E_Fa=e_fa, E_Fb=e_fb, E_Ab=e_ab,
    ))


def multi_colocated_inference_time(
    traces: list[MoETrace],
    layer: int,
    cluster: Cluster,
    groups: list[tuple[int, ...]],
    slot_to_device: np.ndarray | None = None,
    policy: str = "aurora",
    seed: int = 0,
) -> SimResult:
    """N tenants colocated, one expert of each per device.

    The Table-2 recurrence generalizes phase-by-phase. Tenants are indexed
    m = 0..T-1 in interleave order; slot g hosts expert ``groups[g][m]`` of
    tenant m. On the shared network, dispatches serialize and the §6.2
    merged-traffic law gives ``End(N^m) = |overline{N^0+..+N^m}|`` (prefix
    aggregates), floored by the producing gate plus the tenant's own
    dispatch; the return all-to-alls likewise complete at
    ``End(N^{T-1}) + |overline{C^0+..+C^m}|``, floored by their producing
    FFN and the previous combine. On the shared compute, gates of tenants
    1..T-1 run during tenant 0's dispatch, then FFNs and aggregations chain
    in tenant order — the T-fold version of "one model computes while the
    others communicate". For T == 2 this reduces term-for-term to
    ``colocated_inference_time`` (exactly equal under deterministic
    policies; the seeded ``rcs`` policy draws its random orders from a
    different seed layout).
    """
    tmats = [tr.layer(layer) for tr in traces]
    nt = len(traces)
    if nt < 1:
        raise ValueError("need at least one tenant")
    n = tmats[0].shape[0]
    for d in tmats:
        if d.shape[0] != n:
            raise ValueError(
                "colocated tenants must have equal expert counts (§6 fn 3)")
    if cluster.n != n:
        raise ValueError("one device per expert group required")
    if len(groups) != n or any(len(g) != nt for g in groups):
        raise ValueError(f"groups must be {n} tuples of {nt} experts")
    s2d = (np.arange(n) if slot_to_device is None
           else np.asarray(slot_to_device))
    bw, comp = _device_arrays(cluster)

    # Per-tenant device-space matrices and their prefix aggregates.
    devs, prefixes = [], []
    run = np.zeros((n, n))
    for m in range(nt):
        p = np.asarray([g[m] for g in groups])
        d_dev = apply_assignment(tmats[m][np.ix_(p, p)], s2d)
        devs.append(d_dev)
        run = run + d_dev
        prefixes.append(run.copy())

    n_own = [comm_time(devs[m], policy, bw, seed=seed + 2 * m)
             for m in range(nt)]
    c_own = [comm_time(devs[m].T, policy, bw, seed=seed + 2 * m + 1)
             for m in range(nt)]
    # prefixes[0] IS devs[0]: reuse its times so stochastic policies (rcs)
    # don't draw two different samples of the same all-to-all.
    n_pref = [n_own[0]] + [
        comm_time(prefixes[m], policy, bw, seed=seed + 2 * nt + m)
        for m in range(1, nt)]
    c_pref = [c_own[0]] + [
        comm_time(prefixes[m].T, policy, bw, seed=seed + 3 * nt + m)
        for m in range(1, nt)]

    # Per-device compute times (reference-device times scaled by 1/compute).
    gate = [tr.gate / comp for tr in traces]
    ffn = [traces[m].ffn_time(strip_diagonal(devs[m]).sum(axis=0)) / comp
           for m in range(nt)]
    agg_t = [tr.agg / comp for tr in traces]
    g_max = [float(g.max()) for g in gate]
    f_max = [float(f.max()) for f in ffn]
    a_max = [float(a.max()) for a in agg_t]

    # Gates of tenants 1.. chain on the shared compute during N^0.
    e_g = [0.0] * nt
    for m in range(1, nt):
        e_g[m] = e_g[m - 1] + g_max[m]
    # Dispatches: prefix-aggregated completion, floored by the gate producer.
    e_n = [max(n_pref[m], e_g[m] + n_own[m]) for m in range(nt)]
    # FFNs chain after the last gate, each gated on its own dispatch.
    e_f = [0.0] * nt
    prev = e_g[nt - 1]
    for m in range(nt):
        e_f[m] = max(prev, e_n[m]) + f_max[m]
        prev = e_f[m]
    # Combines: network frees at End(N^{T-1}); prefix-aggregated, floored by
    # the producing FFN and ordered after the previous combine.
    e_c = [0.0] * nt
    prev = 0.0
    for m in range(nt):
        e_c[m] = max(e_n[nt - 1] + c_pref[m], e_f[m] + c_own[m], prev)
        prev = e_c[m]
    # Aggregations chain after the last FFN, each gated on its own combine.
    e_a = [0.0] * nt
    prev = e_f[nt - 1]
    for m in range(nt):
        e_a[m] = max(prev, e_c[m]) + a_max[m]
        prev = e_a[m]
    t = e_a[nt - 1] + g_max[0]        # Eqn 4: + |G^0| of the next round

    busy = np.zeros(n)
    for m in range(nt):
        busy = busy + gate[m] + ffn[m] + agg_t[m]
    util = float(np.mean(busy / t)) if t > 0 else 1.0
    agg_all = aggregate_traffic_multi(tmats, groups)
    return SimResult(t, util, dict(
        n_tenants=nt, N=n_own, C=c_own, N_prefix=n_pref, C_prefix=c_pref,
        E_N=e_n, E_F=e_f, E_C=e_c, E_A=e_a,
        agg_bmax=comm_time(apply_assignment(agg_all, s2d), policy, bw,
                           seed=seed + 4 * nt),
    ))


def lina_inference_time(
    trace: MoETrace,
    layer: int,
    cluster: Cluster,
    device_subset: np.ndarray | None = None,
    policy: str = "aurora",
    seed: int = 0,
) -> SimResult:
    """Lina baseline: two experts of the SAME model per device.

    The model's n experts pack onto n/2 devices (popular-with-unpopular);
    colocated same-model experts stay bound to the synchronous all-to-all, so
    the phase structure is the exclusive one with merged traffic and doubled
    per-device FFN load (Fig 3a).
    """
    d_exp = trace.layer(layer)
    merged, pairs = lina_packing(d_exp)
    m = merged.shape[0]
    if device_subset is None:
        device_subset = np.arange(m)
    devs = [cluster.devices[i] for i in np.asarray(device_subset)]
    bw = np.asarray([d.bandwidth for d in devs], float)
    comp = np.asarray([d.compute for d in devs], float)

    recv_tokens = strip_diagonal(merged).sum(axis=0)
    gate = trace.gate / comp
    # Two experts per device: two weight-loads (fixed cost counted twice).
    ffn = (trace.ffn_fixed + trace.ffn_time(recv_tokens)) / comp
    agg = trace.agg / comp
    n_time = comm_time(merged, policy, bw, seed=seed)
    c_time = comm_time(merged.T, policy, bw, seed=seed + 1)

    t = float(gate.max() + n_time + ffn.max() + c_time + agg.max())
    busy = gate + ffn + agg
    util = float(np.mean(busy / t)) if t > 0 else 1.0
    return SimResult(t, util, dict(pairs=pairs, N=n_time, C=c_time))


def mean_over_layers(fn, n_layers: int, **kw) -> SimResult:
    """Average a per-layer simulator over all layers of a trace."""
    results = [fn(layer=l, **kw) for l in range(n_layers)]
    return SimResult(
        inference_time=float(np.mean([r.inference_time for r in results])),
        utilization=float(np.mean([r.utilization for r in results])),
        detail={"per_layer": [r.inference_time for r in results]},
    )
