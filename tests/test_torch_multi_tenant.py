"""The port's multi-tenant engine (N = 2 and 3, re-grouping, tenant
churn) and exclusive re-assignment against the JAX reference, on the CPU.

Setup as in ``test_torch_colocated``: reduced phi3.5-MoE, weights from the
JAX package, identical greedy streams and bit-equal re-seated params.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_colocation import (JAX, N_E, PAIR0, PORT,  # noqa: E402
                               colocated_run, events, forced, leaves_equal,
                               reqs, streams)
from _torch_colocation import weights  # noqa: E402,F401 (fixture)
from repro_torch import core as tcore  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402


# -- multi-tenant engine -----------------------------------------------------

def test_multi_tenant_two_equals_dual_and_jax(weights):
    """N = 2 under a pairing: the port's multi-tenant engine equals its dual
    engine and the JAX multi-tenant engine."""
    groups = [(g, PAIR0[g]) for g in range(N_E)]

    def multi(s):
        eng = s.m.MultiTenantContinuousEngine(
            [s.model(), s.model()],
            [s.params(weights[0]),
             s.m.apply_pairing(s.params(weights[1]), PAIR0, s.cfg)],
            batch_slots=2, cache_cap=32,
            config=s.m.EngineConfig(kernels=True), groups=groups)
        return [streams(r) for r in eng.serve([reqs(s.m, 1),
                                                reqs(s.m, 2)])]

    want = multi(JAX)
    assert multi(PORT) == want
    assert colocated_run(PORT, weights, False, False)[1] == want


def test_multi_tenant_three_regroup_equals_jax_and_solo(weights):
    """N = 3, chunked, with a forced re-group: the JAX engine's streams,
    events and groups; the streams of each tenant served alone; tenant 0
    kept as the anchor; the monitors in the realised frames."""
    def multi(s):
        eng = s.m.MultiTenantContinuousEngine(
            [s.model() for _ in range(3)],
            [s.params(w) for w in weights[:3]], batch_slots=2, cache_cap=32,
            config=s.m.EngineConfig(kernels=True, prefill_chunk=4),
            replan=forced(s))
        return eng, [streams(r) for r in eng.serve(
            [reqs(s.m, 1 + t) for t in range(3)])]

    eng_j, want = multi(JAX)
    eng_t, got = multi(PORT)
    assert got == want
    assert events(eng_t) == events(eng_j)
    assert [tuple(g) for g in eng_t.groups] == [tuple(g) for g in eng_j.groups]
    assert any(e.applied for e in eng_t.replan_events)
    assert [g[0] for g in eng_t.groups] == list(range(N_E))
    for t in range(1, 3):
        assert eng_t.monitors[t].slot_to_expert == eng_t.tenant_pair(t)
        leaves_equal(eng_t.pools[t].params, eng_j.pools[t].params)
    for t in range(3):
        solo = tserving.ContinuousEngine(
            PORT.model(), PORT.params(weights[t]), batch_slots=2,
            cache_cap=32,
            config=tserving.EngineConfig(kernels=True, prefill_chunk=4))
        assert streams(solo.serve(reqs(tserving, 1 + t))) == got[t]


def test_multi_tenant_churn_equals_jax(weights):
    """Config-driven construction from ``TenantSpec``s, then a tenant
    admitted with a pairing (``admit_tenant(TenantSpec)``), served, and
    evicted: every stream equals the JAX engine's."""
    def churn(s):
        specs = (s.m.TenantSpec(name="a", model=s.model(),
                                params=s.params(weights[0])),
                 s.m.TenantSpec(name="b", model=s.model(),
                                params=s.params(weights[1]), pair=PAIR0))
        eng = s.m.MultiTenantContinuousEngine(
            batch_slots=2, cache_cap=32,
            config=s.m.EngineConfig(kernels=True, tenants=specs))
        out = [streams(r) for r in eng.serve([reqs(s.m, 1),
                                               reqs(s.m, 2)])]
        t = eng.admit_tenant(s.m.TenantSpec(
            name="c", model=s.model(), params=s.params(weights[3]),
            pair=[3, 2, 1, 0]))
        groups = [tuple(g) for g in eng.groups]
        out += [streams(r) for r in eng.serve([reqs(s.m, 3 + i)
                                                for i in range(3)])]
        pool = eng.evict_tenant(t)
        out += [streams(r) for r in eng.serve([reqs(s.m, 6),
                                                reqs(s.m, 7)])]
        return out, groups, eng.groups, pool.num_active

    want = churn(JAX)
    got = churn(PORT)
    assert got[0] == want[0]
    assert got[1] == [tuple(g) for g in want[1]] == [
        (g, PAIR0[g], 3 - g) for g in range(N_E)]
    assert [tuple(g) for g in got[2]] == [tuple(g) for g in want[2]]
    assert got[3] == 0


def test_multi_tenant_and_spec_validation(weights):
    m, p = PORT.model(), PORT.params(weights[0])
    with pytest.raises(ValueError, match="without model"):
        tserving.TenantSpec(params=p)
    assert tserving.TenantSpec(model=m, params=p,
                               pair=np.arange(4)).pair == (0, 1, 2, 3)
    with pytest.raises(ValueError, match=">= 2 tenants"):
        tserving.MultiTenantContinuousEngine([m], [p], 2, 32)
    with pytest.raises(ValueError, match="anchors"):
        tserving.MultiTenantContinuousEngine(
            [m, m], [p, p], 2, 32, groups=[(1, 0), (0, 1), (2, 2), (3, 3)])
    with pytest.raises(ValueError, match="permutation"):
        tserving.MultiTenantContinuousEngine(
            [m, m], [p, p], 2, 32, groups=[(0, 0), (1, 0), (2, 2), (3, 3)])
    with pytest.raises(ValueError, match="anchors"):
        tserving.MultiTenantContinuousEngine(
            batch_slots=2, cache_cap=32, config=tserving.EngineConfig(
                tenants=(tserving.TenantSpec(model=m, params=p, pair=PAIR0),
                         tserving.TenantSpec(model=m, params=p))))
    eng = tserving.MultiTenantContinuousEngine([m, m], [p, p], 2, 32)
    with pytest.raises(ValueError, match="permutation"):
        eng.admit_tenant(m, p, pair=[0, 0, 1, 2])
    eng.evict_tenant(1)
    with pytest.raises(ValueError, match="last"):
        eng.evict_tenant(0)


# -- exclusive re-assignment -------------------------------------------------

def test_adopt_assignment_equals_jax(weights):
    """A monitored ``ContinuousEngine`` adopting every changed Thm 5.1
    assignment on a heterogeneous cluster (``maybe_reassign``): streams
    equal the JAX engine's and a run that never re-seats, params equal
    the JAX engine's bit for bit, and the monitor follows the seats."""
    def run(s, adopt=True):
        mon = s.m.TrafficMonitor(N_E, 2)
        rp = forced(s, "heterogeneous_cluster", interval=2)
        eng = s.m.ContinuousEngine(
            s.model(), s.params(weights[0]), batch_slots=2, cache_cap=32,
            config=s.m.EngineConfig(kernels=True, prefill_chunk=4),
            monitor=mon)
        stream = reqs(s.m, 4, n=5)
        for r in stream:
            eng.submit(r)
        step = 0
        while eng.step():
            step += 1
            plan = rp.maybe_reassign(step, mon, eng.assignment)
            if plan is not None and adopt:
                eng.adopt(plan)
        return eng, rp, streams(stream)

    eng_j, rp_j, want = run(JAX)
    eng_t, rp_t, got = run(PORT)
    assert got == want == run(PORT, adopt=False)[2]
    assert [e.applied for e in rp_t.events] == [e.applied for e in rp_j.events]
    assert any(e.applied for e in rp_t.events)
    assert eng_t.assignment == list(eng_j.assignment)
    assert eng_t.monitor.slot_to_expert == tserving.inverse_pair(
        eng_t.assignment)
    leaves_equal(eng_t.params, eng_j.params)
    plan = tcore.AuroraPlanner(tcore.homogeneous_cluster(N_E)).plan_replicated(
        tcore.synthetic_trace("t", n_experts=N_E, n_layers=2), tolerance=0.0)
    eng_t.adopt(plan)                         # replicas on top of the seats
    assert eng_t.model.replication.counts == tuple(
        len(h) for h in plan.replication)
    with pytest.raises(tserving.PlanError, match="replicas are live"):
        eng_t.adopt_assignment(list(range(N_E)))
    with pytest.raises(tserving.PlanError, match="permutation"):
        eng_t.adopt_assignment([0, 0, 1, 2])
