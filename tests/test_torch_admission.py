"""The port's admission family against the JAX reference, on the CPU.

Each policy's ``select``, ``order`` and ``pad`` and ``EdfAdmission``'s
``shed_reason`` on seeded random ``RequestSpec`` lists (ties and
``math.inf`` deadlines included); ``TenantSpec``, ``scale_admission``,
``RingBuffer``; every ``EngineConfig`` validation and the
``resolve_admission`` mapping. These are host-side decisions, so results
must be equal, not close.
"""

import collections
import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serving import config as jc  # noqa: E402
from repro.serving import events as je  # noqa: E402
from repro_torch.serving import config as tc  # noqa: E402
from repro_torch.serving import events as te  # noqa: E402

# Policies as (class name, kwargs); each is built in both packages.
POLICIES = {
    "fifo": ("FifoAdmission", {}),
    "fifo_exact": ("FifoAdmission", {"bucket_policy": "exact"}),
    "length": ("LengthBucketedAdmission", {"chunk": 4}),
    "length_step": ("LengthBucketedAdmission",
                    {"chunk": 8, "bucket_policy": "step:8"}),
    "budget": ("TokenBudgetAdmission", {"chunk": 4, "budget": 9}),
    "budget_tight": ("TokenBudgetAdmission", {"chunk": 2, "budget": 3}),
    "edf": ("EdfAdmission", {"chunk": 4, "budget": 9}),
    "edf_unbudgeted": ("EdfAdmission", {"chunk": 4}),
    "edf_aged": ("EdfAdmission", {"chunk": 4, "budget": 12,
                                  "age_limit": 3.0}),
    "edf_shed": ("EdfAdmission", {"chunk": 4, "budget": 9, "shed": True,
                                  "queue_cap": 5, "age_limit": 6.0}),
    "edf_shed_unbudgeted": ("EdfAdmission", {"chunk": 4, "shed": True,
                                             "queue_cap": 3}),
}
N_CASES = 200


def _both(name, kw):
    return getattr(jc, name)(**kw), getattr(tc, name)(**kw)


def _specs(rng, mod):
    """A random pending list: few distinct arrivals and deadlines, so ties
    are common; a third of the deadlines are math.inf."""
    n = int(rng.integers(0, 9))
    out = []
    for _ in range(n):
        dl = (math.inf if rng.random() < 1 / 3
              else float(rng.integers(0, 12)))
        out.append(mod.RequestSpec(
            chunk=int(rng.integers(0, 13)),
            prompt_len=int(rng.integers(0, 41)),
            arrival=float(rng.integers(0, 6)), deadline=dl,
            tenant=int(rng.integers(0, 3))))
    return out


def _pair(rng):
    state = rng.bit_generator.state
    a = _specs(rng, jc)
    rng.bit_generator.state = state
    return a, _specs(rng, tc)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_policy_decisions_match_jax(policy):
    name, kw = POLICIES[policy]
    ref, ours = _both(name, kw)
    assert (ours.chunk, ours.budget) == (ref.chunk, ref.budget)
    rng = np.random.default_rng(sorted(POLICIES).index(policy))
    for _ in range(N_CASES):
        sj, st = _pair(rng)
        active = int(rng.integers(0, 10))
        assert ours.select(active, st) == ref.select(active, sj)
        assert ours.order(st) == ref.order(sj)
        n = int(rng.integers(1, 300))
        assert ours.pad(n) == ref.pad(n)
        if hasattr(ref, "shed_reason") and sj:
            assert (ours.shed_reason(st[0], st[1:], active)
                    == ref.shed_reason(sj[0], sj[1:], active))


def test_shed_reason_triggers_match_jax():
    """Both triggers fire: a full queue, and a deadline no schedule can
    meet; a finite deadline with room to spare and an infinite one pass."""
    ref, ours = _both("EdfAdmission", POLICIES["edf_shed"][1])
    queued = [dict(chunk=4, prompt_len=20, arrival=0.0, deadline=5.0)] * 2
    cases = [
        (dict(chunk=4, prompt_len=30, arrival=0.0, deadline=3.0), queued),
        (dict(chunk=4, prompt_len=8, arrival=0.0, deadline=9.0), queued),
        (dict(chunk=4, prompt_len=8, arrival=0.0), queued),
        (dict(chunk=4, prompt_len=8, arrival=0.0, deadline=99.0),
         queued * 3),
    ]
    reasons = []
    for spec, q in cases:
        want = ref.shed_reason(jc.RequestSpec(**spec),
                               [jc.RequestSpec(**r) for r in q])
        got = ours.shed_reason(tc.RequestSpec(**spec),
                               [tc.RequestSpec(**r) for r in q])
        assert got == want
        reasons.append(got and got.split(":")[0])
    assert reasons == ["deadline", None, None, "queue_cap"]


def test_tenant_spec_and_scale_admission_match_jax():
    for kw in ({}, {"name": "a", "ttft_p95": 6.0},
               {"ttft_p95": 0.5, "tpot_p95": 2.0, "rate_share": 0.25}):
        ref, ours = jc.TenantSpec(**kw), tc.TenantSpec(**kw)
        for arrival in (0.0, 3.5, 17.0):
            assert ours.deadline(arrival) == ref.deadline(arrival)
    for bad in ({"ttft_p95": 0}, {"tpot_p95": -1.0}, {"rate_share": 0.0},
                {"rate_share": 1.5}):
        with pytest.raises(ValueError):
            jc.TenantSpec(**bad)
        with pytest.raises(ValueError):
            tc.TenantSpec(**bad)
    for policy in sorted(POLICIES):
        ref, ours = _both(*POLICIES[policy])
        for share in (None, 0.01, 0.3, 0.5, 1.0):
            want = jc.scale_admission(ref, share)
            got = tc.scale_admission(ours, share)
            assert type(got).__name__ == type(want).__name__
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_ring_buffer_matches_jax():
    for cap in (1, 3, 8):
        ref, ours, twin = je.RingBuffer(cap), te.RingBuffer(cap), te.RingBuffer(cap)
        assert not ours and ours == []
        for i in range(11):
            for buf in (ref, ours, twin):
                buf.append(i)
            assert (len(ours), ours.dropped) == (len(ref), ref.dropped)
            assert ours == list(ref) and ours == twin
            assert ours == collections.deque(ref) and ours == tuple(ref)
            assert ours[0] == ref[0] and ours[-1] == ref[-1]
            assert ours[1:] == ref[1:]
        ours.extend([20, 21])
        ref.extend([20, 21])
        assert ours == list(ref) and ours.dropped == ref.dropped
        assert ours != [*ref, 0]
        ours.clear()
        assert len(ours) == 0 and ours.capacity == cap
    for bad in (0, -2):
        with pytest.raises(ValueError):
            je.RingBuffer(bad)
        with pytest.raises(ValueError):
            te.RingBuffer(bad)


# The reference's EngineConfig validations, each as keyword arguments (a
# callable builds the policy or tenant in the right package).
CONFIG_CASES = {
    "admission_and_chunk": lambda m: dict(admission=m.FifoAdmission(),
                                          prefill_chunk=2),
    "admission_and_budget": lambda m: dict(
        admission=m.LengthBucketedAdmission(chunk=2), step_token_budget=4),
    "admission_and_bucket": lambda m: dict(admission=m.FifoAdmission(),
                                           bucket_policy="exact"),
    "chunk_zero": lambda m: dict(prefill_chunk=0),
    "budget_without_chunk": lambda m: dict(step_token_budget=5),
    "pool_zero": lambda m: dict(prefill_pool=0),
    "pool_without_chunk": lambda m: dict(prefill_pool=2),
    "pool_one_shot_policy": lambda m: dict(admission=m.FifoAdmission(),
                                           prefill_pool=3),
    "event_capacity_zero": lambda m: dict(event_capacity=0),
    "tenant_not_spec": lambda m: dict(tenants=("a",)),
    "tenant_shares_over_one": lambda m: dict(tenants=(
        m.TenantSpec(rate_share=0.6), m.TenantSpec(rate_share=0.5))),
    "length_chunk_zero": lambda m: m.LengthBucketedAdmission(chunk=0),
    "budget_chunk_zero": lambda m: m.TokenBudgetAdmission(chunk=0, budget=4),
    "budget_zero": lambda m: m.TokenBudgetAdmission(chunk=2, budget=0),
    "edf_chunk_zero": lambda m: m.EdfAdmission(chunk=0),
    "edf_budget_zero": lambda m: m.EdfAdmission(chunk=2, budget=0),
    "edf_age_zero": lambda m: m.EdfAdmission(chunk=2, age_limit=0.0),
    "edf_queue_cap_zero": lambda m: m.EdfAdmission(chunk=2, queue_cap=0),
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_config_validation_matches_jax(case):
    for mod in (jc, tc):
        with pytest.raises(ValueError):
            kw = CONFIG_CASES[case](mod)
            mod.EngineConfig(**kw)


def test_resolve_admission_maps_alike():
    cases = [
        {}, {"bucket_policy": "exact"}, {"prefill_chunk": 4},
        {"prefill_chunk": 4, "bucket_policy": "step:4"},
        {"prefill_chunk": 4, "step_token_budget": 9},
        {"prefill_chunk": 4, "step_token_budget": 9, "prefill_pool": 3},
    ]
    for kw in cases:
        want = jc.EngineConfig(**kw).resolve_admission()
        cfg = tc.EngineConfig(**kw)
        got = cfg.resolve_admission()
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert cfg.resolve_admission() is got                   # cached
    for name, kw in POLICIES.values():
        ours = getattr(tc, name)(**kw)
        assert tc.EngineConfig(admission=ours).resolve_admission() is ours
    for mod in (jc, tc):
        with pytest.raises(TypeError):
            mod.EngineConfig(admission=object()).resolve_admission()
