"""The port's N-tenant and static colocated engines with tenants of the
ssm, hybrid and vlm families beside phi3.5-MoE, against the JAX reference
on the CPU.

Reduced fp32 configs, weights made by the JAX package. Greedy streams
must be identical to the JAX engines': ``MultiTenantContinuousEngine``
over phi3.5, mamba2, qwen2-vl and zamba2 (each family tenant also equal
to its solo stream); a mamba2 tenant admitted into a running phi3.5 +
phi4-mini engine and evicted mid-stream, its detached pool finishing
alone; and the static ``ColocatedEngine`` for each family.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_colocation import (ARCH, DENSE, FAMILIES, HYBRID,  # noqa: E402
                               JAX, PORT, SSM, VLM, family_config, reqs,
                               streams, tenant)
from repro_torch import serving as tserving  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (many small ops; several test workers share the
    host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FOUR = [(ARCH, 0), (SSM, 1), (VLM, 2), (HYBRID, 3)]


def _four_run(s):
    """The four tenants (2 slots, cache 32), request seeds 1-4."""
    ts = [tenant(s, a, seed) for a, seed in FOUR]
    eng = s.m.MultiTenantContinuousEngine(
        [m for m, _ in ts], [p for _, p in ts], batch_slots=2, cache_cap=32,
        config=s.m.EngineConfig(kernels=True))
    out = eng.serve([reqs(s.m, t + 1) for t in range(len(FOUR))])
    return eng, [streams(r) for r in out]


def test_four_tenants_equal_jax_and_solo():
    eng_j, want = _four_run(JAX)
    eng_t, got = _four_run(PORT)
    assert got == want
    assert eng_t.decode_steps == eng_j.decode_steps
    assert eng_t.groups == [tuple(g) for g in eng_j.groups]
    assert len(eng_t.groups) == 4 and all(len(g) == 4 for g in eng_t.groups)
    for t, (arch, seed) in enumerate(FOUR[1:], 1):
        m, p = tenant(PORT, arch, seed)
        solo = tserving.ContinuousEngine(
            m, p, batch_slots=2, cache_cap=32,
            config=family_config(PORT, "one_shot"))
        assert streams(solo.serve(reqs(tserving, t + 1))) == got[t]


def _churn_run(s):
    """phi3.5 and phi4-mini take two lockstep steps; mamba2 is admitted,
    takes three, and is evicted mid-stream; the engine and the detached
    pool then each run to the end. Returns the three tenants' streams,
    the groups after admission and the evicted pool's decode count."""
    (ma, pa), (mb, pb), (mc, pc) = (tenant(s, ARCH, 0), tenant(s, DENSE, 1),
                                    tenant(s, SSM, 2))
    eng = s.m.MultiTenantContinuousEngine(
        [ma, mb], [pa, pb], batch_slots=2, cache_cap=32,
        config=s.m.EngineConfig(kernels=True))
    streams_in = [reqs(s.m, 1), reqs(s.m, 2), reqs(s.m, 3)]
    for pool, rs in zip(eng.pools, streams_in):
        for r in rs:
            pool.submit(r)
    for _ in range(2):
        eng.step()
    t = eng.admit_tenant(mc, pc)
    for r in streams_in[2]:
        eng.pools[t].submit(r)
    for _ in range(3):
        eng.step()
    groups = [tuple(g) for g in eng.groups]
    pool = eng.evict_tenant(t)
    assert eng.n_tenants == 2 and all(len(g) == 2 for g in eng.groups)
    while eng.step():
        pass
    while pool.step():
        pass
    return [streams(rs) for rs in streams_in], groups, pool.decode_steps


def test_admit_and_evict_an_ssm_tenant_equal_jax():
    """The mamba2 tenant gets the identity column over phi3.5's experts;
    every stream, the evicted pool's included, equals the JAX engine's,
    and the mamba2 stream equals its solo stream."""
    want = _churn_run(JAX)
    got = _churn_run(PORT)
    assert got == want
    assert got[1] == [(g, g, g) for g in range(4)]
    m, p = tenant(PORT, SSM, 2)
    solo = tserving.ContinuousEngine(m, p, batch_slots=2, cache_cap=32,
                                     config=family_config(PORT, "one_shot"))
    assert streams(solo.serve(reqs(tserving, 3))) == got[0][2]


@pytest.mark.parametrize("arch", FAMILIES)
def test_static_colocated_engine_equals_jax(arch):
    """Two static batches (phi3.5, the family) decoded in lockstep on the
    kernel path: both equal the JAX engine's, and the family's batch
    equals its batch served alone."""
    pa = np.random.default_rng(0).integers(1, 500, (2, 6))
    pb = np.random.default_rng(1).integers(1, 500, (2, 6))
    outs = []
    for s in (JAX, PORT):
        (ma, wa), (mb, wb) = tenant(s, ARCH, 0), tenant(s, arch, 1)
        eng = s.m.ColocatedEngine(ma.with_kernels(), mb.with_kernels(), wa,
                                  wb)
        outs.append([np.asarray(o).tolist() for o in eng.serve(
            pa, pb, max_new_tokens=5, cache_cap=16)])
    assert outs[1] == outs[0]
    mb, wb = tenant(PORT, arch, 1)
    mb = mb.with_kernels()
    solo = tserving.ColocatedEngine(mb, mb, wb, wb).serve(
        pb, pb, max_new_tokens=5, cache_cap=16)[0]
    assert solo.tolist() == outs[1][1]
