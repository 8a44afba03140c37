"""The port's dual-model colocated engine with a tenant of the ssm, hybrid
or vlm family beside phi3.5-MoE, against the JAX reference on the CPU.

Reduced fp32 configs: phi3.5-MoE (seed 0) beside mamba2, zamba2 or
qwen2-vl (seed 1), weights made by the JAX package and carried across by
``repro_torch.bridge``. One-shot admission here (chunked and pooled in
``test_torch_colocated_families_chunked.py``; the N-tenant and static
engines in ``test_torch_colocated_families_multi.py``): both tenants'
greedy streams equal the JAX engine's, and the family tenant's equals its
solo ``ContinuousEngine`` stream. The lockstep step keeps a masked row's
SSM and KV state frozen, and a reused slot does not inherit an SSM
tenant's state. Refusals follow the reference's conditions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_colocation import (ARCH, AUDIO, FAMILIES, JAX, PORT,  # noqa: E402
                               SSM, family_config, family_run, forced,
                               reqs, streams, tenant)
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these paths run many small ops, and several
    test workers on one host make every multi-threaded op wait for
    descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", FAMILIES)
def test_dual_engine_streams_equal_jax_and_solo(arch):
    """One-shot admission, 2 slots, 3 requests a tenant (a slot is reused
    and vacant rows decode): both streams and the lockstep step count
    equal the JAX engine's; the family tenant gets no pairing, and its
    stream equals its solo ``ContinuousEngine`` stream."""
    eng_j, want = family_run(JAX, arch, "one_shot")
    eng_t, got = family_run(PORT, arch, "one_shot")
    assert got == want
    assert eng_t.decode_steps == eng_j.decode_steps
    assert eng_t.pair == list(eng_j.pair) == []
    mb, pb = tenant(PORT, arch, 1)
    solo = tserving.ContinuousEngine(mb, pb, batch_slots=2, cache_cap=32,
                                     config=family_config(PORT, "one_shot"))
    assert streams(solo.serve(reqs(tserving, 2))) == got[1]


@pytest.mark.parametrize("arch", FAMILIES)
def test_lockstep_step_freezes_masked_rows(arch):
    """``build_lockstep_step`` over phi3.5 and the family tenant with row
    masks: a masked row keeps every cache leaf (the SSM conv window and
    state, the shared block's or the vlm's KV) and its fill level; an
    unmasked row advances by one position."""
    models, params, caches = [], [], []
    for a, seed in ((ARCH, 0), (arch, 1)):
        m, p = tenant(PORT, a, seed)
        m = m.with_kernels()
        cache = m.init_cache(2, 16, per_slot_len=True)
        for slot, prompt in enumerate(([3, 1, 4, 1, 5], [9, 2, 6])):
            m.prefill_slot(p, {"tokens": torch.tensor([prompt])}, cache,
                           slot, cap=16)
        models.append(m)
        params.append(p)
        caches.append(cache)
    before = [[t.clone() for t in tt.cache_leaves(c)] for c in caches]
    lens = [c["len"].clone() for c in caches]
    step = tserving.build_lockstep_step(models, collect_stats=False)
    toks = [torch.tensor([[7], [8]])] * 2
    masks = [torch.tensor([True, True]), torch.tensor([True, False])]
    logits, caches = step(params, toks, caches, masks)
    assert [lg.shape[:2] for lg in logits] == [(2, 1), (2, 1)]
    for t, (cache, mask) in enumerate(zip(caches, masks)):
        assert cache["len"].tolist() == (lens[t] + mask.int()).tolist()
        changed = [not torch.equal(a[:, 0], b[:, 0])
                   for a, b in zip(tt.cache_leaves(cache), before[t])]
        assert any(changed)
        if not mask[1]:
            for a, b in zip(tt.cache_leaves(cache), before[t]):
                assert torch.equal(a[:, 1], b[:, 1])


@pytest.mark.parametrize("chunk", [None, 2], ids=["one_shot", "chunk2"])
def test_colocated_ssm_slot_reuse_isolation(chunk):
    """The reference's ``test_continuous_ssm_state_isolation``
    (``tests/test_continuous.py:84``) through the colocated engine: mamba2
    in one reused slot beside phi3.5. Its second request's stream equals
    a fresh engine's: the slot's conv window and SSD state start from
    zero."""
    config = tserving.EngineConfig(prefill_len=4, prefill_chunk=chunk)
    (ma, pa), (mb, pb) = tenant(PORT, ARCH, 0), tenant(PORT, SSM, 1)
    eng = tserving.ColocatedContinuousEngine(ma, mb, pa, pb, batch_slots=1,
                                             cache_cap=32, config=config)
    reqs_b = [tserving.Request(prompt=[9, 9, 9, 9], max_new_tokens=3),
              tserving.Request(prompt=[1, 2, 3, 4], max_new_tokens=4,
                               arrival=4.0)]
    reqs_a = [tserving.Request(prompt=[5, 6, 7, 8], max_new_tokens=6)]
    _, out = eng.serve(reqs_a, reqs_b)
    solo = tserving.ContinuousEngine(mb, pb, batch_slots=1, cache_cap=32,
                                     config=config).serve(
        [tserving.Request(prompt=[1, 2, 3, 4], max_new_tokens=4)])
    assert streams(out)[1] == streams(solo)[0]


def test_wrappers_and_checkpoints_around_an_ssm_tenant():
    """The lockstep step of phi3.5 beside mamba2 through a ``FaultInjector``
    (an empty plan: no NaN flagged) and a telemetry hub changes no token;
    the hub records one ``lockstep_decode`` span a step. A pool's
    ``checkpoint`` clones the SSM cache, so ``restore`` rolls its state
    back."""
    hub = tserving.Telemetry()
    inj = tserving.FaultInjector(tserving.FaultPlan(()), n_devices=2)
    config = tserving.EngineConfig(kernels=True, step_wrapper=inj.wrap,
                                   telemetry=hub)
    (ma, pa), (mb, pb) = tenant(PORT, ARCH, 0), tenant(PORT, SSM, 1)
    eng = tserving.ColocatedContinuousEngine(ma, mb, pa, pb, batch_slots=2,
                                             cache_cap=32, config=config)
    ra, rb = eng.serve(reqs(tserving, 1), reqs(tserving, 2))
    assert [streams(ra), streams(rb)] == family_run(PORT, SSM,
                                                    "one_shot")[1]
    assert not inj.health.drain()
    spans = [s for s in hub.spans if s.name == "lockstep_decode"]
    assert len(spans) == eng.decode_steps > 0

    pool = eng.pool_b
    pool.submit(tserving.Request(prompt=[4, 4, 2], max_new_tokens=6))
    eng.step()
    snap = pool.checkpoint()
    state = tt.cache_leaves(pool.cache)
    saved = [t.clone() for t in state]
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(state, tt.cache_leaves(snap["cache"])))
    eng.step()
    assert any(not torch.equal(a, b) for a, b in zip(state, saved))
    pool.restore(snap)
    assert all(torch.equal(a, b) for a, b in zip(state, saved))


def test_refusals_follow_the_reference():
    """Re-planning beside a tenant without experts refuses with the
    reference's message in both continuous engines and in
    ``admit_tenant``; SeamlessM4T raises ValueError in the three engines
    and in ``admit_tenant``, which leaves the engine as it was (the
    reference's fail with KeyError: 'frames'); the distributed
    colocated engines refuse a tenant without experts, as the
    reference's ``distribute`` does."""
    from repro_torch.distributed import LocalGroup
    for s in (JAX, PORT):
        (ma, pa), (mb, pb) = tenant(s, ARCH, 0), tenant(s, SSM, 1)
        with pytest.raises(ValueError, match="online re-planning needs two "
                           "MoE models with equal expert counts"):
            s.m.ColocatedContinuousEngine(ma, mb, pa, pb, batch_slots=2,
                                          cache_cap=32, replan=forced(s))
        with pytest.raises(ValueError, match="online re-grouping needs MoE "
                           "tenants with equal expert counts"):
            s.m.MultiTenantContinuousEngine([ma, mb], [pa, pb],
                                            batch_slots=2, cache_cap=32,
                                            replan=forced(s))
        (mc, pc) = tenant(s, ARCH, 1)
        eng = s.m.MultiTenantContinuousEngine([ma, mc], [pa, pc],
                                              batch_slots=2, cache_cap=32,
                                              replan=forced(s))
        with pytest.raises(ValueError, match="online re-grouping needs MoE "
                           "tenants with equal expert counts"):
            eng.admit_tenant(mb, pb)

    (ma, pa), (mb, pb) = tenant(PORT, ARCH, 0), tenant(PORT, AUDIO, 1)
    prompts = np.ones((2, 4), np.int64)
    for build in (
            lambda: tserving.ColocatedEngine(ma, mb, pa, pb),
            lambda: tserving.ColocatedContinuousEngine(
                ma, mb, pa, pb, batch_slots=2, cache_cap=32),
            lambda: tserving.MultiTenantContinuousEngine(
                [ma, mb], [pa, pb], batch_slots=2, cache_cap=32)):
        with pytest.raises(ValueError, match="encoder-decoder"):
            build()
    eng = tserving.MultiTenantContinuousEngine(
        [ma, ma], [pa, pa], batch_slots=2, cache_cap=32)
    with pytest.raises(ValueError, match="encoder-decoder"):
        eng.admit_tenant(mb, pb)
    assert (eng.n_tenants, len(eng.models), len(eng.pools)) == (2, 2, 2)
    (mja, pja), (mjb, pjb) = tenant(JAX, ARCH, 0), tenant(JAX, AUDIO, 1)
    with pytest.raises(KeyError, match="frames"):
        JAX.m.ColocatedEngine(mja, mjb, pja, pjb).serve(
            prompts, prompts, max_new_tokens=2, cache_cap=8)

    ms, ps = tenant(PORT, SSM, 1)
    group = LocalGroup(2, "cpu")
    with pytest.raises(ValueError, match="no MoE layers"):
        tserving.DistributedColocatedEngine(ma, ms, pa, ps, batch_slots=2,
                                            cache_cap=32, group=group)
    with pytest.raises(ValueError, match="no MoE layers"):
        tserving.DistributedMultiTenantEngine([ma, ms], [pa, ps],
                                              batch_slots=2, cache_cap=32,
                                              group=group)


@pytest.mark.parametrize("mode", ["static", "continuous"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_colocates_a_family(capsys, arch, mode):
    """``--colocate-with`` a family serves beside phi3.5-MoE, static
    (``ColocatedEngine``) or continuous, with no pairing planned;
    ``--replan-interval`` refuses beside it."""
    from repro_torch.launch import serve
    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--kernels",
            "--colocate-with", arch, "--batch", "2", "--cache-cap", "32",
            "--num-requests", "2", "--max-new-tokens", "3"]
    stream = ["--arrival-rate", "0.5"] if mode == "continuous" else []
    assert serve.main(base + stream) == 0
    out = capsys.readouterr().out
    assert ("lockstep decode steps" if stream else "model B:") in out
    assert "aurora colocation pairing" not in out
    if stream:
        with pytest.raises(SystemExit, match="two MoE models"):
            serve.main(base + stream + ["--replan-interval", "2"])
