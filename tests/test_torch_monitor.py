"""The port's live routing stats, ``TrafficMonitor`` and ``OnlineReplanner``
against the JAX reference, on the CPU.

Reduced phi3.5-MoE (2 layers, d 256, 4 experts, fp32), weights carried
across by ``repro_torch.bridge``. Routing counts are integers and must be
exactly equal; monitor rates, traces and re-plan decisions are computed
in numpy on both sides from the same counts and must be exactly equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro.models.layers import KernelConfig as JaxKC  # noqa: E402
from repro.models.layers import ParallelContext  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import KernelConfig, Model  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402

ARCH = "phi3.5-moe-42b-a6.6b"


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    cfg_j = jax_get_config(ARCH).reduced()
    params_j = JaxModel(cfg_j).init(jax.random.PRNGKey(0))
    return cfg_j, params_j, bridge.to_torch(jax.tree.map(np.asarray,
                                                         params_j))


@pytest.mark.parametrize("kernels", [False, True], ids=["dense", "kernel"])
@pytest.mark.parametrize("t", [3, 33])
def test_routed_counts_and_return_counts(setup, t, kernels):
    """``return_counts`` appends the (..., E) routed-choice histogram of the
    routing ``idx``, equal to JAX's on both routes; the layer's output is
    the same as without it."""
    cfg_j, params_j, params_t = setup
    pj = jax.tree.map(lambda a: a[0], params_j["segments"][0][0]["moe"])
    pt = bridge.map_tree(lambda a: a[0], params_t["segments"][0][0]["moe"])
    moe = get_config(ARCH).reduced().moe
    x = np.random.default_rng(t).standard_normal((1, t, 256)).astype(
        np.float32)
    if kernels:
        pc = ParallelContext(moe_impl="kernel", kernels=JaxKC(block_c=8))
        _, _, want = jm.moe_apply_kernel(pj, jnp.asarray(x), cfg_j.moe,
                                         cfg_j.act, pc, return_counts=True)
    else:
        _, _, want = jm.moe_apply_dense(pj, jnp.asarray(x), cfg_j.moe,
                                        cfg_j.act, return_counts=True)
    kc = KernelConfig(block_c=8) if kernels else None
    y, aux, counts = tm.moe_apply(pt, _t(x), moe, "swiglu", kc,
                                  return_counts=True)
    y0, aux0 = tm.moe_apply(pt, _t(x), moe, "swiglu", kc)
    assert counts.shape == (1, t, moe.n_experts)
    assert counts.dtype == torch.float32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want))
    assert torch.equal(y, y0) and torch.equal(aux, aux0)
    _, idx, _ = tm.route(pt["router"], _t(x[0]), moe)
    np.testing.assert_array_equal(
        tm.routed_counts(idx, moe.n_experts).numpy(),
        np.asarray(jm.routed_counts(jnp.asarray(idx.numpy()),
                                    moe.n_experts)))
    assert (counts.sum(-1) == moe.top_k).all()


@pytest.mark.parametrize("kernels", [False, True], ids=["dense", "kernel"])
def test_model_stats_equal_jax(setup, kernels):
    """``prefill_slot``, ``prefill_chunk_slot`` (first and continuation)
    and ``decode_step_stats`` return the reference's (n_moe_layers, ...)
    counts in its layer order, and the same logits as the plain calls."""
    cfg_j, params_j, params_t = setup
    mj, mt = JaxModel(cfg_j), Model(get_config(ARCH).reduced(), device="cpu")
    if kernels:
        mj, mt = mj.with_kernels(), mt.with_kernels()
    assert mt.n_moe_layers == mj.n_moe_layers == 2
    rng = np.random.default_rng(3)
    cap = 32
    cache_j = mj.init_cache(3, cap, per_slot_len=True)
    cache_t = mt.init_cache(3, cap, per_slot_len=True)
    for slot, n in ((0, 7), (1, 5)):
        toks = rng.integers(1, 500, (1, n))
        _, cache_j, sj = mj.prefill_slot(params_j, {"tokens": jnp.asarray(
            toks)}, cache_j, slot, cap=cap, collect_moe_stats=True)
        _, cache_t, st = mt.prefill_slot(params_t, {"tokens": _t(toks)},
                                         cache_t, slot, cap=cap,
                                         collect_moe_stats=True)
        assert st.shape == (2, 1, n, 4)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    prompt = rng.integers(1, 500, (1, 9))
    for first, sl in ((True, slice(0, 4)), (False, slice(4, 9))):
        _, cache_j, sj = mj.prefill_chunk_slot(
            params_j, {"tokens": jnp.asarray(prompt[:, sl])}, cache_j, 2,
            first=first, cap=cap, collect_moe_stats=True)
        _, cache_t, st = mt.prefill_chunk_slot(
            params_t, {"tokens": _t(prompt[:, sl])}, cache_t, 2, first=first,
            cap=cap, collect_moe_stats=True)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    tok = rng.integers(1, 500, (3, 1))
    mask = np.array([True, False, True])
    lj, cache_j, sj = mj.decode_step_stats(params_j, jnp.asarray(tok),
                                           cache_j, jnp.asarray(mask))
    plain, _ = mt.decode_step(params_t, _t(tok), bridge.map_tree(
        torch.clone, cache_t), _t(mask))
    lt, cache_t, st = mt.decode_step_stats(params_t, _t(tok), cache_t,
                                           _t(mask))
    assert st.shape == (2, 3, 4)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert torch.equal(lt, plain)
    np.testing.assert_array_equal(cache_t["len"].numpy(),
                                  np.asarray(cache_j["len"]))


def _counts(rng, n_layers=2, b=3, e=4):
    return rng.integers(0, 3, (n_layers, b, e)).astype(np.float32)


def _monitor_pair(**kw):
    return (jserving.TrafficMonitor(4, 2, **kw),
            tserving.TrafficMonitor(4, 2, **kw))


def _same_monitor(mj, mt):
    for name in ("counts", "fast_counts", "affinity", "rates",
                 "fast_rates"):
        np.testing.assert_array_equal(getattr(mt, name), getattr(mj, name))
    np.testing.assert_array_equal(mt.predicted_rates(), mj.predicted_rates())
    assert (mt.weight, mt.observations) == (mj.weight, mj.observations)
    for a, b in ((mj.trace(), mt.trace()),
                 (mj.predicted_trace(512.0, gate=0.1),
                  mt.predicted_trace(512.0, gate=0.1))):
        assert a.name == b.name
        for la, lb in zip(a.layers, b.layers):
            np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("frame", ["identity", "permuted"])
def test_traffic_monitor_equal(frame):
    """EWMA, masks, the slot->expert translation, the fast EWMA, the
    affinity prediction and the traces, over the same observations."""
    mj, mt = _monitor_pair(halflife=6.0, name="live")
    if frame == "permuted":
        mj.slot_to_expert = mt.slot_to_expert = [2, 0, 3, 1]
    rng = np.random.default_rng(0)
    for step in range(9):
        stats = _counts(rng)
        mask = rng.random(3) < 0.7 if step % 2 else None
        mj.observe(stats, mask)
        mt.observe(stats, mask)
        _same_monitor(mj, mt)
    with pytest.raises(ValueError):
        mt.slot_to_expert = [0, 0, 1, 2]
    with pytest.raises(ValueError):
        mt.observe(np.zeros((3, 2, 4)))


def _fed(n_monitors, seed, skew=None):
    """Pairs of monitors (JAX, port) fed the same skewed counts."""
    rng = np.random.default_rng(seed)
    pairs = [_monitor_pair(name=f"m{i}") for i in range(n_monitors)]
    for _ in range(5):
        for i, (mj, mt) in enumerate(pairs):
            stats = _counts(rng)
            if skew is not None:
                stats[..., skew[i]] += 3.0
            mj.observe(stats)
            mt.observe(stats)
    return pairs


def _events(rp):
    return [(e.step, e.stale_time, e.candidate_time, list(e.pair), e.applied,
             e.baseline_time,
             None if e.groups is None else [tuple(g) for g in e.groups],
             None if e.assignment is None else tuple(e.assignment))
            for e in rp.events]


def _replanners(cluster, **kw):
    return (jserving.OnlineReplanner(jcore.AuroraPlanner(getattr(
                jcore, cluster)(4)), **kw),
            tserving.OnlineReplanner(tcore.AuroraPlanner(getattr(
                tcore, cluster)(4)), **kw))


@pytest.mark.parametrize("threshold", [0.0, 0.5], ids=["adopt", "hysteresis"])
def test_maybe_replan_equal(threshold):
    """Same decisions, events and plans; off-interval and warm-up steps
    decide nothing; a high threshold keeps the current pairing."""
    (a_j, a_t), (b_j, b_t) = _fed(2, 1, skew=[0, 1])
    rj, rt = _replanners("homogeneous_cluster", interval=4,
                         threshold=threshold, warmup=3,
                         baseline_pair=[3, 2, 1, 0])
    pair = [0, 1, 2, 3]
    for step in (0, 3, 4, 8):
        pj = rj.maybe_replan(step, a_j, b_j, pair)
        pt = rt.maybe_replan(step, a_t, b_t, pair)
        assert (pj is None) == (pt is None)
        if pt is not None:
            assert list(pt.pair) == list(pj.pair)
            pair = list(pt.pair)
    assert _events(rt) == _events(rj)
    assert [e.step for e in rt.events] == [4, 8]
    if threshold > 0.4:
        assert not any(e.applied for e in rt.events)
    late = tserving.OnlineReplanner(rt.planner, interval=4, warmup=99)
    assert late.maybe_replan(4, a_t, b_t, pair) is None and not late.events


@pytest.mark.parametrize("threshold", [0.0, 0.5], ids=["adopt", "hysteresis"])
def test_maybe_reassign_heterogeneous_equal(threshold):
    (m_j, m_t), = _fed(1, 2, skew=[3])
    rj, rt = _replanners("heterogeneous_cluster", interval=2,
                         threshold=threshold, warmup=1,
                         baseline_assignment=[3, 2, 1, 0])
    cur = [0, 1, 2, 3]
    for step in (2, 4):
        pj = rj.maybe_reassign(step, m_j, cur)
        pt = rt.maybe_reassign(step, m_t, cur)
        assert (pj is None) == (pt is None)
        if pt is not None:
            np.testing.assert_array_equal(pt.expert_to_device,
                                          pj.expert_to_device)
            cur = [int(d) for d in pt.expert_to_device]
    assert _events(rt) == _events(rj)
    assert all(e.assignment is not None for e in rt.events)


@pytest.mark.parametrize("cluster", ["homogeneous_cluster",
                                     "heterogeneous_cluster"])
@pytest.mark.parametrize("threshold", [0.0, 0.5], ids=["adopt", "hysteresis"])
def test_maybe_regroup_equal(cluster, threshold):
    """Three tenants; on a heterogeneous cluster the re-matched groups come
    back as an identity-assignment plan, as in the reference."""
    pairs = _fed(3, 3, skew=[0, 2, 1])
    rj, rt = _replanners(cluster, interval=2, threshold=threshold, warmup=1,
                         baseline_groups=[(g, g, g) for g in range(4)])
    groups = [(g, g, g) for g in range(4)]
    for step in (2, 4):
        pj = rj.maybe_regroup(step, [p[0] for p in pairs], groups)
        pt = rt.maybe_regroup(step, [p[1] for p in pairs], groups)
        assert (pj is None) == (pt is None)
        if pt is not None:
            assert [tuple(g) for g in pt.groups] == [tuple(g) for g in
                                                     pj.groups]
            np.testing.assert_array_equal(pt.expert_to_device, np.arange(4))
            groups = [tuple(g) for g in pt.groups]
    assert _events(rt) == _events(rj)


def _engine_stream(m, seed=5):
    rng = np.random.default_rng(seed)
    reqs = []
    for t in (0.0, 0.0, 1.0, 2.0, 2.0, 4.0):
        n = int(rng.integers(3, 11))
        reqs.append(m.Request(prompt=[int(x) for x in rng.integers(1, 500, n)],
                              max_new_tokens=int(rng.integers(2, 6)),
                              arrival=t))
    return reqs


@pytest.mark.parametrize("config", [
    {}, {"prefill_chunk": 4}, {"prefill_chunk": 4, "prefill_pool": 3,
                               "step_token_budget": 9}],
    ids=["one_shot", "chunked", "pool"])
def test_engine_monitor_equals_jax(setup, config):
    """A monitored ``ContinuousEngine`` (kernels on) ends with the JAX
    engine's monitor state: the prefill counts drop the same left-pad
    positions, chunk by chunk, and the decode counts mask vacant slots."""
    cfg_j, params_j, params_t = setup
    mon_j = jserving.TrafficMonitor(4, 2, halflife=8.0)
    mon_t = tserving.TrafficMonitor(4, 2, halflife=8.0)
    eng_j = jserving.ContinuousEngine(
        JaxModel(cfg_j), params_j, batch_slots=3, cache_cap=32,
        config=jserving.EngineConfig(kernels=True, **config), monitor=mon_j)
    eng_t = tserving.ContinuousEngine(
        Model(get_config(ARCH).reduced(), device="cpu"), params_t,
        batch_slots=3, cache_cap=32,
        config=tserving.EngineConfig(kernels=True, **config), monitor=mon_t)
    want = eng_j.serve(_engine_stream(jserving))
    got = eng_t.serve(_engine_stream(tserving))
    assert [r.out_tokens for r in got] == [list(map(int, r.out_tokens))
                                           for r in want]
    _same_monitor(mon_j, mon_t)
    assert mon_t.observations > eng_t.decode_steps
