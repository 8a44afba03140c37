"""The port's hot-expert replication against the JAX reference, on the CPU.

Reduced phi3.5-MoE (2 layers, d 256, 4 experts, fp32); JAX params are
carried across by ``repro_torch.bridge``. Replicated and dereplicated
leaves, repairs and physical dispatch integers must be exactly equal to
JAX's; replicated dispatch must be byte-identical to the port's own
unreplicated dispatch and agree with JAX at the reference's fp32 kernel
tolerance (1e-5); engines that adopt replicas mid-stream must emit the JAX
engine's greedy streams; ``maybe_replicate`` must decide as the
reference's does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.kernels.ops as jops  # noqa: E402
import repro.kernels.ref as jref  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.errors import FaultError as JaxFaultError  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro.models.layers import KernelConfig as JaxKC  # noqa: E402
from repro.models.layers import ParallelContext  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.errors import FaultError, PlanError  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import KernelConfig, Model  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402

ARCH = "phi3.5-moe-42b-a6.6b"
TOL = 1e-5                      # tests/test_kernels.py::_tol, fp32


@pytest.fixture(scope="module")
def setup():
    cfg_j = jax_get_config(ARCH).reduced()
    params_j = JaxModel(cfg_j).init(jax.random.PRNGKey(0))
    return cfg_j, params_j, jax.tree.map(np.asarray, params_j)


def _layer(params_np, layer=0):
    """Layer ``layer``'s MoE dict as numpy (a standalone layer)."""
    return jax.tree.map(lambda a: a[layer], params_np["segments"][0][0]["moe"])


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flat(v)]
    return [tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)]


# -- the spec ---------------------------------------------------------------

@pytest.mark.parametrize("counts", [(2, 1, 3, 1), (1, 1, 1, 1), (4,),
                                    (1, 3, 1, 2, 2)])
def test_replication_spec_matches_jax(counts):
    want = jm.ReplicationSpec(counts=counts)
    got = tm.ReplicationSpec(counts=counts)
    for name in ("n_logical", "n_phys", "base", "phys_to_logical",
                 "is_identity"):
        assert getattr(got, name) == getattr(want, name), name
    assert ((tm.ReplicationSpec.from_counts(counts) is None)
            == (jm.ReplicationSpec.from_counts(counts) is None))
    base, reps = tm.replica_arrays(got, device="cpu")
    jb, jr = jm.replica_arrays(want)
    np.testing.assert_array_equal(base.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(reps.numpy(), np.asarray(jr))
    for bad in ((1, 0, 2), ()):
        with pytest.raises(ValueError):
            jm.ReplicationSpec(counts=bad)
        with pytest.raises(ValueError):
            tm.ReplicationSpec(counts=bad)


# -- functional widen / narrow ----------------------------------------------

@pytest.mark.parametrize("standalone", [False, True],
                         ids=["model_axis1", "layer_axis0"])
def test_replicate_dereplicate_bit_exact_vs_jax(setup, standalone):
    """Widened and narrowed leaves equal JAX's bit for bit; the caller's
    tree is not written and shares every non-expert leaf."""
    _, _, params_np = setup
    tree = _layer(params_np) if standalone else params_np
    axis = 0 if standalone else 1
    spec_j = jm.ReplicationSpec.from_counts((2, 1, 3, 1))
    spec_t = tm.ReplicationSpec.from_counts((2, 1, 3, 1))
    pt = bridge.to_torch(tree, device="cpu")
    before = [a.copy() for a in _flat(pt)]
    wide_j = jm.replicate_moe_params(jax.tree.map(jnp.asarray, tree), spec_j,
                                     axis=axis)
    wide_t = tm.replicate_moe_params(pt, spec_t, axis=axis)
    for a, b in zip(_flat(wide_t), jax.tree.leaves(wide_j)):
        np.testing.assert_array_equal(a, np.asarray(b))
    back_j = jm.dereplicate_moe_params(wide_j, spec_j, axis=axis)
    back_t = tm.dereplicate_moe_params(wide_t, spec_t, axis=axis)
    for a, b, c in zip(_flat(back_t), jax.tree.leaves(back_j), before):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, c)
    for a, c in zip(_flat(pt), before):            # caller's leaves intact
        np.testing.assert_array_equal(a, c)
    moe = (wide_t if standalone else wide_t["segments"][0][0]["moe"])
    src = (pt if standalone else pt["segments"][0][0]["moe"])
    assert moe["router"] is src["router"]


def test_relayout_equals_replicate_and_frees_slab_by_slab(setup):
    """The engine's re-layout (per-layer tensors) holds exactly the
    functional widening's values, from stacked leaves and from its own
    per-layer leaves; the stacked source is never written."""
    _, _, params_np = setup
    pt = bridge.to_torch(params_np, device="cpu")
    before = [a.copy() for a in _flat(pt)]
    s1 = tm.ReplicationSpec.from_counts((2, 1, 3, 1))
    s2 = tm.ReplicationSpec.from_counts((1, 2, 1, 2))
    n = 4

    def as_stacked(tree):
        return tm._map_experts(lambda leaf: torch.stack(leaf), tree)

    lay1 = tm.relayout_moe_params(pt, None, s1, n)
    assert all(isinstance(leaf, list) for leaf in tm.expert_leaves(lay1))
    for a, b in zip(_flat(as_stacked(lay1)),
                    _flat(tm.replicate_moe_params(pt, s1))):
        np.testing.assert_array_equal(a, b)
    own = tm.expert_leaves(lay1)[0]
    lay2 = tm.relayout_moe_params(lay1, s1, s2, n)
    assert tm.expert_leaves(lay2)[0] is own         # re-laid out in place
    for a, b in zip(_flat(as_stacked(lay2)),
                    _flat(tm.replicate_moe_params(pt, s2))):
        np.testing.assert_array_equal(a, b)
    lay3 = tm.relayout_moe_params(lay2, s2, None, n)
    for a, b in zip(_flat(as_stacked(lay3)), before):
        np.testing.assert_array_equal(a, b)
    for a, c in zip(_flat(pt), before):
        np.testing.assert_array_equal(a, c)


# -- shrink / repair --------------------------------------------------------

SHRINK_CASES = [
    ((2, 1, 1, 1), [0]),
    ((2, 1, 3, 1), [3, 4]),
    ((2, 1, 3, 1), [1, 2]),
    ((2, 1, 1, 1), [2]),            # expert 1's only copy
    ((2, 1, 3, 1), [7]),            # out of range
    (None, [0]),                    # nothing replicated
]


@pytest.mark.parametrize("counts,drop", SHRINK_CASES)
def test_shrink_replication_matches_jax(counts, drop):
    """Same survivor layout, or the same typed error, as the reference."""
    def run(mod, err):
        spec = None if counts is None else mod.ReplicationSpec(counts=counts)
        try:
            out = mod.shrink_replication(spec, drop)
        except err as e:
            return "error", str(e)
        return "ok", None if out is None else out.counts
    assert run(tm, FaultError) == run(jm, JaxFaultError)


@pytest.mark.parametrize("seed", range(4))
def test_repair_from_replica_bit_exact_vs_jax(setup, seed):
    """Corrupt one copy of a replicated expert (every layer, or one); the
    port's in-place repair gives JAX's repaired leaves bit for bit, which
    are the unpoisoned widened leaves."""
    from repro.serving.faults import corrupt_moe_params as jcorrupt
    _, params_j, params_np = setup
    rng = np.random.default_rng(seed)
    counts = [int(c) for c in rng.integers(1, 3, 4)]
    if max(counts) < 2:
        counts[int(rng.integers(4))] = 2
    e = int(rng.choice([i for i in range(4) if counts[i] >= 2]))
    spec_j = jm.ReplicationSpec.from_counts(counts)
    spec_t = tm.ReplicationSpec.from_counts(counts)
    phys = spec_j.base[e] + int(rng.integers(counts[e]))
    layer = None if seed % 2 == 0 else 1
    rep_j = jm.replicate_moe_params(params_j, spec_j)
    healed_j = jm.repair_moe_params(
        jcorrupt(rep_j, phys, layer=layer), spec_j, [phys])
    bad_t = tserving.faults.corrupt_moe_params(
        tm.replicate_moe_params(bridge.to_torch(params_np, device="cpu"), spec_t), phys,
        layer=layer)
    assert any(not np.isfinite(a).all() for a in _flat(bad_t))
    healed_t = tm.repair_moe_params(bad_t, spec_t, [phys])
    assert healed_t is bad_t                           # in place
    for a, b, c in zip(_flat(healed_t), jax.tree.leaves(healed_j),
                       jax.tree.leaves(rep_j)):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, np.asarray(c))


REPAIR_ERRORS = [
    (None, [0]),                    # unreplicated: no donor
    ((2, 1, 1, 1), [0, 1]),         # both copies of expert 0 corrupt
    ((2, 1, 1, 1), [9]),            # out of range
]


@pytest.mark.parametrize("counts,bad", REPAIR_ERRORS)
def test_repair_refuses_what_the_reference_refuses(setup, counts, bad):
    """The same typed ``FaultError`` as the reference, and nothing written
    before it is raised."""
    _, params_j, params_np = setup

    def spec(mod):
        return None if counts is None else mod.ReplicationSpec(counts=counts)
    pj = (params_j if counts is None
          else jm.replicate_moe_params(params_j, spec(jm)))
    with pytest.raises(JaxFaultError) as ej:
        jm.repair_moe_params(pj, spec(jm), bad)
    pt = bridge.to_torch(jax.tree.map(np.asarray, pj), device="cpu")
    before = [a.copy() for a in _flat(pt)]
    with pytest.raises(FaultError) as et:
        tm.repair_moe_params(pt, spec(tm), bad)
    assert str(et.value) == str(ej.value)
    for a, c in zip(_flat(pt), before):
        np.testing.assert_array_equal(a, c)


# -- dispatch ---------------------------------------------------------------

def _inputs(t, hot):
    """(t, 256) fp32 tokens; with ``hot`` all entries positive, so the
    biased router of ``_layer_params`` sends every token to expert 0."""
    x = np.random.default_rng(t).standard_normal((t, 256)).astype(np.float32)
    return np.abs(x) if hot else x


def _layer_params(params_np, hot):
    """Layer 0's MoE params; ``hot`` biases the router so every token of
    ``_inputs(t, hot=True)`` picks expert 0, whose group then overflows
    the capacity (drops)."""
    p = _layer(params_np)
    if hot:
        p = dict(p)
        router = p["router"].copy()
        router[:, 0] += 0.03              # ~+6 logits over |x|: no ties below
        p["router"] = router
    return p


CASES = [(3, False), (16, False), (32, True)]


@pytest.mark.parametrize("kernels", [False, True], ids=["dense", "kernel"])
@pytest.mark.parametrize("t,hot", CASES, ids=["t3", "t16", "t32_drops"])
def test_physical_dispatch_integers_match_jax(setup, monkeypatch, kernels, t,
                                              hot):
    """The physical buckets handed to the expert FFN (their rows: which
    token sits in which (slot, position)) and, on the kernel route, the
    physical group sizes equal JAX's exactly."""
    _, _, params_np = setup
    p_np = _layer_params(params_np, hot)
    x = _inputs(t, hot)
    moe = get_config(ARCH).reduced().moe
    spec_j = jm.ReplicationSpec.from_counts((2, 1, 3, 1))
    spec_t = tm.ReplicationSpec.from_counts((2, 1, 3, 1))
    seen = {}
    if kernels:
        def cap_j(buf, *w, group_sizes=None, **kw):
            seen["j"] = (np.asarray(buf), np.asarray(group_sizes))
            return jref.moe_ffn_ref(buf, *w, group_sizes=group_sizes)

        def cap_t(buf, *w, group_sizes=None, **kw):
            seen["t"] = (buf.numpy().copy(), group_sizes.numpy().copy())
            return tops.moe_gmm(buf, *w, group_sizes=group_sizes, **kw)
        monkeypatch.setattr(jops, "moe_ffn", cap_j)
        monkeypatch.setattr(tops, "moe_ffn", cap_t)
        pc = ParallelContext(moe_impl="kernel",
                             kernels=JaxKC(interpret=True, block_c=8),
                             moe_replication=spec_j)
        kc = KernelConfig(block_c=8)
    else:
        real_j, real_t = jm._experts_ffn, tm._experts_ffn

        def cap_j(experts, buf, act):
            seen["j"] = (np.asarray(buf), None)
            return real_j(experts, buf, act)

        def cap_t(experts, buf, act):
            seen["t"] = (buf.numpy().copy(), None)
            return real_t(experts, buf, act)
        monkeypatch.setattr(jm, "_experts_ffn", cap_j)
        monkeypatch.setattr(tm, "_experts_ffn", cap_t)
        pc = ParallelContext(moe_replication=spec_j)
        kc = None
    pj = jm.replicate_moe_params(jax.tree.map(jnp.asarray, p_np), spec_j,
                                 axis=0)
    pt = tm.replicate_moe_params(bridge.to_torch(p_np, device="cpu"), spec_t, axis=0)
    jm.moe_apply(pj, jnp.asarray(x), moe, "swiglu", pc)
    tm.moe_apply(pt, torch.from_numpy(x), moe, "swiglu", kc,
                 replication=spec_t)
    np.testing.assert_array_equal(seen["t"][0], seen["j"][0])
    if kernels:
        np.testing.assert_array_equal(seen["t"][1], seen["j"][1])
        assert seen["t"][0].shape[0] == spec_t.n_phys
    if hot:                                        # the case drops tokens
        gates, idx, _ = tm.route(torch.from_numpy(p_np["router"]),
                                 torch.from_numpy(x), moe)
        cap = tm.capacity(t, moe.top_k, moe.n_experts, moe.capacity_factor)
        _, keep = tm.dispatch_indices(idx, moe.n_experts, cap)
        assert not bool(keep.all())


@pytest.mark.parametrize("kernels", [False, True], ids=["dense", "kernel"])
@pytest.mark.parametrize("t,hot", CASES, ids=["t3", "t16", "t32_drops"])
def test_moe_apply_replication_identity(setup, kernels, t, hot):
    """Replicated dispatch is byte-identical to the port's unreplicated
    dispatch (outputs, aux loss and logical counts) and agrees with JAX's
    replicated layer at 1e-5."""
    _, _, params_np = setup
    p_np = _layer_params(params_np, hot)
    x = _inputs(t, hot)
    moe = get_config(ARCH).reduced().moe
    spec_t = tm.ReplicationSpec.from_counts((2, 1, 3, 1))
    spec_j = jm.ReplicationSpec.from_counts((2, 1, 3, 1))
    kc = KernelConfig(block_c=8) if kernels else None
    pt = bridge.to_torch(p_np, device="cpu")
    y, aux, c = tm.moe_apply(pt, torch.from_numpy(x), moe, "swiglu", kc,
                             return_counts=True)
    y_r, aux_r, c_r = tm.moe_apply(
        tm.replicate_moe_params(pt, spec_t, axis=0), torch.from_numpy(x),
        moe, "swiglu", kc, return_counts=True, replication=spec_t)
    np.testing.assert_array_equal(y_r.numpy(), y.numpy())
    assert float(aux_r) == float(aux)
    assert c_r.shape == c.shape and c.shape[-1] == moe.n_experts
    np.testing.assert_array_equal(c_r.numpy(), c.numpy())
    pc = (ParallelContext(moe_impl="kernel", kernels=JaxKC(block_c=8),
                          moe_replication=spec_j) if kernels
          else ParallelContext(moe_replication=spec_j))
    y_j, aux_j, c_j = jm.moe_apply(
        jm.replicate_moe_params(jax.tree.map(jnp.asarray, p_np), spec_j,
                                axis=0), jnp.asarray(x), moe, "swiglu", pc,
        return_counts=True)
    np.testing.assert_allclose(y_r.numpy(), np.asarray(y_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux_r), float(aux_j), rtol=TOL)
    np.testing.assert_array_equal(c_r.numpy(), np.asarray(c_j))


# -- engines ----------------------------------------------------------------

def _requests(m, vocab, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [m.Request(prompt=[int(v) for v in rng.integers(1, vocab, 6)],
                      max_new_tokens=5, arrival=float(i)) for i in range(n)]


@pytest.mark.parametrize("kernels", [False, True], ids=["dense", "kernel"])
def test_engine_adopt_replication_matches_jax(setup, kernels):
    """Adopting a replication mid-stream (host-map form), moving to another
    (counts form) and dropping back to unreplicated serving changes no
    token: the streams equal the JAX engine's under the same schedule and
    the port's own never-replicated run; the caller's params are never
    written."""
    cfg_j, params_j, params_np = setup
    schedule = {3: [(0, 1), (1,), (2,), (3, 0)], 5: (1, 2, 1, 2), 7: None}

    def serve(m, eng, adopt):
        for r in _requests(m, cfg_j.vocab):
            eng.submit(r)
        reqs, step = list(eng.queue), 0
        while eng.step():
            step += 1
            if adopt and step in schedule:
                eng.adopt_replication(schedule[step])
        return [list(map(int, r.out_tokens)) for r in reqs]

    eng_j = jserving.ContinuousEngine(
        JaxModel(cfg_j), params_j, 2, 32,
        config=jserving.EngineConfig(kernels=kernels))
    want = serve(jserving, eng_j, True)
    model = Model(get_config(ARCH).reduced(), device="cpu")
    pt = bridge.to_torch(params_np, device="cpu")
    before = [a.copy() for a in _flat(pt)]
    plain = serve(tserving, tserving.ContinuousEngine(
        model, pt, 2, 32, config=tserving.EngineConfig(kernels=kernels)),
        False)
    eng_t = tserving.ContinuousEngine(
        model, pt, 2, 32, config=tserving.EngineConfig(kernels=kernels))
    got = serve(tserving, eng_t, True)
    assert all(want) and got == want and plain == want
    assert eng_t.model.replication is None
    for a, c in zip(_flat(pt), before):
        np.testing.assert_array_equal(a, c)


def test_adopt_forms_idempotence_and_assignment_guard(setup):
    """``adopt_replication`` takes bare counts and host maps and is
    idempotent; the identity map is None; ``adopt`` takes a replicated
    ``Plan``, a bare sequence and None; re-assignment is refused while
    replicas are live, as in the reference."""
    cfg_j, params_j, params_np = setup
    model = Model(get_config(ARCH).reduced(), device="cpu")
    eng = tserving.ContinuousEngine(
        model, bridge.to_torch(params_np, device="cpu"), 1, 16)
    jeng = jserving.ContinuousEngine(JaxModel(cfg_j), params_j, 1, 16)
    for e in (eng, jeng):
        e.adopt_replication((2, 1, 1, 1))
    assert eng.model.replication.counts == (2, 1, 1, 1)
    assert (jeng.model.pc.moe_replication.counts
            == eng.model.replication.counts)
    wide = eng.params
    eng.adopt_replication([(0, 3), (1,), (2,), (3,)])      # same counts
    assert eng.params is wide
    with pytest.raises(PlanError):
        eng.adopt_assignment([1, 0, 2, 3])
    with pytest.raises(jcore.errors.PlanError):
        jeng.adopt_assignment([1, 0, 2, 3])
    eng.adopt_replication((1, 1, 1, 1))
    assert eng.model.replication is None
    trace = tcore.trace_from_counts(
        "skew", np.array([[20.0, 1, 1, 1], [20.0, 1, 1, 1]]),
        tokens_per_device=256.0)
    plan = tcore.AuroraPlanner(tcore.homogeneous_cluster(4)).plan_replicated(
        trace, tolerance=0.1)
    assert plan.replication is not None
    eng.adopt(plan)
    assert eng.model.replication.counts == tuple(
        len(h) for h in plan.replication)
    eng.adopt([1, 3, 1, 1])
    assert eng.model.replication.counts == (1, 3, 1, 1)
    eng.adopt(None)
    assert eng.model.replication is None
    eng.adopt_assignment([1, 0, 2, 3])                     # allowed again
    assert eng.assignment == [1, 0, 2, 3]


# -- online re-replication --------------------------------------------------

def _observe(mons, l0, l1, reps=1):
    """Feed both monitors batches whose layer-0 slots route to ``l0`` and
    layer-1 slots to ``l1`` (one token each)."""
    stats = np.zeros((2, len(l0), mons[0].n_experts))
    for s, e in enumerate(l0):
        stats[0, s, e] = 1.0
    for s, e in enumerate(l1):
        stats[1, s, e] = 1.0
    for _ in range(reps):
        for m in mons:
            m.observe(stats)


def _events(rp):
    return [(e.step, e.stale_time, e.candidate_time, e.applied,
             e.baseline_time, e.replication) for e in rp.events]


def _both(n, halflife, **kw):
    mons = (jserving.TrafficMonitor(n_experts=n, n_layers=2,
                                    halflife=halflife),
            tserving.TrafficMonitor(n_experts=n, n_layers=2,
                                    halflife=halflife))
    rps = (jserving.OnlineReplanner(
        jcore.AuroraPlanner(jcore.homogeneous_cluster(n)), **kw),
        tserving.OnlineReplanner(
            tcore.AuroraPlanner(tcore.homogeneous_cluster(n)), **kw))
    return mons, rps


def _decide(mons, rps, step, current=None):
    out = [rp.maybe_replicate(step, m, current) for m, rp in zip(mons, rps)]
    assert (out[0] is None) == (out[1] is None)
    if out[0] is not None:
        assert out[1].replication == out[0].replication
    assert _events(rps[1]) == _events(rps[0])
    return out[1]


def test_maybe_replicate_applies_and_hysteresis_match_jax():
    mons, rps = _both(8, 8.0, interval=4, threshold=0.0, warmup=2)
    _observe(mons, [0] * 6 + [1, 2], [0] * 6 + [3, 4], reps=12)
    assert _decide(mons, rps, 2) is None                 # off-interval
    plan = _decide(mons, rps, 4)
    assert plan is not None and len(plan.replication[0]) > 1
    assert rps[1].events[-1].applied
    assert _decide(mons, rps, 8, plan.replication) is None
    assert not rps[1].events[-1].applied


def test_maybe_replicate_warmup_and_baseline_match_jax():
    ident = tcore.identity_replication(8)
    mons, rps = _both(8, 128.0, interval=2, threshold=0.0, warmup=50,
                      baseline_replication=ident)
    _observe(mons, [0] * 8, [0] * 8, reps=3)
    assert _decide(mons, rps, 2) is None                 # still warming up
    assert list(rps[1].events) == []
    _observe(mons, [0] * 8, [0] * 8, reps=50)
    assert _decide(mons, rps, 4) is not None
    assert rps[1].events[-1].baseline_time is not None


def test_maybe_replicate_predictive_matches_jax():
    mons, rps = _both(8, 32.0, interval=1, threshold=-1e9, warmup=1,
                      predictive=True)
    _observe(mons, list(range(8)), list(range(8)), reps=30)
    _observe(mons, [5] * 8, [5] * 8, reps=6)             # drift toward e5
    plan = _decide(mons, rps, 1)
    assert plan is not None
    assert len(plan.replication[5]) >= max(
        len(h) for e, h in enumerate(plan.replication) if e != 5)
