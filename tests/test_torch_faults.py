"""The port's fault tolerance against the JAX reference, on the CPU: the
``HealthMonitor`` detectors, ``FaultPlan``, weight corruption, the
engine's ``checkpoint``/``restore``/``requeue`` and the ``ChaosHarness``
recovery loop.

Reduced phi3.5-MoE (2 layers, d 256, 4 experts, fp32), JAX params carried
across by ``repro_torch.bridge``; every port engine gets its own tensors
(corruption writes the engine's leaves in place). Detectors fed the same
signals emit the same events; a chaos run's streams equal the never-faulted
run's and the JAX ``ChaosHarness``'s, and its ``nan`` and ``device_loss``
recoveries equal the reference's (straggler detection rests on wall time,
so ``observed`` entries are not compared).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.errors import FaultError  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402

ARCH = "phi3.5-moe-42b-a6.6b"


@pytest.fixture(scope="module")
def setup():
    cfg_j = jax_get_config(ARCH).reduced()
    params_j = JaxModel(cfg_j).init(jax.random.PRNGKey(0))
    model = Model(get_config(ARCH).reduced(), device="cpu")
    return cfg_j, params_j, jax.tree.map(np.asarray, params_j), model


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flat(v)]
    return [tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)]


def _events(mon):
    return [(e.kind, e.step, e.device, e.detail) for e in mon.events]


# -- HealthMonitor detectors ------------------------------------------------

def _heartbeats(mod):
    mon = mod.HealthMonitor(n_devices=3, heartbeat_timeout=2)
    for step in range(2):
        for d in range(3):
            mon.heartbeat(d, step)
        assert mon.check(step) == []
    for step in range(2, 6):                  # device 1 goes silent
        mon.heartbeat(0, step)
        mon.heartbeat(2, step)
        mon.check(step)
    return mon


def _stragglers(mod):
    mon = mod.HealthMonitor(n_devices=2, halflife=2.0, straggler_ratio=2.0,
                            min_observations=2)
    for lo, hi, slow in ((0, 4, 10.0), (4, 16, 1.0), (16, 24, 10.0)):
        for step in range(lo, hi):
            mon.observe_step_time(0, 1.0)
            mon.observe_step_time(1, slow)
            mon.check(step)
    return mon


def _warmup(mod):
    mon = mod.HealthMonitor(n_devices=2, min_observations=4, halflife=8.0,
                            straggler_ratio=3.0)
    warming = [mon.warming_devices]
    for dt in (0.3, 0.1, 0.1, 0.1):          # slow cold start, then steady
        mon.observe_step_time(0, dt)
        mon.observe_step_time(1, 0.1)
    warming.append(mon.warming_devices)
    for d in range(2):
        mon.heartbeat(d, 4)
    mon.check(4)
    for _ in range(3):
        mon.observe_step_time(0, 10.0)
        mon.observe_step_time(1, 0.1)
        mon.check(5)
    mon.warming = warming
    return mon


@pytest.mark.parametrize("feed", [_heartbeats, _stragglers, _warmup],
                         ids=["heartbeat_loss", "straggler_rearm",
                              "ewma_warmup"])
def test_health_detectors_match_jax(feed):
    """The same signal feed gives the same events, lost devices, EWMA step
    times and warm-up state as the reference's monitor."""
    want, got = feed(jserving), feed(tserving)
    assert _events(got) == _events(want) and _events(got)
    assert got.lost_devices == want.lost_devices
    np.testing.assert_array_equal(got.step_times(), want.step_times())
    assert got.warming_devices == want.warming_devices
    assert getattr(got, "warming", None) == getattr(want, "warming", None)


def test_nan_guard_screens_tensors_dedups_and_drains():
    """A NaN or inf in any floating tensor of the outputs (integer leaves
    skipped, any float dtype) gives one "nan" event per step, as the
    reference."""
    mons = (jserving.HealthMonitor(), tserving.HealthMonitor())
    feeds = [
        ({"x": torch.zeros(3), "len": torch.tensor([7])}, 0),
        ({"x": torch.tensor([1.0, float("nan")])}, 1),
        ((torch.tensor([float("inf")]), torch.zeros(2)), 1),
        ({"x": torch.tensor([float("nan")], dtype=torch.float64)}, 2),
        ([torch.ones(2, dtype=torch.bfloat16), {"y": torch.zeros(1)}], 3),
    ]
    for out, step in feeds:
        jout = bridge.map_tree(
            lambda t: (t.float() if t.is_floating_point() else t).numpy()
            if torch.is_tensor(t) else t, out)
        assert (mons[1].observe_output(out, step)
                == mons[0].observe_output(jout, step))
    assert _events(mons[1]) == _events(mons[0])
    assert [e.step for e in mons[1].drain()] == [1, 2]
    assert mons[1].drain() == []
    assert len(mons[1].events) == 2


@pytest.mark.parametrize("kw", [dict(n_devices=0), dict(straggler_ratio=1.0),
                                dict(heartbeat_timeout=0),
                                dict(halflife=0.0)])
def test_monitor_rejects_degenerate_config(kw):
    with pytest.raises(ValueError):
        jserving.HealthMonitor(**kw)
    with pytest.raises(ValueError):
        tserving.HealthMonitor(**kw)


def test_synthetic_straggler_reaches_detector():
    """The injector inflates the reported step time (nothing sleeps); the
    EWMA path flags the device."""
    plan = tserving.FaultPlan((tserving.Straggler(step=0, device=1,
                                                  factor=10.0, duration=32),))
    inj = tserving.FaultInjector(
        plan, n_devices=2,
        health=tserving.HealthMonitor(n_devices=2, halflife=2.0,
                                      straggler_ratio=3.0,
                                      min_observations=2))
    fn = inj.wrap(lambda: torch.zeros(4))
    for _ in range(6):
        inj.tick()
        fn()
        inj.health.check(inj.step - 1)
    assert any(e.kind == "straggler" and e.device == 1
               for e in inj.health.events)


# -- FaultPlan ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 42, 123, 2024, 9999])
def test_random_plan_equals_reference(seed):
    kw = dict(horizon=16, n_devices=4, n_experts=8, n_faults=5)
    want = jserving.FaultPlan.random(seed, **kw)
    got = tserving.FaultPlan.random(seed, **kw)
    assert [(type(f).__name__, dataclasses.astuple(f)) for f in got.faults] \
        == [(type(f).__name__, dataclasses.astuple(f)) for f in want.faults]
    assert got.name == want.name and got.horizon() == want.horizon()
    assert got.has_corruption == want.has_corruption
    assert got == tserving.FaultPlan.random(seed, **kw)
    lost = {f.device for f in got.faults
            if isinstance(f, tserving.DeviceLoss)}
    assert len(lost) <= 3


def test_plan_at_and_corruption_flag():
    plan = tserving.FaultPlan((tserving.DeviceLoss(step=2, device=0),
                               tserving.ExpertCorruption(step=2, expert=1),
                               tserving.Straggler(step=5, device=1)))
    assert len(plan.at(2)) == 2 and len(plan.at(3)) == 0
    assert plan.has_corruption and plan.horizon() == 5 + 32
    assert not tserving.FaultPlan(
        (tserving.DeviceLoss(step=1, device=0),)).has_corruption


@pytest.mark.parametrize("layer", [None, 1])
def test_corrupt_in_place_matches_jax(setup, layer):
    _, params_j, params_np, _ = setup
    want = jfaults.corrupt_moe_params(params_j, 2, layer=layer)
    pt = bridge.to_torch(params_np)
    got = tfaults.corrupt_moe_params(pt, 2, layer=layer)
    assert got is pt
    for a, b in zip(_flat(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


# -- engine primitives --------------------------------------------------------

def _stream(m, vocab, n=4, max_new=3, prompt_len=4, seed=123):
    rng = np.random.default_rng(seed)
    return [m.Request(prompt=[int(x) for x in
                              rng.integers(1, vocab, prompt_len)],
                      max_new_tokens=max_new, arrival=float(i))
            for i in range(n)]


def _engine(setup, kernels=True, **kw):
    _, _, params_np, model = setup
    return tserving.ContinuousEngine(
        model, bridge.to_torch(params_np), 2, 32,
        config=tserving.EngineConfig(prefill_len=4, kernels=kernels, **kw))


@pytest.mark.parametrize("pool", [False, True], ids=["one_shot", "pool2"])
def test_checkpoint_restore_undoes_in_place_step(setup, pool):
    """``checkpoint`` -> step -> ``restore`` gives back the pre-step cache,
    token buffer, slots, queue and emitted tokens exactly, though the step
    wrote the cache in place; a second restore from the same snapshot does
    the same, and the re-run step equals the first run."""
    cfg_j = setup[0]
    kw = dict(prefill_chunk=2, prefill_pool=2) if pool else {}
    eng = _engine(setup, **kw)
    for r in _stream(tserving, cfg_j.vocab):
        eng.submit(r)
    for _ in range(3):
        eng.step()
    before = ([a.copy() for a in _flat(eng.cache)], eng.tokens.clone(),
              list(eng.slots), list(eng.queue),
              [list(r.out_tokens) for r in eng.slots if r is not None])
    snap = eng.checkpoint()
    eng.step()
    after = [a.copy() for a in _flat(eng.cache)]
    assert any((a != b).any() for a, b in zip(after, before[0]))
    for _ in range(2):
        eng.restore(snap)
        for a, b in zip(_flat(eng.cache), before[0]):
            np.testing.assert_array_equal(a, b)
        assert torch.equal(eng.tokens, before[1])
        assert eng.slots == before[2] and list(eng.queue) == before[3]
        assert [list(r.out_tokens) for r in eng.slots
                if r is not None] == before[4]
    eng.step()
    for a, b in zip(_flat(eng.cache), after):
        np.testing.assert_array_equal(a, b)


def test_requeue_matches_jax(setup):
    """Fail-stop eviction re-queues the same requests in the same order,
    resets them, and rejects an out-of-range slot, as the reference."""
    cfg_j, params_j = setup[:2]
    eng_j = jserving.ContinuousEngine(
        JaxModel(cfg_j), params_j, 2, 32,
        config=jserving.EngineConfig(prefill_len=4))
    eng_t = _engine(setup, kernels=False)
    out = []
    for m, eng in ((jserving, eng_j), (tserving, eng_t)):
        reqs = _stream(m, cfg_j.vocab)
        for r in reqs:
            eng.submit(r)
        for _ in range(2):
            eng.step()
        victims = eng.requeue([1, 0])
        out.append(([reqs.index(v) for v in victims],
                    [reqs.index(r) for r in eng.queue],
                    [list(r.out_tokens) for r in reqs]))
        with pytest.raises((FaultError, jcore.errors.FaultError)):
            eng.requeue([5])
    assert out[0] == out[1]


# -- chaos ------------------------------------------------------------------

def _clean(setup, kernels=True):
    eng = _engine(setup, kernels=kernels)
    return [list(r.out_tokens) for r in eng.serve(_stream(tserving,
                                                          setup[0].vocab))]


def _recoveries(h):
    """The ``nan`` and ``device_loss`` recoveries, comparable across the
    two packages."""
    out = []
    for r in h.recoveries:
        ev = r["event"]
        if ev.kind == "straggler":
            continue
        out.append((ev.kind, ev.step, ev.device, ev.detail, r["action"],
                    tuple(r.get("bad_phys", ())), r.get("requeued"),
                    tuple(r.get("survivors", ()))))
    return out


def _chaos(setup, m, faults, n_devices=2, replication=None, planner=False,
           kernels=True, timeout=2):
    """One ChaosHarness run of the canonical stream in package ``m``."""
    cfg_j, params_j, params_np, model = setup
    inj = m.FaultInjector(m.FaultPlan(faults), n_devices=n_devices,
                          health=m.HealthMonitor(n_devices=n_devices,
                                                 heartbeat_timeout=timeout,
                                                 min_observations=2))
    config = m.EngineConfig(prefill_len=4, kernels=kernels,
                            step_wrapper=inj.wrap)
    if m is jserving:
        eng = m.ContinuousEngine(JaxModel(cfg_j), params_j, 2, 32,
                                 config=config)
        core = jcore
    else:
        eng = m.ContinuousEngine(model, bridge.to_torch(params_np), 2, 32,
                                 config=config)
        core = tcore
    if replication is not None:
        eng.adopt_replication(replication)
    kw = {}
    if planner:
        n = cfg_j.moe.n_experts
        kw = dict(planner=core.AuroraPlanner(core.homogeneous_cluster(n)),
                  trace=core.synthetic_trace("chaos", n_experts=n,
                                             n_layers=2, seed=0))
    h = m.ChaosHarness(eng, inj, **kw)
    live = h.serve(_stream(m, cfg_j.vocab))
    return [list(map(int, r.out_tokens)) for r in live], h, eng


CHAOS = {
    "replica_repair": dict(
        faults=lambda m: (m.ExpertCorruption(step=2, expert=0),),
        replication=(2, 1, 1, 1), action="repaired-from-replica"),
    "pristine_restore": dict(
        faults=lambda m: (m.ExpertCorruption(step=2, expert=1, layer=0),),
        replication=(2, 1, 1, 1), action="restored-pristine"),
    "unreplicated_pristine": dict(
        faults=lambda m: (m.ExpertCorruption(step=1, expert=3),),
        replication=None, action="restored-pristine"),
    "device_loss_requeue": dict(
        faults=lambda m: (m.DeviceLoss(step=2, device=1),),
        replication=None, action="requeued"),
    "device_loss_degraded_replan": dict(
        faults=lambda m: (m.DeviceLoss(step=1, device=1),
                          m.Straggler(step=0, device=0, factor=6.0)),
        replication=(1, 2, 1, 1), planner=True, n_devices=4,
        action="requeued+replanned"),
}


@pytest.mark.parametrize("case", sorted(CHAOS))
def test_chaos_recovery_matches_jax(setup, case):
    """Every recovery path gives the never-faulted streams and the JAX
    harness's streams, with the reference's nan/device_loss recoveries."""
    c = CHAOS[case]
    kw = dict(replication=c["replication"], planner=c.get("planner", False),
              n_devices=c.get("n_devices", 2))
    want, hj, _ = _chaos(setup, jserving, c["faults"](jserving), **kw)
    got, ht, eng = _chaos(setup, tserving, c["faults"](tserving), **kw)
    assert got == want == _clean(setup)
    assert all(len(r) == 3 for r in got)
    assert _recoveries(ht) == _recoveries(hj)
    assert any(r["action"] == c["action"] for r in ht.recoveries)
    if c.get("planner"):
        assert (eng.model.replication is None) == \
            (hj.engine.model.pc.moe_replication is None)


def test_device_loss_drops_every_host_of_the_device(setup):
    """With fewer injector devices than planner devices, a lost device
    takes all the planner devices it stood for (``hosts_of_device``): the
    degraded plan is the JAX planner's for that whole set, its survivors
    exclude them, and the streams stay the never-faulted run's."""
    cfg_j, params_j, params_np, model = setup
    n = cfg_j.moe.n_experts
    trace_kw = dict(n_experts=n, n_layers=2, seed=0)
    inj = tserving.FaultInjector(
        tserving.FaultPlan((tserving.DeviceLoss(step=1, device=1),)),
        n_devices=2, health=tserving.HealthMonitor(n_devices=2,
                                                   heartbeat_timeout=2))
    eng = _engine(setup, step_wrapper=inj.wrap)
    eng.adopt_replication((1, 2, 1, 1))
    h = tserving.ChaosHarness(
        eng, inj, planner=tcore.AuroraPlanner(tcore.homogeneous_cluster(n)),
        trace=tcore.synthetic_trace("chaos", **trace_kw),
        hosts_of_device=lambda d: [e for e in range(n) if e % 2 == d])
    got = [list(r.out_tokens) for r in h.serve(_stream(tserving,
                                                       cfg_j.vocab))]
    lost = [e for e in range(n) if e % 2 == 1]
    want = jcore.AuroraPlanner(jcore.homogeneous_cluster(n)).plan_degraded(
        jcore.synthetic_trace("chaos", **trace_kw), failed_devices=lost)
    entry, = [r for r in h.recoveries if r["event"].kind == "device_loss"]
    assert entry["action"] == "requeued+replanned"
    assert list(entry["survivors"]) == list(want.survivors) == [0, 2]
    spec = tm.ReplicationSpec.from_counts([len(x) for x in want.replication])
    assert eng.model.replication == spec
    assert got == _clean(setup)


@pytest.mark.parametrize("seed", [3, 11, 25])
def test_random_chaos_plans_match_jax(setup, seed):
    """Random plans (corruption, loss, stragglers) recover to the exact
    never-faulted streams, in both packages alike."""
    cfg_j = setup[0]
    plans = [m.FaultPlan.random(seed, horizon=8, n_devices=2,
                                n_experts=cfg_j.moe.n_experts, n_faults=2,
                                max_losses=1).faults
             for m in (jserving, tserving)]
    want, hj, _ = _chaos(setup, jserving, plans[0])
    got, ht, _ = _chaos(setup, tserving, plans[1])
    assert got == want == _clean(setup)
    assert _recoveries(ht) == _recoveries(hj)


def test_nan_without_declared_corruption_is_a_real_failure(setup):
    """A NaN the plan did not script has no checkpoint to roll back to:
    ``FaultError``, as in the reference."""
    inj = tserving.FaultInjector(tserving.FaultPlan(), n_devices=1)
    eng = _engine(setup, step_wrapper=inj.wrap)
    h = tserving.ChaosHarness(eng, inj)
    tfaults.corrupt_moe_params(eng.params, 0)
    for r in _stream(tserving, setup[0].vocab, n=2):
        eng.submit(r)
    with pytest.raises(FaultError):
        for _ in range(8):
            h.step()


def test_pristine_copy_is_logical_and_on_the_host(setup):
    """The harness keeps the expert leaves only, in the logical frame (the
    home copies under replication), as copies on the host."""
    eng = _engine(setup)
    eng.adopt_replication((2, 1, 3, 1))
    h = tserving.ChaosHarness(eng, tserving.FaultInjector(
        tserving.FaultPlan(), n_devices=1))
    want = [leaf.numpy() for leaf in
            tm.expert_leaves(bridge.to_torch(setup[2]))]
    assert len(h._pristine) == 3 == len(want)
    for slabs, w in zip(h._pristine, want):
        np.testing.assert_array_equal(np.stack([s.numpy() for s in slabs]), w)
        assert all(s.device.type == "cpu" for s in slabs)
    assert h.pristine_bytes == sum(a.nbytes for a in want)
