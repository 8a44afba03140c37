"""The port's expert-parallel engines against the JAX reference, on the CPU.

``DistributedEngine``, ``DistributedColocatedEngine`` and
``DistributedMultiTenantEngine`` over ``LocalGroup(4)`` (and once over 4
gloo ranks), reduced phi3.5-MoE widened to 8 experts at capacity factor
8.0, weights made by the JAX package and carried across by
``repro_torch.bridge``. The greedy streams must equal the single-device
JAX ``ContinuousEngine``'s byte for byte (the reference's own EP engines
fail under the installed jax, ROADMAP C1), with the kernel path on and
off, and must not change under ``swap_rounds``, ``adopt`` (a trace, an
expert->device assignment, a replicated plan), a forced colocated re-plan
or re-grouping, or ``adopt_degraded`` through ``ChaosHarness``.
"""

import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import LocalGroup, round_robin_rounds  # noqa: E402
from repro_torch.models import Model  # noqa: E402

from _torch_ep import N_RANKS, gloo_run  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the EP paths run many small ops per rank, and
    several test workers on one host make every multi-threaded op wait for
    descheduled threads (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ARCH = "phi3.5-moe-42b-a6.6b"
N_E = 8


def _widen(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=N_E, capacity_factor=8.0))


CFG_J = _widen(jax_get_config(ARCH).reduced())
CFG = _widen(get_config(ARCH).reduced())


def _prompts(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, CFG.vocab, 8)]
            for _ in range(n)]


def _reqs(m, prompts, new=6):
    return [m.Request(prompt=list(p), max_new_tokens=new,
                      arrival=float(i // 2)) for i, p in enumerate(prompts)]


def _streams(reqs):
    return [list(map(int, r.out_tokens)) for r in reqs]


@pytest.fixture(scope="module")
def weights():
    """Seeds 0-2 of the widened reduced model, made by the JAX package."""
    return [jax.tree.map(np.asarray, JaxModel(CFG_J).init(
        jax.random.PRNGKey(seed))) for seed in range(3)]


@pytest.fixture(scope="module")
def want(weights):
    """The single-device JAX engine's streams (seed-0 weights)."""
    eng = jserving.ContinuousEngine(
        JaxModel(CFG_J), jax.tree.map(jnp.asarray, weights[0]),
        batch_slots=2, cache_cap=32,
        config=jserving.EngineConfig(prefill_len=8))
    return _streams(eng.serve(_reqs(jserving, _prompts())))


def _engine(weights, impl="aurora", overlap=False, kernels=True, **kw):
    config = tserving.EngineConfig(prefill_len=8, kernels=kernels,
                                   **kw.pop("config", {}))
    return tserving.DistributedEngine(
        Model(CFG, device="cpu"), bridge.to_torch(weights[0]),
        batch_slots=2, cache_cap=32, group=LocalGroup(N_RANKS),
        moe_impl=impl, overlap=overlap, config=config, **kw)


@pytest.mark.parametrize("kernels", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("impl,overlap", [("ep", False), ("aurora", False),
                                          ("aurora", True)],
                         ids=["ep", "aurora", "overlap"])
def test_streams_match_jax_engine(weights, want, impl, overlap, kernels):
    eng = _engine(weights, impl, overlap, kernels)
    assert eng.model.pc.moe_impl == impl and eng.n_ep == N_RANKS
    assert _streams(eng.serve(_reqs(tserving, _prompts()))) == want


def test_adoptions_are_placement_only_and_reach_the_hub(weights, want):
    """Mid-stream: literal rounds, rounds from a drifted trace, a Thm 5.1
    assignment (heterogeneous cluster) and a replicated plan padded to the
    rank count, each adopted on the overlapped "aurora" path: the streams
    stay the JAX engine's; every rounds swap is a "rounds" adoption on the
    hub and each decode span gets one ``dispatch_round`` sub-span per
    round.
    A replication that does not shard over the ranks is refused."""
    hub = tserving.Telemetry(block_steps=False)
    mon = tserving.TrafficMonitor(N_E, 2)
    eng = _engine(weights, overlap=True, monitor=mon,
                  config={"telemetry": hub},
                  plan=tcore.synthetic_trace("hist", n_experts=N_E,
                                             n_layers=2, seed=0))
    r0 = eng.rounds
    drift = tcore.synthetic_trace("drift", n_experts=N_E, n_layers=2, seed=9)
    assign = tcore.AuroraPlanner(tcore.heterogeneous_cluster(N_E)) \
        .plan_exclusive(drift)
    planner = tcore.AuroraPlanner(tcore.homogeneous_cluster(N_E))
    counts = np.ones((2, N_E))
    counts[:, 0] = 25.0
    skew = tcore.trace_from_counts("skew", counts)
    rep = planner.plan_replicated(skew, tolerance=0.05,
                                  total_multiple=N_RANKS)
    n_phys = sum(len(h) for h in rep.replication)
    assert n_phys % N_RANKS == 0 and n_phys > N_E
    assert list(assign.expert_to_device) != list(range(N_E))
    actions = {2: lambda: eng.swap_rounds(round_robin_rounds(N_RANKS)),
               3: lambda: eng.adopt(drift), 4: lambda: eng.adopt(assign),
               5: lambda: eng.adopt(rep)}
    reqs = _reqs(tserving, _prompts())

    def step():
        worked = eng.step()
        if eng.decode_steps in actions:
            actions.pop(eng.decode_steps)()
        return worked
    tserving.serve_stream(step, [(eng, reqs)])
    assert not actions and _streams(reqs) == want
    assert eng.rounds != r0
    assert eng.assignment == [int(d) for d in assign.expert_to_device]
    assert eng.model.replication.n_phys == n_phys
    assert mon.observations > 0
    kinds = collections.Counter(e.payload["kind"]
                                for e in hub.bus.events("adoption"))
    assert kinds["rounds"] == 4 and kinds["assignment"] == 1 \
        and kinds["replication"] == 1
    spans = collections.Counter(s.name for s in hub.spans)
    # Every schedule over 4 ranks has at least the 3 rounds of a cover.
    assert spans["dispatch_round"] >= 3 * spans["decode_step"] > 0
    bad = planner.plan_replicated(skew, tolerance=0.0, max_total_replicas=1)
    assert sum(len(h) for h in bad.replication) % N_RANKS
    with pytest.raises(tserving.PlanError, match=f"total_multiple={N_RANKS}"):
        eng.adopt(bad)


def test_device_loss_rebuilds_the_group_over_the_survivors(weights, want):
    """``ChaosHarness`` takes the distributed branch: rank 3's loss fails
    its planner devices (6, 7), ``plan_degraded(ep_compatible=True)``
    keeps 4 of the 8, which live on ranks 0 and 1, and ``adopt_degraded``
    rebuilds a 2-rank group; the requeued requests re-run and every stream
    stays the JAX engine's."""
    inj = tserving.FaultInjector(
        tserving.FaultPlan((tserving.DeviceLoss(step=2, device=3),)),
        n_devices=N_RANKS, health=tserving.HealthMonitor(
            n_devices=N_RANKS, heartbeat_timeout=2))
    eng = _engine(weights, overlap=True,
                  config={"step_wrapper": inj.wrap})
    trace = tcore.synthetic_trace("chaos", n_experts=N_E, n_layers=2, seed=0)
    h = tserving.ChaosHarness(
        eng, inj, planner=tcore.AuroraPlanner(tcore.homogeneous_cluster(N_E)),
        trace=trace)
    got = _streams(h.serve(_reqs(tserving, _prompts())))
    entry, = [r for r in h.recoveries if r["event"].kind == "device_loss"]
    assert entry["action"] == "requeued+replanned"
    assert list(entry["survivors"]) == [0, 1, 2, 3]
    assert eng.n_ep == eng.group.n == 2 and eng.model.pc.group is eng.group
    assert got == want
    with pytest.raises(tserving.PlanError, match="degraded Plan"):
        eng.adopt_degraded(tcore.AuroraPlanner(
            tcore.homogeneous_cluster(N_E)).plan_exclusive(trace))


def test_colocated_replan_refreshes_rounds(weights):
    """A forced colocated re-plan on the distributed dual-model engine
    refreshes the rounds (each refresh a "rounds" adoption on the hub,
    each lockstep span with its rounds sub-spans); the streams equal those
    with the refresh off and those of the single-card colocated engine."""
    planner = tcore.AuroraPlanner(tcore.homogeneous_cluster(N_E))
    plan0 = planner.plan_colocated(
        tcore.synthetic_trace("ha", n_experts=N_E, n_layers=2, seed=0),
        tcore.synthetic_trace("hb", n_experts=N_E, n_layers=2, seed=1))

    def serve(refresh, distributed=True):
        hub = tserving.Telemetry(block_steps=False)
        rp = tserving.OnlineReplanner(planner, interval=3, threshold=-1e9,
                                      warmup=1)
        params_b = tserving.apply_pairing(bridge.to_torch(weights[1]),
                                          list(plan0.pair), CFG)
        kw = dict(batch_slots=2, cache_cap=32, replan=rp,
                  config=tserving.EngineConfig(prefill_len=8, kernels=True,
                                               telemetry=hub),
                  monitor_halflife=8.0)
        model = Model(CFG, device="cpu")
        if distributed:
            eng = tserving.DistributedColocatedEngine(
                model, model, bridge.to_torch(weights[0]), params_b,
                group=LocalGroup(N_RANKS), plan=plan0, overlap=True,
                refresh_rounds=refresh, **kw)
        else:
            eng = tserving.ColocatedContinuousEngine(
                model, model, bridge.to_torch(weights[0]), params_b,
                pair=list(plan0.pair), **kw)
        r0 = getattr(eng, "rounds", None)
        ra = _reqs(tserving, _prompts(1), new=4)
        rb = _reqs(tserving, _prompts(2), new=4)
        eng.serve(ra, rb)
        applied = [e for e in eng.replan_events if e.applied]
        return eng, r0, applied, [_streams(ra), _streams(rb)], hub

    eng_r, r0, applied_r, s_r, hub = serve(True)
    eng_s, _, applied_s, s_s, _ = serve(False)
    _, _, _, s_single, _ = serve(True, distributed=False)
    assert applied_r and eng_r.rounds != r0 and eng_s.rounds == r0
    assert [e.pair for e in applied_r] == [e.pair for e in applied_s]
    assert s_r == s_s == s_single
    kinds = collections.Counter(e.payload["kind"]
                                for e in hub.bus.events("adoption"))
    assert kinds["rounds"] == len(applied_r) == kinds["pairing"]
    spans = collections.Counter(s.name for s in hub.spans)
    assert spans["dispatch_round"] >= spans["lockstep_decode"] > 0


def test_multi_tenant_regroup_refreshes_rounds(weights):
    """Three tenants on the distributed N-tenant engine with a forced
    re-grouping: the rounds are refreshed, and the streams equal those
    with the refresh off."""
    planner = tcore.AuroraPlanner(tcore.homogeneous_cluster(N_E))

    def serve(refresh):
        eng = tserving.DistributedMultiTenantEngine(
            [Model(CFG, device="cpu")] * 3,
            [bridge.to_torch(w) for w in weights], batch_slots=2,
            cache_cap=32, group=LocalGroup(N_RANKS), moe_impl="aurora",
            refresh_rounds=refresh,
            config=tserving.EngineConfig(prefill_len=8, kernels=True),
            replan=tserving.OnlineReplanner(planner, interval=3,
                                            threshold=-1e9, warmup=1))
        r0 = eng.rounds
        streams = [_reqs(tserving, _prompts(s, n=2), new=4) for s in range(3)]
        eng.serve(streams)
        return eng, r0, [_streams(s) for s in streams]

    eng_r, r0, s_r = serve(True)
    eng_s, _, s_s = serve(False)
    assert any(e.applied for e in eng_r.replan_events)
    assert eng_r.rounds is not None and eng_r.rounds != r0
    assert eng_s.rounds == r0 and s_r == s_s


def test_distribution_errors(weights):
    """EP is demanded loudly: experts that do not divide the ranks, rounds
    on the "ep" path, a literal round sequence that is not a cover, and
    literal rounds handed to ``adopt``."""
    model = Model(CFG, device="cpu")
    with pytest.raises(ValueError, match="do not shard"):
        tserving.distribute(model, LocalGroup(3))
    with pytest.raises(ValueError, match="no MoE"):
        tserving.distribute(dataclasses.replace(
            model, cfg=dataclasses.replace(CFG, moe=None)), LocalGroup(4))
    eng = _engine(weights, impl="ep")
    with pytest.raises(ValueError, match="'aurora' dispatch path"):
        eng.swap_rounds(round_robin_rounds(N_RANKS))
    eng = _engine(weights)
    with pytest.raises(ValueError, match="never exchanged"):
        eng.swap_rounds(round_robin_rounds(N_RANKS)[:-1])
    with pytest.raises(TypeError, match="swap_rounds"):
        eng.adopt(round_robin_rounds(N_RANKS))
    from repro_torch.sharding import make_pc
    assert make_pc(CFG, LocalGroup(3)).moe_impl == "dense"


def test_engine_on_gloo_ranks_equals_local_group(weights, want, tmp_path):
    """One 4-rank gloo run (``DistGroup``) of ``DistributedEngine`` on the
    overlapped "aurora" path: every rank emits the same streams, those of
    the ``LocalGroup`` run and of the JAX engine."""
    local = _streams(_engine(weights, overlap=True).serve(
        _reqs(tserving, _prompts())))
    outs = gloo_run("engine_worker", str(tmp_path), CFG, weights[0],
                    _prompts(), 6, "aurora", True)
    assert all(o == local for o in outs) and local == want


@pytest.mark.parametrize("extra", [[], ["--overlap"],
                                   ["--moe-impl", "ep"]],
                         ids=["aurora", "overlap", "ep"])
def test_launch_serve_mesh_in_process(capsys, extra):
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--experts", "8", "--mesh", "4", "--num-requests",
                       "2", "--batch", "2", "--cache-cap", "32",
                       "--max-new-tokens", "3", "--prompt-len", "8",
                       "--kernels"] + extra) == 0
    out = capsys.readouterr().out
    assert "in-process (4 ranks on cpu)" in out and "tokens in" in out


def test_launch_serve_ep_flags_need_a_mesh():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="--mesh"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--overlap"])
