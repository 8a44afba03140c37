"""The port's telemetry hub against the JAX reference, on the CPU: ring
buffers and the event bus, spans, the metrics registry, the exports and
the engines' watch-only invariant (a hub never changes an emitted token).

With an injected clock both hubs, driven by the same sequence of
operations, must give the same Prometheus text, records, JSONL, Chrome
trace and snapshot. Engines serve reduced phi3.5-MoE (fp32) with JAX
params carried across by ``repro_torch.bridge``.
"""

import collections
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving import telemetry as ttel  # noqa: E402

ARCH = "phi3.5-moe-42b-a6.6b"


@pytest.fixture(scope="module")
def setup():
    cfg_j = jax_get_config(ARCH).reduced()
    params_j = JaxModel(cfg_j).init(jax.random.PRNGKey(0))
    model = Model(get_config(ARCH).reduced(), device="cpu")
    return cfg_j, params_j, jax.tree.map(np.asarray, params_j), model


def _ticks(step=0.25):
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]
    return clock


# -- ring buffer and bus -------------------------------------------------------

@pytest.mark.parametrize("capacity,n", [(1, 0), (1, 5), (3, 2), (3, 5),
                                        (8, 40)])
def test_ring_retention_and_on_drop(capacity, n):
    """len == min(n, cap), dropped == max(0, n - cap), the last cap items
    kept in order, and on_drop sees each evicted item, as the reference."""
    rings, dropped = [], []
    for mod in (jserving, tserving):
        seen = []
        ring = mod.RingBuffer(capacity, on_drop=seen.append)
        for i in range(n):
            ring.append(i)
        rings.append(ring)
        dropped.append(seen)
    want, got = rings
    assert list(got) == list(want) == list(range(n))[-capacity:]
    assert got.dropped == want.dropped == max(0, n - capacity)
    assert dropped[1] == dropped[0] == list(range(max(0, n - capacity)))
    assert got[:2] == want[:2] and len(got) == len(want)
    with pytest.raises(ValueError):
        tserving.RingBuffer(0)


def test_bus_matches_reference():
    """Same seeded publish sequence: the same (seq, kind, step, ts,
    payload) stream, per-kind counts, evictions and subscriber calls."""
    def run(mod, seed):
        rng = np.random.default_rng(seed)
        t = [0.0]

        def clock():
            t[0] += float(rng.random())
            return t[0]
        drops, seen = [], []
        bus = mod.EventBus(capacity=8, clock=clock, on_drop=drops.append)
        bus.subscribe(lambda e: seen.append(e.seq))
        kinds = ("shed", "replan", "fault")
        for i in range(20):
            bus.publish(kinds[int(rng.integers(3))], {"i": i}, step=i)
        return ([(e.seq, e.kind, e.step, e.ts, e.payload) for e in bus],
                dict(bus.counts), bus.dropped, [e.seq for e in drops], seen,
                [e.seq for e in bus.events("fault")])
    assert run(tserving, 7) == run(jserving, 7)
    assert run(tserving, 7) != run(tserving, 8)


# -- spans -------------------------------------------------------------------

def test_span_nesting_exception_and_disabled_singleton():
    tel = tserving.Telemetry(clock=_ticks())
    with tel.span("outer"):
        with tel.span("mid"):
            with tel.span("inner"):
                pass
    by = {s.name: s for s in tel.spans}
    assert [by[n].depth for n in ("outer", "mid", "inner")] == [0, 1, 2]
    assert by["inner"].seq < by["mid"].seq < by["outer"].seq
    with pytest.raises(RuntimeError):
        with tel.span("boom_outer"):
            with tel.span("boom_inner"):
                raise RuntimeError("boom")
    assert tel._stack == []
    by = {s.name: s for s in tel.spans}
    assert by["boom_inner"].error == by["boom_outer"].error == "RuntimeError"
    off = tserving.Telemetry(enabled=False)
    assert off.span("a", x=1) is off.span("b") is ttel._NULL_SPAN
    off.count("c_total")
    off.gauge("g", 1.0)
    off.observe("h", 0.5)
    assert off.publish("k", {"v": 1}) is None
    assert off.wrap_step(lambda: 3, "s")() == 3
    prof = tserving.Telemetry(profiler=True)
    assert prof.wrap_step(lambda: 3, "s")() == 3     # record_function range
    assert [s.name for s in prof.spans] == ["s"]
    tserving.record_adoption(off, "replication", step=1)
    tserving.record_adoption(None, "replication", step=1)
    assert len(off.spans) == 0 and len(off.bus) == 0
    for name in ("c_total", "g", "h", "serving_adoptions_total"):
        assert name not in off.metrics
    with pytest.raises(TypeError):
        tel.metrics.gauge("span_seconds")        # registered as a histogram


# -- one sequence of operations on both hubs ----------------------------------

class _Payload:
    """A payload the JSON sanitiser must fall back to repr() for."""

    def __repr__(self):
        return "<payload>"


def _drive(mod, tensor):
    """The same operations on a hub of package ``mod``; ``tensor`` makes an
    array of that package (numpy for JAX, a tensor for the port)."""
    tel = mod.Telemetry(capacity=6, clock=_ticks())
    tel.count("serving_tokens_total", 3, help="tokens", tenant="a")
    tel.count("serving_tokens_total", 2, tenant="b")
    tel.gauge("serving_queue_depth", 5, help="queue", tenant="a")
    for v in (0.5, 3.0, 9.0, 300.0):
        tel.observe("serving_ttft_steps", v, help="ttft",
                    bounds=mod.telemetry.STEP_BOUNDS, tenant="a")
    with tel.span("engine_step", step=0):
        step = tel.wrap_step(lambda x: (x, {"k": x}), "decode_step",
                             tenant="a", rounds=lambda: [(1, 0), (0, 1)])
        step(tensor([1.0, 2.0]))
        tel.wrap_step(lambda: None, "prefill")()
    tel.publish("shed", {"reason": "deadline:late", "arr": tensor([1, 2]),
                         "bad": float("nan"), "obj": _Payload(),
                         "long": list(range(70))}, step=0)
    tel.emit_span("dispatch_round", ts=0.1, dur=0.01, depth=2, r=0,
                  estimated=True)
    mod.record_adoption(tel, "replication", step=3, counts=(2, 1, 1))
    with tel.span("engine_step", step=1, tenant="b"):
        tel.publish("replan", {"applied": True}, step=1)
    for i in range(5):                       # evictions from both rings
        with tel.span("tick", i=i):
            pass
        tel.publish("fault", {"i": i}, step=i)
    return tel


def test_hub_exports_equal_reference():
    """Prometheus text, records, JSONL, Chrome trace and snapshot of the
    port's hub equal the reference hub's for the same operations."""
    want = _drive(jserving, np.asarray)
    got = _drive(tserving, torch.tensor)
    assert got.prometheus_text() == want.prometheus_text()
    assert got.records() == want.records()
    assert got.jsonl() == want.jsonl()
    assert got.chrome_trace() == want.chrome_trace()
    assert got.snapshot() == want.snapshot()
    assert 'le="+Inf"' in got.prometheus_text()
    assert got.spans.dropped and got.bus.dropped
    assert got.metrics["ppermute_rounds_total"].value() == 2  # two rounds
    trace = json.loads(json.dumps(got.chrome_trace()))
    assert {e["ph"] for e in trace["traceEvents"]} == {"X", "i", "M"}


def test_launcher_writes_trace_and_metrics(tmp_path, capsys):
    from repro_torch.launch import serve
    base = str(tmp_path / "run")
    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--num-requests", "3", "--batch", "2",
                       "--cache-cap", "32", "--max-new-tokens", "4",
                       "--kernels", "--trace-out", base,
                       "--metrics-out", str(tmp_path / "m.json")]) == 0
    recs = [json.loads(ln) for ln in open(base + ".jsonl")]
    assert {"engine_step", "prefill", "decode_step"} <= {
        r["name"] for r in recs if r["type"] == "span"}
    assert json.load(open(base + ".trace.json"))["traceEvents"]
    snap = json.load(open(tmp_path / "m.json"))
    assert snap["metrics"]["serving_tokens_total"]["values"]
    assert "trace:" in capsys.readouterr().out


# -- engines -----------------------------------------------------------------

def _requests(m):
    return [m.Request(prompt=[1, 2, 3, 4], max_new_tokens=6),
            m.Request(prompt=[5, 6, 7, 8], max_new_tokens=3, arrival=1.0),
            m.Request(prompt=[9, 10, 11, 12], max_new_tokens=6,
                      arrival=1.0),
            m.Request(prompt=[2, 4, 6, 8], max_new_tokens=5, arrival=4.0)]


def _span_names(tel):
    return collections.Counter(s.name for s in tel.spans)


def _metrics(tel):
    """The snapshot without the wall-clock span histogram."""
    snap = tel.metrics.snapshot()
    snap.pop("span_seconds", None)
    return snap


CONFIGS = {
    "one_shot": lambda m: {},
    "chunk2_pool2": lambda m: dict(prefill_chunk=2, prefill_pool=2),
    "chunk2_monitor": lambda m: dict(prefill_chunk=2),
}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_engine_with_hub_matches_jax(setup, case):
    """Tokens with a hub equal tokens without one and the JAX engine's;
    the hub holds one span per step callable run and the same metrics as
    the reference hub (routing-load gauges included, under a monitor)."""
    cfg_j, params_j, params_np, model = setup
    kw = CONFIGS[case]
    mon = case == "chunk2_monitor"

    def run(m, hub):
        config = m.EngineConfig(prefill_len=4, kernels=True, telemetry=hub,
                                **kw(m))
        monitor = (m.TrafficMonitor(4, 2) if mon else None)
        if m is jserving:
            eng = m.ContinuousEngine(JaxModel(cfg_j), params_j, 2, 32,
                                     config=config, monitor=monitor)
        else:
            eng = m.ContinuousEngine(model, bridge.to_torch(params_np), 2,
                                     32, config=config, monitor=monitor)
        reqs = eng.serve(_requests(m))
        return [list(map(int, r.out_tokens)) for r in reqs], eng

    base, _ = run(tserving, None)
    hub_t, hub_j = tserving.Telemetry(), jserving.Telemetry()
    got, eng = run(tserving, hub_t)
    want, _ = run(jserving, hub_j)
    assert got == base == want
    calls = _span_names(hub_t)
    assert calls == _span_names(hub_j)
    if case == "chunk2_pool2":
        assert calls["pool_step"] > 0 and calls["prefill_chunk"] == 0
    else:
        assert calls["prefill"] + calls["prefill_chunk"] == eng.prefills
        assert calls["decode_step"] == eng.decode_steps
    assert _metrics(hub_t) == _metrics(hub_j)
    tokens = sum(map(len, got))
    assert hub_t.metrics["serving_tokens_total"].value(tenant="") == tokens
    if mon:
        assert "moe_expert_load_imbalance" in hub_t.metrics


def test_engine_disabled_hub_records_nothing(setup):
    *_, params_np, model = setup
    tel = tserving.Telemetry(enabled=False)
    eng = tserving.ContinuousEngine(
        model, bridge.to_torch(params_np), 2, 32,
        config=tserving.EngineConfig(prefill_len=4, telemetry=tel))
    eng.serve(_requests(tserving)[:2])
    assert len(tel.spans) == 0 and len(tel.bus) == 0
    assert "serving_tokens_total" not in tel.metrics


def test_shed_events_ring_bounded_and_published(setup):
    """An overload burst under shed-mode EDF with event_capacity 2: the
    engine keeps the newest sheds, counts the evictions, and every shed
    lands on the hub, as in the reference."""
    *_, params_np, model = setup
    tel = tserving.Telemetry()
    eng = tserving.ContinuousEngine(
        model, bridge.to_torch(params_np), 2, 32,
        config=tserving.EngineConfig(
            admission=tserving.EdfAdmission(chunk=4, budget=6, shed=True,
                                            queue_cap=2),
            prefill_len=4, telemetry=tel, event_capacity=2))
    reqs = [tserving.Request(prompt=[1 + i, 2, 3, 4], max_new_tokens=3,
                             arrival=0.0, deadline=0.5) for i in range(8)]
    sheds = sum(eng.submit(r) is not None for r in reqs)
    while eng.step():
        pass
    assert sheds >= 3
    assert len(eng.shed_events) == 2
    assert eng.shed_events.dropped == sheds - 2
    assert tel.metrics["serving_events_total"].value(kind="shed") == sheds
    assert len(tel.bus.events("shed")) == sheds


def test_health_monitor_publishes_and_gauges():
    tel = tserving.Telemetry()
    h = tserving.HealthMonitor(n_devices=1, capacity=2, min_observations=2,
                               telemetry=tel)
    for step in range(3):
        assert not h.observe_output({"x": torch.tensor([float("nan")])},
                                    step)
    assert len(h.events) == 2 and h.events.dropped == 1
    assert len(h.drain()) == 2 and h.drain() == []
    assert tel.metrics["serving_faults_total"].value(kind="nan") == 3
    assert len(tel.bus.events("fault")) == 3
    h.observe_step_time(0, 0.2)
    assert tel.metrics["device_detector_armed"].value(device="0") == 0.0
    h.observe_step_time(0, 0.2)
    assert tel.metrics["device_detector_armed"].value(device="0") == 1.0
    np.testing.assert_allclose(
        tel.metrics["device_step_seconds"].value(device="0"), 0.2)


def test_chaos_and_adoptions_publish_to_the_hub(setup):
    """Fault injection, detection, recovery and replication adoptions all
    land on one hub; the chaos run's streams equal the clean run's."""
    cfg_j, _, params_np, model = setup
    tel = tserving.Telemetry()
    plan = tserving.FaultPlan((tserving.ExpertCorruption(step=2, expert=0),))
    inj = tserving.FaultInjector(
        plan, n_devices=2,
        health=tserving.HealthMonitor(n_devices=2, telemetry=tel))
    eng = tserving.ContinuousEngine(
        model, bridge.to_torch(params_np), 2, 32,
        config=tserving.EngineConfig(prefill_len=4, kernels=True,
                                     step_wrapper=inj.wrap, telemetry=tel))
    eng.adopt_replication((2, 1, 1, 1))
    h = tserving.ChaosHarness(eng, inj)
    got = [list(r.out_tokens) for r in h.serve(_requests(tserving))]
    clean = tserving.ContinuousEngine(
        model, bridge.to_torch(params_np), 2, 32,
        config=tserving.EngineConfig(prefill_len=4, kernels=True))
    assert got == [list(r.out_tokens) for r in clean.serve(
        _requests(tserving))]
    counts = tel.bus.counts
    assert counts["fault_injected"] == 1 and counts["fault"] >= 1
    assert counts["recovery"] >= 1 and counts["adoption"] == 1
    assert tel.metrics["serving_recoveries_total"].value(
        action="repaired-from-replica") == 1
    assert tel.metrics["serving_adoptions_total"].value(
        kind="replication") == 1


@pytest.mark.parametrize("tenants", [2, 3])
def test_colocated_engines_with_hub(setup, tenants):
    """The colocated and multi-tenant engines under a forced re-planner:
    streams with a hub equal streams without one and the JAX engines';
    the hub holds the lockstep spans and the adoptions, as the reference
    hub does."""
    cfg_j, params_j, params_np, model = setup
    n = cfg_j.moe.n_experts

    def run(m, hub):
        core = jcore if m is jserving else tcore
        replan = m.OnlineReplanner(
            core.AuroraPlanner(core.homogeneous_cluster(n)), interval=3,
            threshold=-1.0, warmup=1)
        config = m.EngineConfig(kernels=True, prefill_chunk=2, telemetry=hub)
        if m is jserving:
            mods = [JaxModel(cfg_j)] * tenants
            ps = [params_j] * tenants
        else:
            mods = [model] * tenants
            ps = [bridge.to_torch(params_np) for _ in range(tenants)]
        streams = [_requests(m) for _ in range(tenants)]
        if tenants == 2:
            eng = m.ColocatedContinuousEngine(*mods, *ps, batch_slots=2,
                                              cache_cap=32, config=config,
                                              replan=replan)
            eng.serve(*streams)
        else:
            eng = m.MultiTenantContinuousEngine(mods, ps, batch_slots=2,
                                                cache_cap=32, config=config,
                                                replan=replan)
            eng.serve(streams)
        return [[list(map(int, r.out_tokens)) for r in rs]
                for rs in streams]

    hub_t, hub_j = tserving.Telemetry(), jserving.Telemetry()
    got = run(tserving, hub_t)
    assert got == run(tserving, None) == run(jserving, hub_j)
    names = _span_names(hub_t)
    assert names == _span_names(hub_j)
    assert names["lockstep_decode"] > 0 and names["prefill_chunk"] > 0
    assert _metrics(hub_t) == _metrics(hub_j)
    assert hub_t.bus.counts == hub_j.bus.counts
    assert hub_t.bus.counts["adoption"] >= 1
