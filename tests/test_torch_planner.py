"""The port's planner copy (``repro_torch.core``) against ``repro.core``.

Both packages get the same traces (made by each package's own generator
from the same seeds, which are checked equal first) and must return
exactly equal results: pairings, groups, assignments, replication host
maps, survivors, every schedule slot and every simulated time, float for
float. Examples are fixed seeds, not hypothesis draws.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port

N = 8            # experts = devices; divisible by the four paper tiers
SEEDS = [0, 1, 2]


def assert_same(a, b, path="result"):
    """Recursive exact equality across the two packages' types: dataclasses
    field by field (same class name), dicts, sequences, numpy arrays (shape,
    dtype and values) and scalars."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.array_equal(a, b, equal_nan=True), path
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b), f"{path}: {type(a)} vs {type(b)}"
        assert a == b or (a != a and b != b), f"{path}: {a!r} != {b!r}"


def traces(pkg, seed: int, n_tenants: int = 2, n_layers: int = 3):
    return [pkg.synthetic_trace(f"t{t}", n_experts=N, n_layers=n_layers,
                                skew=1.2 + 0.3 * t, seed=seed * 10 + t)
            for t in range(n_tenants)]


def clusters(pkg, kind: str):
    return (pkg.homogeneous_cluster(N) if kind == "homogeneous"
            else pkg.heterogeneous_cluster(N))


@pytest.mark.parametrize("seed", SEEDS)
def test_trace_generators_equal(seed):
    assert_same(traces(ref, seed, 3), traces(port, seed, 3))
    assert_same(ref.paper_eval_traces(seed), port.paper_eval_traces(seed))
    counts = np.random.default_rng(seed).integers(0, 9, (3, N)).astype(float)
    counts[1] = 0.0                         # an unobserved layer
    assert_same(ref.trace_from_counts("live", counts),
                port.trace_from_counts("live", counts))
    assert_same(ref.add_noise(traces(ref, seed)[0], 0.3, seed),
                port.add_noise(traces(port, seed)[0], 0.3, seed))


@pytest.mark.parametrize("kind", ["homogeneous", "heterogeneous"])
@pytest.mark.parametrize("seed", SEEDS)
def test_plan_exclusive_equal(kind, seed):
    want = ref.AuroraPlanner(clusters(ref, kind)).plan_exclusive(
        traces(ref, seed)[0])
    got = port.AuroraPlanner(clusters(port, kind)).plan_exclusive(
        traces(port, seed)[0])
    assert_same(want, got)
    if kind == "heterogeneous":
        assert got.scenario == "exclusive+heterogeneous"


@pytest.mark.parametrize("kind", ["homogeneous", "heterogeneous"])
@pytest.mark.parametrize("seed", SEEDS)
def test_plan_colocated_equal(kind, seed):
    want = ref.AuroraPlanner(clusters(ref, kind)).plan_colocated(
        *traces(ref, seed))
    got = port.AuroraPlanner(clusters(port, kind)).plan_colocated(
        *traces(port, seed))
    assert_same(want, got)
    assert sorted(got.pair) == list(range(N))


@pytest.mark.parametrize("kind", ["homogeneous", "heterogeneous"])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_plan_multi_three_tenants_equal(kind, seed):
    want = ref.AuroraPlanner(clusters(ref, kind)).plan_multi(
        traces(ref, seed, 3))
    got = port.AuroraPlanner(clusters(port, kind)).plan_multi(
        traces(port, seed, 3))
    assert_same(want, got)
    assert all(g[0] == i for i, g in enumerate(got.groups))


@pytest.mark.parametrize("kw", [
    {}, {"tolerance": 0.0}, {"max_total_replicas": 2},
    {"total_multiple": 4}], ids=["default", "tol0", "max2", "multiple4"])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_plan_replicated_equal(kw, seed):
    want = ref.AuroraPlanner(ref.homogeneous_cluster(N)).plan_replicated(
        traces(ref, seed)[0], **kw)
    got = port.AuroraPlanner(port.homogeneous_cluster(N)).plan_replicated(
        traces(port, seed)[0], **kw)
    assert_same(want, got)


@pytest.mark.parametrize("kind", ["homogeneous", "heterogeneous"])
@pytest.mark.parametrize("case", [
    ([3], False, False), ([0, 5], False, False), ([2], True, False),
    ([1, 6], False, True)], ids=["one", "two", "replicated", "ep"])
def test_plan_degraded_equal(kind, case):
    failed, replicated, ep = case

    def plan(pkg):
        planner = pkg.AuroraPlanner(clusters(pkg, kind))
        tr = traces(pkg, 4)[0]
        rep = (pkg.AuroraPlanner(pkg.homogeneous_cluster(N)).plan_replicated(
            tr, tolerance=0.0).replication if replicated else None)
        return planner.plan_degraded(tr, failed, replication=rep,
                                     ep_compatible=ep)

    want, got = plan(ref), plan(port)
    assert_same(want, got)
    assert not set(failed) & set(got.survivors)


def test_plan_degraded_raises_the_same_fault():
    for pkg in (ref, port):
        planner = pkg.AuroraPlanner(pkg.homogeneous_cluster(N))
        with pytest.raises(pkg.FaultError):
            planner.plan_degraded(traces(pkg, 0)[0], list(range(N)))


@pytest.mark.parametrize("seed", SEEDS)
def test_schedules_and_comm_times_equal(seed):
    d_ref = traces(ref, seed)[0].layer(1)
    d_port = traces(port, seed)[0].layer(1)
    bw = np.asarray(ref.heterogeneous_cluster(N).bandwidths, float)
    for bws in (None, bw):
        want = ref.aurora_schedule(d_ref, bws)
        got = port.aurora_schedule(d_port, bws)
        assert_same(want, got)
        assert_same(want.permutations(), got.permutations())
        assert_same(want.sender_orders(), got.sender_orders())
        for policy in ("aurora", "sjf", "rcs"):
            assert_same(ref.comm_time(d_ref, policy, bws, seed=seed),
                        port.comm_time(d_port, policy, bws, seed=seed))
    assert_same(ref.fluid_comm_time(ref.rcs_order(d_ref, seed)),
                port.fluid_comm_time(port.rcs_order(d_port, seed)))


@pytest.mark.parametrize("kind", ["homogeneous", "heterogeneous"])
@pytest.mark.parametrize("seed", SEEDS)
def test_every_evaluate_equal(kind, seed):
    """``evaluate_exclusive``, ``evaluate_colocated`` (with and without a
    slot->device map), ``evaluate_multi`` and ``evaluate_replicated`` on
    placements drawn with each package's own random baselines."""

    def evaluate(pkg):
        planner = pkg.AuroraPlanner(clusters(pkg, kind))
        a, b, c = traces(pkg, seed, 3)
        s2d = pkg.random_assignment(N, seed + 7)
        rep = pkg.AuroraPlanner(pkg.homogeneous_cluster(N)).plan_replicated(
            a, tolerance=0.0).replication
        return [
            planner.evaluate_exclusive(a, pkg.random_assignment(N, seed)),
            planner.evaluate_colocated(a, b, pkg.random_pairing(N, seed)),
            planner.evaluate_colocated(a, b, pkg.random_pairing(N, seed), s2d),
            planner.evaluate_multi([a, b, c],
                                   pkg.random_grouping(N, 3, seed)),
            planner.evaluate_multi([a, b, c],
                                   pkg.random_grouping(N, 3, seed), s2d),
            planner.evaluate_replicated(a, rep),
            pkg.lina_inference_time(a, 0, clusters(pkg, kind)),
        ]

    assert_same(evaluate(ref), evaluate(port))


def test_bruteforce_and_diff_equal():
    """Exhaustive optima at four experts, and ``diff_plans``."""
    def run(pkg):
        cl = pkg.heterogeneous_cluster(4)
        a, b = [pkg.synthetic_trace(f"t{t}", n_experts=4, n_layers=1,
                                    seed=t) for t in (0, 1)]
        planner = pkg.AuroraPlanner(cl)
        p1, p2 = planner.plan_exclusive(a), planner.plan_colocated(a, b)
        return (pkg.bruteforce_exclusive(a, 0, cl),
                pkg.bruteforce_colocated(a, b, 0, cl),
                pkg.diff_plans(p1, p2), pkg.diff_plans(p2, p1, old_time=1.0))

    assert_same(run(ref), run(port))
