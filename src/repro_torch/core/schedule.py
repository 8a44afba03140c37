"""All-to-all communication scheduling (§4.2, Thm 4.2 / Thm 5.2).

Aurora's schedule is the constructive object behind Thm 4.2: augment the
traffic(-time) matrix to equal row/col sums ``b_max`` (the artificial matrix X
whose existence Farkas' lemma guarantees; we construct it directly with a
transportation-style greedy fill), then peel permutation matrices off the
augmented matrix — a Birkhoff–von-Neumann decomposition. Every slot is a
permutation, so no receiver ever hears from two senders at once (the paper's
contention-free invariant) and the total schedule length is exactly ``b_max``.

Baselines: SJF (each sender transmits its flows shortest-first) and RCS
(random order), evaluated under a max-min-fair fluid model of the big-switch
network where receiver bandwidth is shared between concurrent incoming flows
(this reproduces Fig 4's 3-units-vs-2-units example).

Heterogeneous clusters (Thm 5.2): entries are normalized to *time* by the
effective pair bandwidth ``min(B_i, B_j)`` (Appx. B) and the same machinery
applies; ``b_max`` becomes the maximum per-GPU send/receive *time*.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .errors import PlanError
from .traffic import strip_diagonal, validate_traffic

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class Slot:
    """One time slot of the schedule: a (partial) permutation.

    ``dst[i]`` is the destination device for sender ``i`` (-1 = idle, i.e.
    this sender only carried artificial traffic in this slot).
    ``duration`` is in time units (traffic units / bandwidth).
    """

    dst: tuple[int, ...]
    duration: float


@dataclasses.dataclass(frozen=True)
class CommSchedule:
    """A full contention-free schedule for one all-to-all phase."""

    slots: tuple[Slot, ...]
    b_max: float

    @property
    def total_time(self) -> float:
        return sum(s.duration for s in self.slots)

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    def sender_orders(self) -> list[list[tuple[int, float]]]:
        """Per-sender (destination, duration) sequences — the paper's
        "token transmission order" view of the schedule."""
        n = len(self.slots[0].dst) if self.slots else 0
        orders: list[list[tuple[int, float]]] = [[] for _ in range(n)]
        for s in self.slots:
            for i, j in enumerate(s.dst):
                if j >= 0:
                    orders[i].append((j, s.duration))
        return orders

    def permutations(self) -> list[tuple[tuple[int, ...], float]]:
        """(dst-array, duration) pairs: one permutation round each, the
        input of an expert-parallel round-by-round all-to-all."""
        return [(s.dst, s.duration) for s in self.slots]

    def traffic(self, n: int | None = None) -> np.ndarray:
        """Realized (time-unit) traffic matrix: per-pair sum of slot durations.

        The inverse view of ``aurora_schedule``: summing what each slot moves
        recovers (up to artificial-padding idle time) the matrix the schedule
        was decomposed from. Used to re-derive device-level BvN rounds from a
        planner ``Plan`` whose schedules live at expert granularity."""
        if n is None:
            n = len(self.slots[0].dst) if self.slots else 0
        d = np.zeros((n, n), dtype=np.float64)
        for slot in self.slots:
            for i, j in enumerate(slot.dst):
                if j >= 0:
                    d[i, j] += slot.duration
        return d


def check_partial_permutation(dst, n: int, what: str) -> tuple[int, ...]:
    """One dst vector must be a *partial permutation* of ``n`` devices.

    The shared invariant of every ppermute lowering input — schedule slots
    AND literal exchange rounds: ``dst[i]`` is sender i's receiver (-1 =
    idle), no receiver hears two senders, nobody sends to itself
    (self-traffic never crosses the network, §4.2 footnote 1), nothing
    points off the mesh. Violations silently drop or overwrite token
    buckets in flight, so they raise ``PlanError`` here instead. Returns the
    normalized tuple."""
    dst = tuple(int(j) for j in dst)
    if len(dst) != n:
        raise PlanError(f"{what}: dst has {len(dst)} entries for {n} "
                        "devices")
    seen_recv: set[int] = set()
    for i, j in enumerate(dst):
        if j < 0:
            continue  # idle sender (artificial traffic only)
        if j >= n:
            raise PlanError(f"{what}: sender {i} targets device {j} "
                            f"(out of range for {n} devices)")
        if j == i:
            raise PlanError(
                f"{what}: self-send {i}->{i} — self-traffic never crosses "
                "the network (§4.2 footnote 1) and must be marked idle (-1)")
        if j in seen_recv:
            raise PlanError(
                f"{what}: receiver {j} is targeted by two senders — not a "
                "(partial) permutation; lowering it to ppermute would "
                "silently misroute one bucket")
        seen_recv.add(j)
    return dst


def validate_permutation_slots(slots, n: int) -> None:
    """Explicit error for non-permutation slots instead of silent misrouting.

    ``aurora_schedule`` only emits valid slots; hand-built or corrupted
    schedules fail loudly (``PlanError``) here before the ppermute lowering
    trusts them.
    """
    if n <= 0:
        raise PlanError(f"schedule needs a positive device count, got {n}")
    for s_i, slot in enumerate(slots):
        check_partial_permutation(slot.dst, n, f"slot {s_i}")


def time_matrix(d: np.ndarray, bandwidths: np.ndarray | None = None) -> np.ndarray:
    """Traffic → time units. Pair (i, j) moves at ``min(B_i, B_j)`` (Appx. B)."""
    d = strip_diagonal(d)
    n = d.shape[0]
    if bandwidths is None:
        return d
    b = np.asarray(bandwidths, dtype=np.float64)
    if b.shape != (n,):
        raise ValueError("bandwidths must have one entry per device")
    pair_bw = np.minimum(b[:, None], b[None, :])
    return d / pair_bw


def b_max_of(d: np.ndarray, bandwidths: np.ndarray | None = None) -> float:
    t = time_matrix(d, bandwidths)
    return float(max(t.sum(axis=1).max(initial=0.0), t.sum(axis=0).max(initial=0.0)))


def augment_to_bmax(t: np.ndarray) -> tuple[np.ndarray, float]:
    """Construct D' = D + X with every row/col sum equal to b_max (Appx. A step 1).

    Farkas' lemma proves a non-negative X exists; we build one constructively
    with a northwest-corner-style fill over the row/col deficits (total row
    deficit equals total column deficit, so the fill always completes).
    Artificial traffic may sit on the diagonal — in the final schedule those
    entries are simply idle slots for that sender.
    """
    t = validate_traffic(t)
    n = t.shape[0]
    rows = t.sum(axis=1)
    cols = t.sum(axis=0)
    b_max = float(max(rows.max(initial=0.0), cols.max(initial=0.0)))
    r_def = b_max - rows
    c_def = b_max - cols
    x = np.zeros_like(t)
    i = j = 0
    while i < n and j < n:
        if r_def[i] <= _EPS:
            i += 1
            continue
        if c_def[j] <= _EPS:
            j += 1
            continue
        add = min(r_def[i], c_def[j])
        x[i, j] += add
        r_def[i] -= add
        c_def[j] -= add
    d_prime = t + x
    return d_prime, b_max


def aurora_schedule(
    d: np.ndarray, bandwidths: np.ndarray | None = None
) -> CommSchedule:
    """Thm 4.2 / 5.2 constructive schedule via BvN decomposition.

    Returns a schedule of at most n^2 - 2n + 2 permutation slots whose total
    duration is exactly ``b_max`` and in which no two senders ever target the
    same receiver simultaneously.
    """
    from .matching import perfect_matching

    t = time_matrix(d, bandwidths)
    n = t.shape[0]
    # Clean negligible entries BEFORE augmenting: a crumb of ~1e-9·b_max has
    # no matching partner once the big entries are peeled off (it breaks
    # Hall's condition on the positive mask) yet changes the schedule length
    # by nothing. Cleaning first keeps the augmented matrix exactly
    # doubly-balanced, which is what the BvN peeling relies on.
    pre = float(max(t.sum(axis=1).max(initial=0.0),
                    t.sum(axis=0).max(initial=0.0)))
    if pre <= _EPS:
        return CommSchedule(slots=(), b_max=0.0)
    t = np.where(t > 1e-9 * pre, t, 0.0)
    real = t > 0.0  # which (i, j) carry real traffic
    d_prime, b_max = augment_to_bmax(t)
    if b_max <= _EPS:
        return CommSchedule(slots=(), b_max=0.0)

    slots: list[Slot] = []
    remaining = d_prime.copy()
    tol = 1e-12 * b_max  # subtraction round-off, far below any real entry
    # Each iteration zeroes at least one positive entry; entries never
    # increase, so this terminates in <= n^2 iterations.
    for _ in range(n * n + 1):
        remaining[remaining <= tol] = 0.0
        if remaining.sum() <= tol * n * n:
            break
        positive = remaining > 0.0
        match = perfect_matching(positive)
        if match is None:
            # Numerically degenerate remainder (should not happen after the
            # input cleaning): schedule leftover entries one pair per slot.
            # Costs at most the leftover mass, which is O(n²·tol).
            for i, j in zip(*np.nonzero(positive)):
                dst = [-1] * n
                dst[i] = int(j)
                if real[i, j] and i != j:
                    slots.append(Slot(dst=tuple(dst),
                                      duration=float(remaining[i, j])))
                remaining[i, j] = 0.0
            break
        delta = float(min(remaining[i, match[i]] for i in range(n)))
        dst = []
        for i in range(n):
            j = match[i]
            remaining[i, j] -= delta
            # Idle if this edge was purely artificial or a diagonal self-edge.
            dst.append(j if (real[i, j] and i != j) else -1)
        slots.append(Slot(dst=tuple(dst), duration=delta))
    else:
        raise RuntimeError("BvN decomposition did not terminate")

    # Drop slots where every sender is idle (pure artificial traffic).
    slots = [s for s in slots if any(j >= 0 for j in s.dst)]
    # Merge adjacent slots with identical destination patterns (beyond-paper
    # cleanup: fewer rounds for the ppermute lowering, same total time).
    merged: list[Slot] = []
    for s in slots:
        if merged and merged[-1].dst == s.dst:
            merged[-1] = Slot(dst=s.dst, duration=merged[-1].duration + s.duration)
        else:
            merged.append(s)
    return CommSchedule(slots=tuple(merged), b_max=b_max)


def algorithm1_order(
    d: np.ndarray, bandwidths: np.ndarray | None = None, seed: int = 0
) -> list[list[tuple[int, float]]]:
    """Alg. 1 (paper's greedy sketch): per-sender destination orders.

    Identify the bottleneck GPU, give it a random continuous order, then
    arrange remaining senders (descending traffic) around the existing
    commitments. We realize "avoid conflicts" by simulating slot occupancy.
    This is the paper's heuristic; ``aurora_schedule`` is the constructive
    optimum that the proof of Thm 4.2 actually builds, and is what the
    planner uses. Exposed for completeness and comparison.
    """
    sched = aurora_schedule(d, bandwidths)
    return sched.sender_orders()


# ---------------------------------------------------------------------------
# Baseline orders + fluid network evaluation
# ---------------------------------------------------------------------------

Order = list[list[tuple[int, float]]]  # per-sender [(dst, size-in-traffic-units)]


def _flows_from_matrix(d: np.ndarray) -> Order:
    d = strip_diagonal(d)
    n = d.shape[0]
    return [
        [(j, float(d[i, j])) for j in range(n) if d[i, j] > _EPS] for i in range(n)
    ]


def sjf_order(d: np.ndarray) -> Order:
    """Shortest-job-first: each sender transmits its smallest flows first."""
    flows = _flows_from_matrix(d)
    return [sorted(f, key=lambda x: x[1]) for f in flows]


def rcs_order(d: np.ndarray, seed: int = 0) -> Order:
    """Random communication scheduling."""
    rng = np.random.default_rng(seed)
    flows = _flows_from_matrix(d)
    out = []
    for f in flows:
        f = list(f)
        rng.shuffle(f)
        out.append(f)
    return out


def fluid_comm_time(
    order: Order, bandwidths: np.ndarray | float = 1.0, n: int | None = None
) -> float:
    """Max-min-fair fluid simulation of the big-switch network.

    Each sender transmits its flows strictly in the given order, one at a
    time, at up to its link bandwidth. A receiver's bandwidth is shared
    max-min-fairly among concurrent incoming flows. This reproduces the
    contention behaviour of Fig 4: two senders targeting one receiver halve
    each other's rates.
    """
    if n is None:
        n = len(order)
    if np.isscalar(bandwidths):
        bw = np.full(n, float(bandwidths))
    else:
        bw = np.asarray(bandwidths, dtype=np.float64)
    queues = [list(f) for f in order]
    head = [0] * n
    rem = [queues[i][0][1] if queues[i] else 0.0 for i in range(n)]
    t = 0.0
    for _ in range(10_000_000):  # safety bound
        active = [i for i in range(n) if head[i] < len(queues[i])]
        if not active:
            return t
        # Max-min fair rate allocation by progressive filling. Constraints:
        # sender i carries one active flow capped at bw[i]; receiver j's
        # incoming flows share bw[j].
        recv_of = {i: queues[i][head[i]][0] for i in active}
        rates = {i: 0.0 for i in active}
        unfrozen = set(active)
        while unfrozen:
            # Smallest headroom-per-unfrozen-flow across all constraints.
            inc = min(
                min(bw[i] - rates[i] for i in unfrozen),  # sender constraints
                min(  # receiver constraints
                    (bw[j] - sum(rates[i] for i in active if recv_of[i] == j))
                    / sum(1 for i in unfrozen if recv_of[i] == j)
                    for j in {recv_of[i] for i in unfrozen}
                ),
            )
            inc = max(inc, 0.0)
            for i in unfrozen:
                rates[i] += inc
            # Freeze flows touching any now-tight constraint.
            newly = {i for i in unfrozen if rates[i] >= bw[i] - 1e-12}
            for j in {recv_of[i] for i in unfrozen}:
                if sum(rates[i] for i in active if recv_of[i] == j) >= bw[j] - 1e-12:
                    newly.update(i for i in unfrozen if recv_of[i] == j)
            if not newly:  # numerical guard; should not happen
                break
            unfrozen -= newly
        # Advance to the next flow completion.
        dt = min(
            rem[i] / rates[i] for i in active if rates[i] > _EPS
        ) if any(rates[i] > _EPS for i in active) else None
        if dt is None:
            raise RuntimeError("fluid simulation deadlock (all rates zero)")
        t += dt
        for i in active:
            rem[i] -= rates[i] * dt
            if rem[i] <= 1e-9:
                head[i] += 1
                rem[i] = queues[i][head[i]][1] if head[i] < len(queues[i]) else 0.0
    raise RuntimeError("fluid simulation did not terminate")


def comm_time(
    d: np.ndarray,
    policy: str = "aurora",
    bandwidths: np.ndarray | None = None,
    seed: int = 0,
) -> float:
    """Communication time of one all-to-all under a scheduling policy."""
    d = strip_diagonal(d)
    n = d.shape[0]
    bw = np.ones(n) if bandwidths is None else np.asarray(bandwidths, float)
    if policy == "aurora":
        # Thm 4.2/5.2: the schedule achieves exactly b_max, so the TIME
        # needs no schedule construction (the constructive BvN decomposition
        # is only needed for the transmission order itself). The equality is
        # asserted property-tested in tests/test_properties.py.
        return b_max_of(d, bw)
    if policy == "sjf":
        return fluid_comm_time(sjf_order(d), bw, n)
    if policy == "rcs":
        return fluid_comm_time(rcs_order(d, seed), bw, n)
    raise ValueError(f"unknown policy {policy!r}")
