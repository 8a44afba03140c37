"""Expert colocation across two MoE models (§6).

Aurora colocates one expert of model *a* with one expert of model *b* on each
device so that compute of one interleaves with communication of the other
(Fig 3b). The colocation choice determines the aggregated traffic matrix and
hence, via Thm 4.2, the aggregated communication time; Thm 6.1 shows that
minimizing that time minimizes inference time on homogeneous clusters.

- Case I (per-device send == recv): Thm 6.2 sort-ascending/descending pairing.
- Case II (general): bottleneck matching with weight
  ``max(a_i + b_j, a_{n+i} + b_{n+j})``.
- Baselines: Lina-style same-model packing (popular-with-unpopular within one
  model) and REC (random cross-model pairing).
"""

from __future__ import annotations

import numpy as np

from .matching import bottleneck_perfect_matching
from .traffic import strip_diagonal


def send_recv_vectors(d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    d = strip_diagonal(d)
    return d.sum(axis=1), d.sum(axis=0)


def case1_pairing(a_tot: np.ndarray, b_tot: np.ndarray) -> list[int]:
    """Thm 6.2: sort ``a`` ascending, ``b`` descending, pair sequentially.

    Applicable when send == recv per device, so each expert is described by a
    single scalar. Returns ``pair[i]`` = index of model-b expert colocated
    with model-a expert i.
    """
    a_tot = np.asarray(a_tot, dtype=np.float64)
    b_tot = np.asarray(b_tot, dtype=np.float64)
    n = len(a_tot)
    a_order = np.argsort(a_tot, kind="stable")          # ascending
    b_order = np.argsort(-b_tot, kind="stable")         # descending
    pair = [-1] * n
    for ai, bi in zip(a_order, b_order):
        pair[ai] = int(bi)
    return pair


def case2_pairing(da: np.ndarray, db: np.ndarray) -> tuple[list[int], float]:
    """§6.2 Case II: bottleneck matching on the full bipartite graph.

    Edge (i, j) weight = max(send_a[i] + send_b[j], recv_a[i] + recv_b[j]),
    the per-device bottleneck (max of aggregate send and aggregate receive)
    if a-expert i and b-expert j share a device. Returns (pair, w*) where w*
    is the minimized maximum row/col sum of the aggregated matrix — i.e. the
    aggregated ``b_max`` (bandwidth 1).
    """
    sa, ra = send_recv_vectors(da)
    sb, rb = send_recv_vectors(db)
    w = np.maximum(sa[:, None] + sb[None, :], ra[:, None] + rb[None, :])
    return bottleneck_perfect_matching(w)


def aurora_pairing(da: np.ndarray, db: np.ndarray) -> list[int]:
    """Dispatch: Case I fast path when send==recv everywhere, else Case II."""
    sa, ra = send_recv_vectors(da)
    sb, rb = send_recv_vectors(db)
    if np.allclose(sa, ra) and np.allclose(sb, rb):
        return case1_pairing(sa, sb)
    pair, _ = case2_pairing(da, db)
    return pair


def random_pairing(n: int, seed: int = 0) -> list[int]:
    """REC baseline: random cross-model expert pairing."""
    rng = np.random.default_rng(seed)
    return list(rng.permutation(n))


def aggregate_traffic(
    da: np.ndarray, db: np.ndarray, pair: list[int]
) -> np.ndarray:
    """Aggregated device-level traffic matrix D_new for a colocation choice.

    Device i hosts a-expert i and b-expert pair[i]; model b's traffic is
    re-indexed into device space and summed with model a's.
    """
    da = strip_diagonal(da)
    db = strip_diagonal(db)
    p = np.asarray(pair)
    # b-expert pair[i] lives on device i  =>  device-level b-traffic
    # D_b_dev[i, j] = db[pair[i], pair[j]].
    db_dev = db[np.ix_(p, p)]
    return da + db_dev


# -- multi-tenant (N > 2) grouping -----------------------------------------
#
# Nothing in Thm 6.1/6.2 is specific to two models: colocating one expert of
# each of N tenants per device aggregates their traffic, and minimizing the
# aggregated b_max still minimizes inference time on homogeneous clusters.
# The N-way assignment problem (an N-dimensional matching, NP-hard for N>=3)
# is decoupled exactly like §7.2 decouples case 4: fold tenants in one at a
# time, bottleneck-matching the next tenant's experts against the groups
# built so far. Each fold is the paper's case-I/case-II pairing with the
# current aggregate playing the role of "model a".

def aurora_grouping(traffics: list[np.ndarray],
                    use_case1: bool = True) -> list[tuple[int, ...]]:
    """Greedy k-way expert grouping over N tenants' traffic matrices.

    Returns ``groups`` with ``groups[g][t]`` = the tenant-t expert hosted on
    device slot g; tenant 0 anchors the slots (``groups[g][0] == g``). Each
    fold uses the Thm 6.2 sort-pairing fast path when send == recv for both
    the aggregate and the incoming tenant (``use_case1``), else bottleneck
    matching with the case-II weight. For two tenants this reproduces
    ``aurora_pairing`` exactly.
    """
    if not traffics:
        raise ValueError("aurora_grouping needs at least one tenant")
    mats = [strip_diagonal(d) for d in traffics]
    n = mats[0].shape[0]
    for d in mats:
        if d.shape != (n, n):
            raise ValueError("all tenants must have equal expert counts "
                             f"(got {[m.shape[0] for m in mats]})")
    groups = [[g] for g in range(n)]
    agg = mats[0].copy()
    for dt in mats[1:]:
        s_agg, r_agg = agg.sum(axis=1), agg.sum(axis=0)
        s_t, r_t = dt.sum(axis=1), dt.sum(axis=0)
        if (use_case1 and np.allclose(s_agg, r_agg)
                and np.allclose(s_t, r_t)):
            pair = case1_pairing(s_agg, s_t)
        else:
            w = np.maximum(s_agg[:, None] + s_t[None, :],
                           r_agg[:, None] + r_t[None, :])
            pair, _ = bottleneck_perfect_matching(w)
        p = np.asarray(pair)
        agg = agg + dt[np.ix_(p, p)]
        for g in range(n):
            groups[g].append(int(pair[g]))
    return [tuple(g) for g in groups]


def random_grouping(n: int, n_tenants: int,
                    seed: int = 0) -> list[tuple[int, ...]]:
    """REC baseline generalized: tenant 0 anchors slots, every other tenant's
    experts land on uniformly random slots."""
    rng = np.random.default_rng(seed)
    perms = [np.arange(n)] + [rng.permutation(n)
                              for _ in range(n_tenants - 1)]
    return [tuple(int(perms[t][g]) for t in range(n_tenants))
            for g in range(n)]


def group_pairs(groups: list[tuple[int, ...]]) -> list[list[int]]:
    """Per-tenant slot->expert permutations of a grouping: ``out[t][g]`` is
    the tenant-t expert on slot g (``out[0]`` is the identity anchor)."""
    if not groups:
        return []
    return [[g[t] for g in groups] for t in range(len(groups[0]))]


def aggregate_traffic_multi(traffics: list[np.ndarray],
                            groups: list[tuple[int, ...]]) -> np.ndarray:
    """Device-level traffic aggregated over N colocated tenants.

    Slot g hosts expert ``groups[g][t]`` of each tenant t; every tenant's
    matrix is re-indexed into slot space and summed. For two tenants with
    ``groups[g] == (g, pair[g])`` this equals ``aggregate_traffic``.
    """
    mats = [strip_diagonal(d) for d in traffics]
    n = mats[0].shape[0]
    agg = np.zeros((n, n))
    for t, dt in enumerate(mats):
        p = np.asarray([g[t] for g in groups])
        agg += dt[np.ix_(p, p)]
    return agg


def lina_packing(d: np.ndarray) -> tuple[np.ndarray, list[tuple[int, int]]]:
    """Lina-style same-model packing: two experts of ONE model per device.

    Pairs the most popular expert with the least popular (the paper's
    description of Lina's placement), producing an n/2-device deployment.
    Returns (merged n/2 x n/2 traffic matrix, expert pairs).
    """
    d = strip_diagonal(d)
    n = d.shape[0]
    if n % 2 != 0:
        raise ValueError("lina packing needs an even expert count")
    loads = d.sum(axis=0)
    order = np.argsort(-loads, kind="stable")
    pairs = [(int(order[k]), int(order[n - 1 - k])) for k in range(n // 2)]
    # Merge traffic of paired experts into single devices.
    group = np.empty(n, dtype=np.int64)
    for g, (e1, e2) in enumerate(pairs):
        group[e1] = g
        group[e2] = g
    m = n // 2
    merged = np.zeros((m, m))
    for i in range(n):
        for j in range(n):
            merged[group[i], group[j]] += d[i, j]
    np.fill_diagonal(merged, 0.0)  # colocated experts exchange on-device
    return merged, pairs
