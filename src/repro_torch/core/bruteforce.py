"""Brute-force optima for validating Aurora (Fig 13 / small-n tests).

Exhaustive search over expert pairings (and device assignments in the
heterogeneous case). Feasible for n <= 6 (6!^2 ~ 5.2e5 colocated evaluations);
the paper itself obtains the optimum "through brute-force search".
"""

from __future__ import annotations

import itertools

import numpy as np

from .cluster import Cluster
from .simulator import colocated_inference_time, exclusive_inference_time
from .traffic import MoETrace


def bruteforce_exclusive(
    trace: MoETrace, layer: int, cluster: Cluster
) -> tuple[float, np.ndarray]:
    """Optimal expert→device assignment by exhaustive permutation search."""
    n = trace.n
    best_t = float("inf")
    best: np.ndarray | None = None
    for perm in itertools.permutations(range(n)):
        e2d = np.asarray(perm)
        r = exclusive_inference_time(trace, layer, cluster, e2d, policy="aurora")
        if r.inference_time < best_t:
            best_t = r.inference_time
            best = e2d
    assert best is not None
    return best_t, best


def bruteforce_colocated(
    trace_a: MoETrace,
    trace_b: MoETrace,
    layer: int,
    cluster: Cluster,
    homogeneous_assignment: bool | None = None,
) -> tuple[float, list[int], np.ndarray]:
    """Optimal (pairing, assignment) by exhaustive search.

    On homogeneous clusters the device assignment is irrelevant (paper
    observation 1), so only pairings are enumerated.
    """
    n = trace_a.n
    if homogeneous_assignment is None:
        homogeneous_assignment = cluster.homogeneous
    best_t = float("inf")
    best_pair: list[int] | None = None
    best_s2d = np.arange(n)
    if homogeneous_assignment:
        assignments = [np.arange(n)]
    else:
        # Devices of the same type are interchangeable (identical bandwidth
        # and compute), so only type-distinct assignments need enumerating:
        # 6 devices in 2 tiers → 20 patterns instead of 720.
        types = [(d.bandwidth, d.compute) for d in cluster.devices]
        seen: set = set()
        assignments = []
        for p in itertools.permutations(range(n)):
            key = tuple(types[d] for d in p)
            if key in seen:
                continue
            seen.add(key)
            assignments.append(np.asarray(p))
    for pair in itertools.permutations(range(n)):
        pair = list(pair)
        for s2d in assignments:
            r = colocated_inference_time(
                trace_a, trace_b, layer, cluster, pair, s2d, policy="aurora")
            if r.inference_time < best_t:
                best_t = r.inference_time
                best_pair = pair
                best_s2d = s2d
    assert best_pair is not None
    return best_t, best_pair, best_s2d
