"""GPU assignment for heterogeneous clusters (§5, Thm 5.1).

Sort experts by token load (tokens processed = received traffic) in
descending order; assign to devices from highest to lowest performance.
The baseline is random GPU assignment (RGA, §8.1).
"""

from __future__ import annotations

import numpy as np

from .cluster import Cluster
from .traffic import strip_diagonal


def expert_loads(d: np.ndarray) -> np.ndarray:
    """Tokens each expert processes = column sums of the dispatch matrix
    (tokens routed *to* that expert, excluding free self-traffic)."""
    return strip_diagonal(d).sum(axis=0)


def aurora_assignment(d: np.ndarray, cluster: Cluster) -> np.ndarray:
    """Thm 5.1: experts sorted by load desc → devices sorted by perf desc.

    Returns ``expert_to_device`` with entry e = device index hosting expert e.
    """
    loads = expert_loads(d)
    n = len(loads)
    if cluster.n != n:
        raise ValueError(f"cluster has {cluster.n} devices for {n} experts")
    experts_by_load = np.argsort(-loads, kind="stable")
    devices_by_perf = cluster.sorted_indices_by_performance()
    e2d = np.empty(n, dtype=np.int64)
    for rank, e in enumerate(experts_by_load):
        e2d[e] = devices_by_perf[rank]
    return e2d


def random_assignment(n: int, seed: int = 0) -> np.ndarray:
    """RGA baseline."""
    rng = np.random.default_rng(seed)
    return rng.permutation(n)


def apply_assignment(d: np.ndarray, expert_to_device: np.ndarray) -> np.ndarray:
    """Permute an expert-indexed traffic matrix into device space.

    Traffic from (the device hosting) expert i to (the device hosting)
    expert j becomes device-level traffic e2d[i] -> e2d[j].
    """
    d = np.asarray(d, dtype=np.float64)
    e2d = np.asarray(expert_to_device)
    out = np.zeros_like(d)
    out[np.ix_(e2d, e2d)] = d
    return out
