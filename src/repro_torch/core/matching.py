"""Bipartite matching primitives used throughout Aurora.

- Hopcroft–Karp maximum matching (O(E*sqrt(V))), used both by the BvN
  decomposition in ``schedule.py`` (perfect matchings on positive-entry
  graphs) and by the bottleneck matching solver.
- Bottleneck perfect matching (§6.2 Case II): binary search on the sorted
  edge weights for the smallest threshold admitting a perfect matching,
  overall O(n^2 * sqrt(n) * log n) exactly as the paper describes.
"""

from __future__ import annotations

import numpy as np

_INF = float("inf")


def hopcroft_karp(adj: list[list[int]], n_left: int, n_right: int) -> tuple[int, list[int]]:
    """Maximum bipartite matching.

    ``adj[u]`` lists right-side neighbours of left node ``u``.
    Returns (matching size, match_left) where ``match_left[u]`` is the right
    node matched to ``u`` or -1.
    """
    match_l = [-1] * n_left
    match_r = [-1] * n_right
    size = 0
    while True:
        # BFS: layer the graph from free left vertices.
        dist = [_INF] * n_left
        queue = [u for u in range(n_left) if match_l[u] == -1]
        for u in queue:
            dist[u] = 0
        found_free = False
        qi = 0
        while qi < len(queue):
            u = queue[qi]
            qi += 1
            for v in adj[u]:
                w = match_r[v]
                if w == -1:
                    found_free = True
                elif dist[w] == _INF:
                    dist[w] = dist[u] + 1
                    queue.append(w)
        if not found_free:
            break

        # DFS augmentation along layered paths (iterative to dodge recursion
        # limits on large graphs).
        iters = [0] * n_left

        def try_augment(root: int) -> bool:
            stack = [root]
            path: list[tuple[int, int]] = []  # (left, right) tentative edges
            while stack:
                u = stack[-1]
                advanced = False
                while iters[u] < len(adj[u]):
                    v = adj[u][iters[u]]
                    iters[u] += 1
                    w = match_r[v]
                    if w == -1:
                        # Augment along the path.
                        path.append((u, v))
                        for pu, pv in path:
                            match_l[pu] = pv
                            match_r[pv] = pu
                        return True
                    if dist[w] == dist[u] + 1:
                        path.append((u, v))
                        stack.append(w)
                        advanced = True
                        break
                if not advanced:
                    dist[u] = _INF
                    stack.pop()
                    if path:
                        path.pop()
            return False

        progressed = 0
        for u in range(n_left):
            if match_l[u] == -1 and try_augment(u):
                progressed += 1
        if progressed == 0:
            break
        size += progressed
    return size, match_l


def has_perfect_matching(allowed: np.ndarray) -> bool:
    n = allowed.shape[0]
    adj = [np.flatnonzero(allowed[u]).tolist() for u in range(n)]
    size, _ = hopcroft_karp(adj, n, n)
    return size == n


def perfect_matching(allowed: np.ndarray) -> list[int] | None:
    """Perfect matching on an n x n boolean adjacency, or None."""
    n = allowed.shape[0]
    adj = [np.flatnonzero(allowed[u]).tolist() for u in range(n)]
    size, match_l = hopcroft_karp(adj, n, n)
    return match_l if size == n else None


def bottleneck_perfect_matching(weights: np.ndarray) -> tuple[list[int], float]:
    """Perfect matching minimizing the maximum edge weight (§6.2 Case II).

    ``weights`` is a full n x n matrix (complete bipartite graph). Returns
    (match, w*) with ``match[i]`` = right node paired with left node ``i``.
    Binary search over the sorted distinct weights; feasibility by
    Hopcroft–Karp on the thresholded subgraph.
    """
    w = np.asarray(weights, dtype=np.float64)
    n = w.shape[0]
    if w.shape != (n, n):
        raise ValueError(f"weights must be square, got {w.shape}")
    uniq = np.unique(w)
    lo, hi = 0, len(uniq) - 1
    # The complete graph always has a perfect matching at the max weight.
    best = uniq[hi]
    while lo <= hi:
        mid = (lo + hi) // 2
        if has_perfect_matching(w <= uniq[mid]):
            best = uniq[mid]
            hi = mid - 1
        else:
            lo = mid + 1
    match = perfect_matching(w <= best)
    assert match is not None
    return match, float(best)
