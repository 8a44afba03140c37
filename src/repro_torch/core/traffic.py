"""Traffic matrices for MoE all-to-all phases.

The paper's inputs (§3, Table 1) are per-layer traffic matrices ``D_N`` (first
all-to-all: token dispatch) and ``D_C`` (second: expert-output return), with
``D_C = D_N^T`` because the two phases are exact reverses (§2.2) and FFN
preserves token count.

This module builds traffic matrices from routing decisions and provides the
synthetic "production-like" trace generator used by the evaluation (the Google
LIMoE traces the paper uses are not redistributable).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def validate_traffic(d: np.ndarray) -> np.ndarray:
    d = np.asarray(d, dtype=np.float64)
    if d.ndim != 2 or d.shape[0] != d.shape[1]:
        raise ValueError(f"traffic matrix must be square, got {d.shape}")
    if (d < 0).any():
        raise ValueError("traffic matrix must be non-negative")
    return d


def strip_diagonal(d: np.ndarray) -> np.ndarray:
    """Footnote 1 (§4.2): self-traffic never crosses the network."""
    d = validate_traffic(d).copy()
    np.fill_diagonal(d, 0.0)
    return d


def traffic_from_routing(
    token_source: np.ndarray, expert_choice: np.ndarray, n_devices: int,
    expert_to_device: np.ndarray | None = None, token_bytes: float = 1.0,
) -> np.ndarray:
    """Build ``D_N`` from per-token routing decisions.

    token_source: (T,) device hosting each token; expert_choice: (T, k) chosen
    expert ids; expert_to_device: (E,) placement map (identity by default,
    i.e. expert e on device e % n_devices).
    """
    token_source = np.asarray(token_source)
    expert_choice = np.asarray(expert_choice)
    if expert_choice.ndim == 1:
        expert_choice = expert_choice[:, None]
    n_experts = int(expert_choice.max()) + 1 if expert_choice.size else 0
    if expert_to_device is None:
        expert_to_device = np.arange(n_experts) % n_devices
    dest = np.asarray(expert_to_device)[expert_choice]  # (T, k)
    d = np.zeros((n_devices, n_devices), dtype=np.float64)
    np.add.at(d, (np.repeat(token_source, expert_choice.shape[1]), dest.ravel()),
              token_bytes)
    return strip_diagonal(d)


def validate_replication(replicas, n: int) -> tuple[tuple[int, ...], ...]:
    """Normalize/validate a per-expert replica placement.

    ``replicas[e]`` lists the devices hosting a copy of expert e, HOME device
    first (the planner world puts expert e's home on device e, the identity
    placement every trace uses). Every entry must be a non-empty sequence of
    distinct device ids in ``range(n)`` starting with ``e``.
    """
    if len(replicas) != n:
        raise ValueError(f"replication needs one host tuple per expert "
                         f"({n}), got {len(replicas)}")
    out = []
    for e, hosts in enumerate(replicas):
        hosts = tuple(int(h) for h in hosts)
        if not hosts or hosts[0] != e:
            raise ValueError(f"replicas[{e}] must start with the home device "
                             f"{e}, got {hosts}")
        if len(set(hosts)) != len(hosts):
            raise ValueError(f"replicas[{e}] has duplicate hosts: {hosts}")
        if any(h < 0 or h >= n for h in hosts):
            raise ValueError(f"replicas[{e}] out of range(n={n}): {hosts}")
        out.append(hosts)
    return tuple(out)


def replicated_traffic(d: np.ndarray, replicas) -> np.ndarray:
    """Replica-aware device traffic for one all-to-all phase.

    Tokens bound for expert e split EVENLY across its replica hosts — the
    deterministic shard-of-token rule (routed rank r of expert e goes to
    replica ``r % r_e``), which distributes any source's flow uniformly.
    A replica hosted on the token's own source device absorbs its 1/r_e
    share locally (footnote 1: self-traffic never crosses the network), so
    replication cuts both the hot column AND total network bytes.
    """
    d = validate_traffic(d)
    n = d.shape[0]
    replicas = validate_replication(replicas, n)
    out = np.zeros_like(d)
    for e, hosts in enumerate(replicas):
        share = d[:, e] / len(hosts)
        for h in hosts:
            out[:, h] += share
    return strip_diagonal(out)


def replicated_ffn_loads(d: np.ndarray, replicas) -> np.ndarray:
    """Per-device expert-FFN token load under a replica placement.

    Unlike the network matrix, FFN load counts the locally-absorbed shares
    too — a replica still computes the tokens it keeps off the wire.
    """
    d = validate_traffic(d)
    n = d.shape[0]
    replicas = validate_replication(replicas, n)
    loads = np.zeros(n)
    for e, hosts in enumerate(replicas):
        share = d[:, e].sum() / len(hosts)
        for h in hosts:
            loads[h] += share
    return loads


def identity_replication(n: int) -> tuple[tuple[int], ...]:
    """The no-replication placement: every expert only on its home device."""
    return tuple((e,) for e in range(n))


def validate_degraded_hosts(hosts, n_experts: int,
                            m: int) -> tuple[tuple[int, ...], ...]:
    """Normalize/validate a survivor-frame host map.

    Unlike ``validate_replication`` — which lives in the one-device-per-
    expert frame and pins each expert's home to its own index — a degraded
    map places ``n_experts`` logical experts on ``m <= n_experts`` surviving
    devices: ``hosts[e]`` is a non-empty tuple of distinct survivor indices
    in ``range(m)``, home (the copy routing falls back to) first, with no
    home constraint since the expert↔device bijection is gone.
    """
    if len(hosts) != n_experts:
        raise ValueError(f"degraded hosts need one tuple per expert "
                         f"({n_experts}), got {len(hosts)}")
    out = []
    for e, hs in enumerate(hosts):
        hs = tuple(int(h) for h in hs)
        if not hs:
            raise ValueError(f"hosts[{e}] is empty — expert {e} has no "
                             "surviving copy")
        if len(set(hs)) != len(hs):
            raise ValueError(f"hosts[{e}] has duplicate devices: {hs}")
        if any(h < 0 or h >= m for h in hs):
            raise ValueError(f"hosts[{e}] out of range({m} survivors): {hs}")
        out.append(hs)
    return tuple(out)


def degraded_traffic(d: np.ndarray, hosts, sources,
                     m: int) -> np.ndarray:
    """Device traffic of a survivor-only deployment, ``(m, m)``.

    ``d`` is the expert-frame matrix (source device i → expert e tokens,
    one row per ORIGINAL device); ``sources[i]`` is the survivor that
    inherited original device i's tokens (i's own survivor index when it
    survived); ``hosts[e]`` lists the survivors computing expert e, tokens
    splitting evenly across copies (same shard-of-token rule as
    ``replicated_traffic``). Self-shares stay off the wire (§4.2 fn 1).
    """
    d = validate_traffic(d)
    n = d.shape[0]
    hosts = validate_degraded_hosts(hosts, n, m)
    src = [int(s) for s in sources]
    if len(src) != n or any(s < 0 or s >= m for s in src):
        raise ValueError(f"sources must map {n} original devices into "
                         f"range({m} survivors), got {sources}")
    row_agg = np.zeros((m, n))
    for i, s in enumerate(src):
        row_agg[s] += d[i]
    out = np.zeros((m, m))
    for e, hs in enumerate(hosts):
        share = row_agg[:, e] / len(hs)
        for h in hs:
            out[:, h] += share
    return strip_diagonal(out)


def degraded_ffn_loads(d: np.ndarray, hosts, m: int) -> np.ndarray:
    """Per-survivor FFN token load; locally-absorbed shares still count."""
    d = validate_traffic(d)
    n = d.shape[0]
    hosts = validate_degraded_hosts(hosts, n, m)
    loads = np.zeros(m)
    for e, hs in enumerate(hosts):
        share = d[:, e].sum() / len(hs)
        for h in hs:
            loads[h] += share
    return loads


def row_col_sums(d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    d = validate_traffic(d)
    return d.sum(axis=1), d.sum(axis=0)


def b_max_homogeneous(d: np.ndarray, bandwidth: float = 1.0) -> float:
    """Thm 4.2: minimum all-to-all time = max(row sum, col sum) / B."""
    rows, cols = row_col_sums(strip_diagonal(d))
    return float(max(rows.max(initial=0.0), cols.max(initial=0.0))) / bandwidth


def b_max_heterogeneous(d: np.ndarray, bandwidths: np.ndarray) -> float:
    """Thm 5.2: minimum time = max_i(row_i/B_i, col_i/B_i)."""
    rows, cols = row_col_sums(strip_diagonal(d))
    b = np.asarray(bandwidths, dtype=np.float64)
    if b.shape != rows.shape:
        raise ValueError("bandwidths must have one entry per device")
    return float(max((rows / b).max(initial=0.0), (cols / b).max(initial=0.0)))


@dataclasses.dataclass(frozen=True)
class MoETrace:
    """A per-layer trace of one MoE model, LIMoE-style (§8.1).

    ``layers[l]`` is the first-all-to-all traffic matrix ``D_N`` of layer l.
    The second all-to-all is its transpose. ``gate``, ``ffn_per_token`` and
    ``agg`` are computation times on the *reference* device (compute=1.0);
    heterogeneous devices scale them by 1/compute.
    """

    name: str
    layers: tuple[np.ndarray, ...]
    gate: float
    ffn_per_token: float
    agg: float
    ffn_fixed: float = 0.0  # weight-load / launch cost, independent of tokens
    # (at inference batch sizes the expert FFN is often memory-bound on its
    # weights, so a model with 4x fewer tokens does NOT run 4x faster)

    @property
    def n(self) -> int:
        return self.layers[0].shape[0]

    def layer(self, l: int) -> np.ndarray:
        return self.layers[l]

    def ffn_time(self, tokens) -> float:
        return self.ffn_fixed + self.ffn_per_token * tokens


def synthetic_trace(
    name: str,
    n_experts: int = 8,
    n_layers: int = 4,
    tokens_per_device: float = 1024.0,
    skew: float = 1.2,
    gate: float = 0.08,
    ffn_per_token: float = 0.004,
    agg: float = 0.05,
    ffn_fixed: float = 0.0,
    seed: int = 0,
) -> MoETrace:
    """Skewed expert-popularity traces mimicking production MoE routing.

    Expert popularity per layer follows a Dirichlet draw sharpened by a
    Zipf-like rank profile (production MoE routing is heavy-tailed: a few hot
    experts draw most tokens [Fedus+22, Huang+23]). Each device contributes
    ``tokens_per_device`` tokens, split across destination experts by the
    popularity vector with per-source multiplicative noise.
    """
    rng = np.random.default_rng(seed)
    layers = []
    # The second all-to-all returns expert outputs to the token's home
    # device before the next layer starts (§2.1 "ensuring the original
    # sequences are organized"), so every layer's senders hold the same
    # ~uniform resident token count; only the receive side is skewed by
    # expert popularity.
    tok = np.full(n_experts, float(tokens_per_device))
    for _ in range(n_layers):
        # Zipf-like rank profile with a concentrated Dirichlet perturbation:
        # production routers are load-balance regularized, so popularity is
        # heavy-tailed but not degenerate (max/mean ~ 1.3-2x for skew ~0.2-1).
        rank = np.arange(1, n_experts + 1, dtype=np.float64) ** (-skew)
        base = rank / rank.sum()
        pop = rng.dirichlet(base * 150.0 * n_experts)
        rng.shuffle(pop)  # hot expert is not always expert 0
        d = np.zeros((n_experts, n_experts))
        for src in range(n_experts):
            noise = rng.lognormal(mean=0.0, sigma=0.12, size=n_experts)
            w = pop * noise
            w = w / w.sum()
            d[src] = tok[src] * w
        layers.append(strip_diagonal(d))
    return MoETrace(name=name, layers=tuple(layers), gate=gate,
                    ffn_per_token=ffn_per_token, agg=agg, ffn_fixed=ffn_fixed)


def trace_from_counts(
    name: str,
    counts: np.ndarray,
    tokens_per_device: float = 1024.0,
    gate: float = 0.08,
    ffn_per_token: float = 0.004,
    agg: float = 0.05,
    ffn_fixed: float = 0.0,
) -> MoETrace:
    """Build a ``MoETrace`` from live per-layer expert routing counts.

    ``counts``: (n_layers, E) routed-choice counts (or rates) per expert, as
    harvested by ``serving.monitor.TrafficMonitor`` from engine steps.
    Each expert sits on its own device (identity placement, n = E — the same
    convention the planner's traces use). Token sources are modeled as
    uniform across devices — the §2.1 return all-to-all restores ~uniform
    resident token counts every layer, so only the receive side carries the
    popularity skew: ``d[src, dst] = pop[dst] * tokens_per_device``.

    Layers whose counts are all zero (not yet observed) fall back to uniform
    popularity. Absolute scale is set by ``tokens_per_device`` so live traces
    are comparable with ``synthetic_trace`` outputs.
    """
    counts = np.asarray(counts, dtype=np.float64)
    if counts.ndim != 2:
        raise ValueError(f"counts must be (n_layers, E), got {counts.shape}")
    if (counts < 0).any():
        raise ValueError("routing counts must be non-negative")
    n_layers, n = counts.shape
    layers = []
    for l in range(n_layers):
        total = counts[l].sum()
        pop = counts[l] / total if total > 0 else np.full(n, 1.0 / n)
        d = np.tile(pop * tokens_per_device, (n, 1))
        layers.append(strip_diagonal(d))
    return MoETrace(name=name, layers=tuple(layers), gate=gate,
                    ffn_per_token=ffn_per_token, agg=agg,
                    ffn_fixed=ffn_fixed)


def paper_eval_traces(seed: int = 0) -> tuple[MoETrace, MoETrace]:
    """The two-model setup of §8.1: LIMoE B/16 and B/32, 8 experts, 4 layers.

    B/16 sees ~4x the tokens of B/32 (patch size halves → 4x sequence length),
    making B/16 the communication-heavy model and B/32 the compute-light one —
    the complementarity Aurora's colocation exploits.
    """
    b16 = synthetic_trace("B/16", tokens_per_device=1024.0, skew=0.30,
                          ffn_per_token=0.0075, ffn_fixed=3.0,
                          gate=0.30, agg=0.18, seed=seed)
    b32 = synthetic_trace("B/32", tokens_per_device=512.0, skew=0.25,
                          ffn_per_token=0.0075, ffn_fixed=3.0,
                          gate=0.15, agg=0.09, seed=seed + 1)
    return b16, b32


def add_noise(trace: MoETrace, noise_frac: float, seed: int = 0) -> MoETrace:
    """Fig 14 methodology: perturb traffic by mixing in unseen request traffic.

    ``noise_frac`` of each matrix is replaced by traffic drawn from a fresh
    synthetic layer (the paper mixes in other layers' matrices; we mix a fresh
    draw, same effect: the plan was optimized for the unperturbed matrix).
    """
    rng = np.random.default_rng(seed)
    noisy = []
    for d in trace.layers:
        total = d.sum()
        fresh = rng.random(d.shape)
        np.fill_diagonal(fresh, 0.0)
        fresh = fresh / fresh.sum() * total
        noisy.append((1.0 - noise_frac) * d + noise_frac * fresh)
    return dataclasses.replace(trace, layers=tuple(noisy))
