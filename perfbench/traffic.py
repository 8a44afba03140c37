"""Requests from a traffic mix's parameters and a seed.

A mix is a JSON file (``traffic/<name>.json``) that this one generator
reads. Its ``loop`` is "open" (independent users: requests are due at
fixed wall-clock times, whatever the system does) or "closed" (``callers``
callers, each sending its next request when its last one has returned).

Lengths. ``prompt`` and ``output`` each give a distribution: {"dist":
"lognormal", "median", "sigma", "min", "max"} (clipped, rounded) or
{"dist": "fixed", "value"}. The requests that count are given the
distribution's quantiles at (i + 0.5) / n, shuffled by the seed, so every
seed sends the same set of lengths in another order and at other times;
the work of a window does not change with the seed.

Open loop. ``rate_rps`` requests a second: the n = round(rate x seconds)
requests of the window are due at n uniform times in [0, seconds) (a
Poisson process given its count); after the window, requests keep coming
as a Poisson process of the same rate (drawn lengths), so requests that
finish late meet the same load. With ``schedule_seed`` the due times and
the order of the lengths come from that seed, the same for every run,
and the run's seed draws the token ids alone: a tail that depends on
which long prompts arrive together then measures one schedule, not the
luck of each seed's.

Token ids are uniform over [1, vocab) (0 is the engine's pad), drawn per
request from (seed, request key), so they cost nothing until sent.
"""

from __future__ import annotations

import dataclasses
from statistics import NormalDist

import numpy as np

_SEED_MASK = (1 << 64) - 1


@dataclasses.dataclass
class Send:
    """One request to send: ``key`` (ints) names it for its token ids,
    ``due`` is its wall-clock time in seconds after the window opens (open
    loop)."""

    key: tuple
    prompt_len: int
    max_new: int
    due: float = 0.0
    in_window: bool = True

    def tokens(self, seed: int, vocab: int) -> np.ndarray:
        rng = np.random.default_rng([seed & _SEED_MASK, *self.key])
        return rng.integers(1, vocab, self.prompt_len, dtype=np.int64)


def _clip(values, spec) -> np.ndarray:
    return np.clip(np.rint(values), spec["min"], spec["max"]).astype(np.int64)


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """The n lengths at the distribution's quantiles (i + 0.5) / n."""
    if spec["dist"] == "fixed":
        return np.full(n, int(spec["value"]), np.int64)
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    return _clip(spec["median"] * np.exp(spec["sigma"] * z), spec)


def drawn_lengths(spec: dict, n: int, rng) -> np.ndarray:
    """n lengths drawn independently."""
    if spec["dist"] == "fixed":
        return np.full(n, int(spec["value"]), np.int64)
    z = rng.standard_normal(n)
    return _clip(spec["median"] * np.exp(spec["sigma"] * z), spec)


def length_range(spec: dict) -> tuple[int, int]:
    if spec["dist"] == "fixed":
        return int(spec["value"]), int(spec["value"])
    return int(spec["min"]), int(spec["max"])


def open_loop(mix: dict, seed: int, seconds: float,
              after_s: float) -> list[Send]:
    """The window's requests, due in [0, seconds), then those due in
    [seconds, seconds + after_s), in due order."""
    rate = float(mix["rate_rps"])
    sched = mix.get("schedule_seed", seed)
    rng = np.random.default_rng([sched & _SEED_MASK, 0])
    n = int(round(rate * seconds))
    due = np.sort(rng.uniform(0.0, seconds, n))
    prompts = rng.permutation(quantile_lengths(mix["prompt"], n))
    outs = rng.permutation(quantile_lengths(mix["output"], n))
    sends = [Send((0, i), int(p), int(o), float(t))
             for i, (t, p, o) in enumerate(zip(due, prompts, outs))]
    t, i = float(seconds), 0
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= seconds + after_s:
            break
        p = int(drawn_lengths(mix["prompt"], 1, rng)[0])
        o = int(drawn_lengths(mix["output"], 1, rng)[0])
        sends.append(Send((1, i), p, o, t, in_window=False))
        i += 1
    return sends


class Callers:
    """A closed loop's callers: caller c's j-th request. The first
    ``depth`` requests of every caller share one set of quantile lengths,
    shuffled by the seed; later ones are drawn."""

    def __init__(self, mix: dict, seed: int):
        self.n = int(mix["callers"])
        self.depth = int(mix.get("depth", 64))
        self.mix = mix
        self.seed = seed
        rng = np.random.default_rng([seed & _SEED_MASK, 1])
        total = self.n * self.depth
        self._prompts = rng.permutation(
            quantile_lengths(mix["prompt"], total))
        self._outs = rng.permutation(quantile_lengths(mix["output"], total))

    def request(self, caller: int, j: int) -> Send:
        if j < self.depth:
            k = caller * self.depth + j
            return Send((2, caller, j), int(self._prompts[k]),
                        int(self._outs[k]))
        rng = np.random.default_rng([self.seed & _SEED_MASK, 2, caller, j])
        return Send((2, caller, j),
                    int(drawn_lengths(self.mix["prompt"], 1, rng)[0]),
                    int(drawn_lengths(self.mix["output"], 1, rng)[0]))


def pow2_bucket(n: int, cap: int) -> int:
    """The engine's padded prompt length under the "pow2" bucket policy:
    the next power of two, at most the cache capacity."""
    return min(1 << (max(int(n), 1) - 1).bit_length(), cap)


def buckets(mix: dict) -> list[int]:
    """Every padded prompt length the mix's prompts can take."""
    lo, hi = length_range(mix["prompt"])
    cap = int(mix["engine"]["cache_cap"])
    return sorted({pow2_bucket(n, cap) for n in range(lo, hi + 1)})
