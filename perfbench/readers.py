"""Helpers the metric readers (``metrics/<name>.py``) share. Each takes the
``bench.Run`` of one run and returns a number, or None where the run has
nothing to read (no such span, no profiled slice, no such kernel call)."""

from __future__ import annotations

from .roofline import PEAK_FLOPS, bound_seconds
from .stats import percentile


def ttft_s(run) -> list[float]:
    """Per request due in the window: its first token's time from its due
    time; a request with none by the end of the drain counts with the
    time it waited until then."""
    end = max(t for _, t, _ in run.steps) if run.steps else run.t0
    return [(r.times[0] if r.times else end) - r.due for r in run.window]


def itl_s(run) -> list[float]:
    """Every gap between consecutive tokens of every window request."""
    return [b - a for r in run.window for a, b in zip(r.times, r.times[1:])]


def tail_ms(values, q: float = 95.0):
    return 1e3 * percentile(values, q) if values else None


def tail_mean_ms(values, q: float):
    """Mean of the values at or above their q-th percentile, in ms."""
    if not values:
        return None
    cut = percentile(values, q)
    tail = [v for v in values if v >= cut]
    return 1e3 * sum(tail) / len(tail)


def tokens_in_window(run) -> int:
    t1 = run.t0 + run.seconds
    return sum(run.t0 <= t < t1 for r in run.records for t in r.times)


def spans(run, name: str) -> list[float]:
    return [d for n, _, d in run.spans if n == name]


def mean_ms(values):
    return 1e3 * sum(values) / len(values) if values else None


def _padded(run, r) -> int:
    from .traffic import pow2_bucket
    return pow2_bucket(r.prompt_len, run.cap)


def prefill_flops(run, records) -> float:
    """Model FLOPs of the live prompt tokens of ``records``."""
    return sum(run.flops.prefill(r.prompt_len) for r in records)


def decode_flops(run, lo: float, hi: float) -> float:
    """Model FLOPs of every token decoded in [lo, hi): the j-th token of a
    request (j >= 1) came from a decode at position P - 1 + j, P its
    padded prompt."""
    total = 0.0
    for r in run.records:
        pad = _padded(run, r)
        for j, t in enumerate(r.times[1:], start=1):
            if lo <= t < hi:
                total += run.flops.decode(pad - 1 + j)
    return total


def first_tokens_in(run, lo: float, hi: float) -> list:
    return [r for r in run.records if r.times and lo <= r.times[0] < hi]


def kernel_roofline_pct(run, kernel: str):
    """Summed bound time of the kernel's calls in the profiled slice over
    the device time of what they launched, as a percentage."""
    prof = run.profile
    calls = run.kernel_calls.get(kernel) or []
    if prof is None or not calls:
        return None
    from .bench import RANGES
    dev = prof["by_range"].get(RANGES[kernel], {}).get("seconds", 0.0)
    if dev <= 0:
        return None
    return 100.0 * sum(bound_seconds(f, b) for f, b in calls) / dev


def idle_pct(run):
    prof = run.profile
    if prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def mfu_pct(flops: float, seconds: float):
    if seconds <= 0:
        return None
    return 100.0 * flops / (seconds * PEAK_FLOPS)
