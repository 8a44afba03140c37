"""Summed ``prefill`` span time in the window over the window's length, as a
percentage."""


def read(run):
    t1 = run.t0 + run.seconds
    busy = sum(d for n, ts, d in run.spans if n == "prefill" and ts < t1)
    return 100.0 * busy / run.seconds
