"""Mean of the slowest 5 % of the gaps between consecutive output tokens
of every request due in the window: the gaps at or above their 95th
percentile: the stalls that whole-prompt prefills put between tokens,
averaged rather than read at one rank among them (PERF.md §2)."""

from perfbench.readers import itl_s, tail_mean_ms


def read(run):
    return tail_mean_ms(itl_s(run), 95.0)
