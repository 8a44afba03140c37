"""95th percentile over every gap between consecutive output tokens of
every request due in the window."""

from perfbench.readers import itl_s, tail_ms


def read(run):
    return tail_ms(itl_s(run))
