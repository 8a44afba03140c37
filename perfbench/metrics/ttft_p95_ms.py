"""95th percentile, over every request due in the window, of the time from
its due time to its first token."""

from perfbench.readers import tail_ms, ttft_s


def read(run):
    return tail_ms(ttft_s(run))
