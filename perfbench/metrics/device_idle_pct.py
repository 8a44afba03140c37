"""Share of the profiled slice in which no operation ran on the device."""

from perfbench.readers import idle_pct


def read(run):
    return idle_pct(run)
