"""Mean of the telemetry hub's ``decode_step`` spans (one decode over every
slot, synchronised)."""

from perfbench.readers import mean_ms, spans


def read(run):
    return mean_ms(spans(run, "decode_step"))
