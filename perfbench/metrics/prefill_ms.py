"""Mean of the telemetry hub's ``prefill`` spans (one batch-1 prefill of a
whole padded prompt, synchronised)."""

from perfbench.readers import mean_ms, spans


def read(run):
    return mean_ms(spans(run, "prefill"))
