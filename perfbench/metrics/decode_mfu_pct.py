"""Model FLOPs of the tokens decoded in the traced window over the summed
``decode_step`` span time, as a share of 989 TFLOP/s."""

from perfbench.readers import decode_flops, mfu_pct, spans


def read(run):
    busy = sum(spans(run, "decode_step"))
    return mfu_pct(decode_flops(run, run.t0, float("inf")), busy)
