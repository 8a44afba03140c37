"""Model FLOPs of the window's tokens (prompts whose first token came in it,
tokens decoded in it) over the window's length, as a share of 989
TFLOP/s."""

from perfbench.readers import (decode_flops, first_tokens_in, mfu_pct,
                               prefill_flops)


def read(run):
    t1 = run.t0 + run.seconds
    flops = (prefill_flops(run, first_tokens_in(run, run.t0, t1))
             + decode_flops(run, run.t0, t1))
    return mfu_pct(flops, run.seconds)
