"""Model FLOPs of the live prompt tokens prefilled in the traced window over
the summed ``prefill`` span time, as a share of 989 TFLOP/s."""

from perfbench.readers import first_tokens_in, mfu_pct, prefill_flops, spans


def read(run):
    busy = sum(spans(run, "prefill"))
    done = first_tokens_in(run, run.t0, float("inf"))
    return mfu_pct(prefill_flops(run, done), busy) if done else None
