"""Summed roofline bound of the ``decode_attn`` calls in the profiled slice
(``roofline.decode_attn_cost``) over the device time of what they
launched."""

from perfbench.readers import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, "decode_attn")
