"""Summed roofline bound of the ``moe_gmm`` calls in the profiled slice
(``roofline.moe_gmm_cost``) over the device time of what they launched."""

from perfbench.readers import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, "moe_gmm")
