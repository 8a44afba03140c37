"""Roofline of a step on the H100 (port of ``repro/roofline``)."""

from .analysis import H100, HW, ep_round_bytes, model_flops, roofline_report

__all__ = ["H100", "HW", "ep_round_bytes", "model_flops", "roofline_report"]
