"""Expert-parallel layout rules (the EP part of ``repro/sharding``)."""

from .rules import ep_size_for, make_pc, param_specs

__all__ = ["ep_size_for", "make_pc", "param_specs"]
