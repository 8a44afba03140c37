"""Sharding rules (port of ``repro/sharding``): the reference's rule table
on a mesh, and the EP engines' layout over a rank count."""

from .rules import (batch_axes_for, cache_specs, ep_axes_for, ep_size_for,
                    input_sharding, make_pc, param_specs, replica_axes,
                    seq_axes_for, split_axes)

__all__ = ["batch_axes_for", "cache_specs", "ep_axes_for", "ep_size_for",
           "input_sharding", "make_pc", "param_specs", "replica_axes",
           "seq_axes_for", "split_axes"]
