"""Model layers, MoE and the decoder stack behind the ``Model`` facade."""

from .layers import KernelConfig, ParallelContext
from .model import Model
from .transformer import (Segment, forward, init_cache, init_params,
                          merge_cache_slot, moe_layer_count, padded_vocab,
                          segments_of, slice_cache_slot)

__all__ = ["KernelConfig", "Model", "ParallelContext", "Segment", "forward", "init_cache",
           "init_params", "merge_cache_slot", "moe_layer_count",
           "padded_vocab", "segments_of", "slice_cache_slot"]
