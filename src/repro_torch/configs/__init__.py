"""Architecture registry of the port: ``get_config("<arch-id>")``.

Every architecture of the reference is registered: phi3.5-MoE (GQA,
softmax router), DeepSeek-V3 (MLA, leading dense layers, sigmoid router
with a shared expert), the dense GQA families phi4-mini (swiglu, tied
embeddings), gemma-7b (geglu, head_dim 256), qwen3-32b (q/k-norm) and
gemma3-27b (q/k-norm, geglu, ``LLLLLG`` sliding-window layers), mamba2
(SSM), zamba2 (Mamba2 blocks and one shared attention block), qwen2-vl
(M-RoPE, patch embeddings) and SeamlessM4T (encoder-decoder, frame
embeddings). An unknown id raises ``KeyError``. The four input shapes
of the dry run are ``SHAPES`` (``configs.shapes``).
"""

from __future__ import annotations

from . import (deepseek_v3_671b, gemma3_27b, gemma_7b, mamba2_1_3b,
               phi3_5_moe_42b, phi4_mini_3_8b, qwen2_vl_7b, qwen3_32b,
               seamless_m4t_large_v2, zamba2_7b)
from .base import MLAConfig, ModelConfig, MoEConfig, SSMConfig, cut_depth
from .shapes import (DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K,
                     InputShape)

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.arch_id: m.CONFIG
    for m in (phi3_5_moe_42b, deepseek_v3_671b, phi4_mini_3_8b, gemma_7b,
              qwen3_32b, gemma3_27b, mamba2_1_3b, zamba2_7b, qwen2_vl_7b,
              seamless_m4t_large_v2)}
ARCH_IDS: tuple[str, ...] = tuple(REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


__all__ = ["MLAConfig", "ModelConfig", "MoEConfig", "SSMConfig", "InputShape",
           "SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
           "REGISTRY", "ARCH_IDS", "cut_depth", "get_config"]
