"""Architecture registry of the port: ``get_config("<arch-id>")``.

Registered: phi3.5-MoE (GQA, softmax router), DeepSeek-V3 (MLA, leading
dense layers, sigmoid router with a shared expert) and the dense GQA
families phi4-mini (swiglu, tied embeddings), gemma-7b (geglu, head_dim
256), qwen3-32b (q/k-norm) and gemma3-27b (q/k-norm, geglu, ``LLLLLG``
sliding-window layers). The reference's other architectures (M-RoPE, SSM,
hybrid, encoder-decoder) are not ported yet and raise ``KeyError``.
"""

from __future__ import annotations

from . import (deepseek_v3_671b, gemma3_27b, gemma_7b, phi3_5_moe_42b,
               phi4_mini_3_8b, qwen3_32b)
from .base import MLAConfig, ModelConfig, MoEConfig, cut_depth

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.arch_id: m.CONFIG
    for m in (phi3_5_moe_42b, deepseek_v3_671b, phi4_mini_3_8b, gemma_7b,
              qwen3_32b, gemma3_27b)}
ARCH_IDS: tuple[str, ...] = tuple(REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"arch {arch_id!r} is not ported to repro_torch yet; "
                       f"ported: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


__all__ = ["MLAConfig", "ModelConfig", "MoEConfig", "REGISTRY", "ARCH_IDS",
           "cut_depth", "get_config"]
