"""Architecture registry of the port: ``get_config("<arch-id>")``.

Registered: phi3.5-MoE (GQA, softmax router) and DeepSeek-V3 (MLA, leading
dense layers, sigmoid router with a shared expert). The reference's other
architectures are not ported yet and raise ``KeyError``.
"""

from __future__ import annotations

from . import deepseek_v3_671b, phi3_5_moe_42b
from .base import MLAConfig, ModelConfig, MoEConfig, cut_depth

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.arch_id: m.CONFIG for m in (phi3_5_moe_42b, deepseek_v3_671b)}
ARCH_IDS: tuple[str, ...] = tuple(REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"arch {arch_id!r} is not ported to repro_torch yet; "
                       f"ported: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


__all__ = ["MLAConfig", "ModelConfig", "MoEConfig", "REGISTRY", "ARCH_IDS",
           "cut_depth", "get_config"]
