"""Architecture registry of the port: ``get_config("<arch-id>")``.

Only the architectures whose code paths the port has are registered; the
others raise ``KeyError`` until their slice lands.
"""

from __future__ import annotations

from . import phi3_5_moe_42b
from .base import ModelConfig, MoEConfig

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.arch_id: m.CONFIG for m in (phi3_5_moe_42b,)}
ARCH_IDS: tuple[str, ...] = tuple(REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"arch {arch_id!r} is not ported to repro_torch yet; "
                       f"ported: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


__all__ = ["ModelConfig", "MoEConfig", "REGISTRY", "ARCH_IDS", "get_config"]
