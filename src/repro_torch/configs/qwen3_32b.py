"""qwen3-32b — qk_norm, GQA [hf:Qwen/Qwen3-8B family]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-32b",
    family="dense",
    source="Qwen3 [hf:Qwen/Qwen3-8B model card]",
    n_layers=64,
    d_model=5120,
    vocab=151_936,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    qk_norm=True,
    d_ff=25_600,
    act="swiglu",
    rope_theta=1_000_000.0,
)
