"""phi4-mini-3.8b — RoPE SwiGLU GQA [arXiv:2412.08905]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi4-mini-3.8b",
    family="dense",
    source="Phi-4 [arXiv:2412.08905]",
    n_layers=32,
    d_model=3072,
    vocab=200_064,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    act="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
