"""gemma-7b — GeGLU, head_dim=256 [arXiv:2403.08295]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma-7b",
    family="dense",
    source="Gemma [arXiv:2403.08295]",
    n_layers=28,
    d_model=3072,
    vocab=256_000,
    n_heads=16,
    n_kv_heads=16,                # MQA only on the 2b variant
    head_dim=256,
    d_ff=24_576,
    act="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
