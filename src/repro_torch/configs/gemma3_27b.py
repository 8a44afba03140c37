"""gemma3-27b — 5:1 local:global attention, 128k ctx [hf:google/gemma-3 family].

Five sliding-window (1024) layers per global layer: each L layer caches a
ring of min(cache capacity, 1024) positions.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-27b",
    family="dense",
    source="Gemma 3 [hf:google/gemma-3-1b-pt model card]",
    n_layers=62,
    d_model=5376,
    vocab=262_144,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    qk_norm=True,
    d_ff=21_504,
    act="geglu",
    rope_theta=1_000_000.0,
    sliding_window=1024,
    layer_pattern="LLLLLG",
    tie_embeddings=True,
)
