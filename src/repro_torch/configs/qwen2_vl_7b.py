"""qwen2-vl-7b — M-RoPE, dynamic resolution [arXiv:2409.12191].

VLM: the vision encoder (ViT + merger) is a stub, as in the reference —
the caller hands in patch embeddings (batch, seq, frontend_dim); this
config is the language/decoder backbone that consumes them.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-7b",
    family="vlm",
    source="Qwen2-VL [arXiv:2409.12191]",
    n_layers=28,
    d_model=3584,
    vocab=152_064,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    act="swiglu",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # temporal / height / width of head_dim/2
    input_mode="patches",
    frontend_dim=3584,
)
