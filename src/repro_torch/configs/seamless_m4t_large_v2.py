"""seamless-m4t-large-v2 — enc-dec, multimodal [arXiv:2308.11596].

Audio: the mel-spectrogram + conformer feature frontend is a stub, as in
the reference — the caller hands in frame embeddings (batch, frames,
frontend_dim); this config is the transformer encoder-decoder backbone.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-large-v2",
    family="audio",
    source="SeamlessM4T [arXiv:2308.11596]",
    n_layers=24,                  # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    vocab=256_206,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    act="swiglu",
    rope_theta=10_000.0,
    input_mode="frames",
    frontend_dim=1024,
)
