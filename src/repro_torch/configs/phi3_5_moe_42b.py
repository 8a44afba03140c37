"""phi3.5-moe-42b-a6.6b — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="phi3.5-moe-42b-a6.6b",
    family="moe",
    source="Phi-3.5-MoE [hf:microsoft/Phi-3.5-MoE-instruct model card]",
    n_layers=32,
    d_model=4096,
    vocab=32_064,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    act="swiglu",
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=6400, router="softmax",
                  capacity_factor=1.25),
)
