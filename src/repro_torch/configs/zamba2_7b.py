"""zamba2-7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

81 Mamba2 blocks with a single SHARED transformer block (attention + FFN,
one parameter set) invoked periodically (every 6th position in our build).
Each invocation keeps its own KV cache.
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    source="Zamba2 [arXiv:2411.15242]",
    n_layers=81,
    d_model=3584,
    vocab=32_000,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,                 # 3584 / 32
    d_ff=14_336,
    act="swiglu",
    rope_theta=10_000.0,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_kernel=4,
                  chunk=256, n_groups=1),
    hybrid_period=6,              # one shared attn block per 6 mamba blocks
)
