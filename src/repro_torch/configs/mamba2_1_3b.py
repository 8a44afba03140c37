"""mamba2-1.3b — SSD (state-space duality) [arXiv:2405.21060]."""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-1.3b",
    family="ssm",
    source="SSD / Mamba-2 [arXiv:2405.21060]",
    n_layers=48,
    d_model=2048,
    vocab=50_280,
    d_ff=0,                       # attention-free, FFN-free backbone
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4,
                  chunk=256, n_groups=1),
    tie_embeddings=True,          # GPT-NeoX tokenizer family ties in 1.3b
    norm_eps=1e-5,
)
