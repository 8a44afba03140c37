"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8 [arXiv:2412.19437].

The primary Aurora target: 256-way expert parallelism with scheduled
all-to-all dispatch. First 3 layers dense (d_ff 18432); sigmoid router.
(The optional MTP head is exposed via training config, not counted here.)
"""

from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v3-671b",
    family="moe",
    source="DeepSeek-V3 [arXiv:2412.19437]",
    n_layers=61,
    d_model=7168,
    vocab=129_280,
    n_heads=128,
    n_kv_heads=128,               # MLA: kv heads == heads over the latent
    head_dim=128,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_rope_head_dim=64, qk_nope_head_dim=128,
                  v_head_dim=128),
    act="swiglu",
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=256, top_k=8, d_ff=2048,
                  n_shared_experts=1, shared_d_ff=2048,
                  router="sigmoid", first_dense_layers=3,
                  dense_d_ff=18_432, capacity_factor=1.25),
)
