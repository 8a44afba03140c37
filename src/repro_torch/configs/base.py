"""Model configuration (the port's own copy of ``repro/configs/base.py``).

Only what the GQA, MLA and MoE serving slices read is kept: ``MoEConfig``,
``MLAConfig``, ``ModelConfig`` with its attention/FFN/MoE fields,
``reduced()``, the smoke-test variant (<= 2 layers, d_model <= 256, <= 4
experts, fp32), and ``cut_depth``, the layer cut of a full-width config.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    router: Literal["softmax", "sigmoid"] = "softmax"
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""
    q_lora_rank: int
    kv_lora_rank: int
    qk_rope_head_dim: int
    qk_nope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: Literal["dense", "moe"]
    source: str                    # paper / model-card citation

    n_layers: int
    d_model: int
    vocab: int

    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10_000.0
    mla: MLAConfig | None = None   # MLA ignores n_kv_heads and head_dim

    d_ff: int = 0
    act: Literal["swiglu", "geglu"] = "swiglu"

    moe: MoEConfig | None = None

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/code paths, tiny dims, fp32."""
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2), d_ff=min(self.moe.d_ff, 384),
                shared_d_ff=(min(self.moe.shared_d_ff, 384)
                             if self.moe.shared_d_ff else 0),
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                dense_d_ff=(min(self.moe.dense_d_ff, 512)
                            if self.moe.dense_d_ff else 0),
            )
        mla = None
        if self.mla is not None:
            mla = MLAConfig(q_lora_rank=64, kv_lora_rank=64,
                            qk_rope_head_dim=16, qk_nope_head_dim=32,
                            v_head_dim=32)
        return dataclasses.replace(
            self,
            arch_id=self.arch_id + "-reduced",
            n_layers=min(self.n_layers, 2),
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=(max(1, min(self.n_kv_heads, 2))
                        if self.n_kv_heads else 0),
            head_dim=min(self.head_dim, 64) if self.head_dim else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            moe=moe, mla=mla,
            dtype="float32",
        )


def cut_depth(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """``cfg`` cut to ``n_layers`` layers, every width kept. The cut takes
    the MoE layers first: an MoE config's leading dense layers stay while
    at least one MoE layer is left beside them."""
    if n_layers < 1:
        raise ValueError(f"n_layers must be >= 1, got {n_layers}")
    moe = cfg.moe
    if moe is not None and moe.first_dense_layers >= n_layers:
        moe = dataclasses.replace(moe, first_dense_layers=n_layers - 1)
    return dataclasses.replace(cfg, n_layers=n_layers, moe=moe)
