"""Model configuration (the port's own copy of ``repro/configs/base.py``).

What the ported families read is kept: ``MoEConfig``, ``MLAConfig``,
``SSMConfig``, ``ModelConfig`` with its attention (q/k-norm, sliding
window, layer pattern, M-RoPE sections), FFN, MoE, SSM, hybrid,
encoder-decoder and frontend fields, ``layer_kinds()``, ``reduced()``, the
smoke-test variant (<= 2 layers, d_model <= 256, <= 4 experts, a pattern
cut to ``"LG"`` with a window of at most 16, a hybrid stack of 3 layers
with period 2, SSM ``d_state <= 16``, ``head_dim 32``, ``chunk 32``, fp32),
and ``cut_depth``, the layer cut of a full-width config. The reference's
parameter counts and shape-skip properties are not kept.
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
class SSMConfig:
    """Mamba2 (SSD) dims."""
    d_state: int
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 128               # SSD chunk length
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    source: str                    # paper / model-card citation

    n_layers: int
    d_model: int
    vocab: int

    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int | None = None      # window size of the L layers
    layer_pattern: str | None = None       # e.g. "LLLLLG" repeated; None=all G
    mrope_sections: tuple[int, int, int] | None = None  # qwen2-vl M-RoPE
    mla: MLAConfig | None = None   # MLA ignores n_kv_heads and head_dim

    d_ff: int = 0
    act: Literal["swiglu", "geglu"] = "swiglu"

    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    hybrid_period: int = 0         # hybrid: one shared attn block per N M blocks

    n_encoder_layers: int = 0      # encoder-decoder (audio)

    input_mode: Literal["text", "patches", "frames"] = "text"
    frontend_dim: int = 0          # width of the stub frontend's embeddings

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def is_encoder_decoder(self) -> bool:
        return self.n_encoder_layers > 0

    def layer_kinds(self) -> list[str]:
        """Per-layer kind: 'G' global attention, 'L' sliding-window
        attention (the pattern repeated over the depth; a leading dense
        layer of an MoE config is told apart by ``first_dense_layers``),
        'M' Mamba2, 'A' the hybrid's shared attention block (every
        ``hybrid_period + 1``-th layer)."""
        if self.family == "ssm":
            return ["M"] * self.n_layers
        if self.family == "hybrid":
            q = self.hybrid_period + 1
            return ["A" if (i + 1) % q == 0 else "M"
                    for i in range(self.n_layers)]
        if self.layer_pattern:
            pat = self.layer_pattern
            return [pat[i % len(pat)] for i in range(self.n_layers)]
        return ["G"] * self.n_layers

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
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm,
                                      d_state=min(self.ssm.d_state, 16),
                                      head_dim=32, chunk=32)
        hybrid = self.family == "hybrid"
        return dataclasses.replace(
            self,
            arch_id=self.arch_id + "-reduced",
            # A hybrid keeps 2 M layers and 1 shared-attention layer.
            n_layers=3 if hybrid else min(self.n_layers, 2),
            n_encoder_layers=min(self.n_encoder_layers, 2),
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=(max(1, min(self.n_kv_heads, 2))
                        if self.n_kv_heads else 0),
            head_dim=min(self.head_dim, 64) if self.head_dim else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            sliding_window=(min(self.sliding_window, 16)
                            if self.sliding_window else None),
            layer_pattern="LG" if self.layer_pattern else None,
            moe=moe, mla=mla, ssm=ssm,
            hybrid_period=2 if hybrid else 0,
            frontend_dim=(min(self.frontend_dim, 128)
                          if self.frontend_dim else 0),
            mrope_sections=(8, 12, 12) if self.mrope_sections else None,
            dtype="float32",
        )


def cut_depth(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """``cfg`` cut to ``n_layers`` layers, every width kept. The cut takes
    the MoE layers first: an MoE config's leading dense layers stay while
    at least one MoE layer is left beside them. A layer pattern keeps its
    phase: the kinds are the first ``n_layers`` of the repeated pattern,
    so a multiple of its length keeps whole blocks (12 layers of gemma3
    are 2 x ``LLLLLG``) and any other depth ends on a partial block. A
    hybrid stack keeps its period's phase the same way (the shared block
    stays every ``hybrid_period + 1``-th layer). An encoder-decoder cut
    cuts the decoder's layers only: ``n_encoder_layers`` stays."""
    if n_layers < 1:
        raise ValueError(f"n_layers must be >= 1, got {n_layers}")
    moe = cfg.moe
    if moe is not None and moe.first_dense_layers >= n_layers:
        moe = dataclasses.replace(moe, first_dense_layers=n_layers - 1)
    return dataclasses.replace(cfg, n_layers=n_layers, moe=moe)
