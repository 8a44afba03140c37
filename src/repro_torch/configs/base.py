"""Model configuration (the port's own copy of ``repro/configs/base.py``).

What the ported families read is kept: ``MoEConfig``, ``MLAConfig``,
``SSMConfig``, ``ModelConfig`` with its attention (q/k-norm, sliding
window, layer pattern, M-RoPE sections), FFN, MoE, SSM, hybrid,
encoder-decoder and frontend fields, ``layer_kinds()``, ``reduced()``, the
smoke-test variant (<= 2 layers, d_model <= 256, <= 4 experts, a pattern
cut to ``"LG"`` with a window of at most 16, a hybrid stack of 3 layers
with period 2, SSM ``d_state <= 16``, ``head_dim 32``, ``chunk 32``, fp32),
``cut_depth``, the layer cut of a full-width config, and the reference's
sizing: ``attention_free``, ``subquadratic`` (the shape-skip rule),
``supports_decode``, ``param_count`` and ``active_param_count``, with
their helpers copied exactly.
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

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (the dry run's shape-skip rule)."""
        if self.family in ("ssm", "hybrid"):
            return True
        # dense archs qualify only with a sliding-window layer pattern
        return self.sliding_window is not None and self.layer_pattern is not None

    @property
    def supports_decode(self) -> bool:
        return True  # all assigned archs have a decoder

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

    def param_count(self) -> int:
        """Analytic parameter count (total)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top_k experts)."""
        return _param_count(self, active_only=True)

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


def _ffn_params(d_model: int, d_ff: int) -> int:
    return 3 * d_model * d_ff  # gate, up, down


def _attn_params(cfg: ModelConfig) -> int:
    if cfg.mla is not None:
        m = cfg.mla
        d = cfg.d_model
        qk_head = m.qk_rope_head_dim + m.qk_nope_head_dim
        p = d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qk_head
        p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
        p += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
        p += cfg.n_heads * m.v_head_dim * d
        return p
    hd = cfg.head_dim
    return (cfg.d_model * cfg.n_heads * hd          # q
            + 2 * cfg.d_model * cfg.n_kv_heads * hd  # k, v
            + cfg.n_heads * hd * cfg.d_model)        # o


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    p = cfg.d_model * (2 * d_inner + 2 * s.n_groups * s.d_state + n_heads)  # in_proj
    p += conv_dim * s.conv_kernel                     # depthwise conv
    p += n_heads * 2                                  # A_log, D
    p += d_inner                                      # gated norm
    p += d_inner * cfg.d_model                        # out_proj
    return p


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    total = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    kinds = cfg.layer_kinds()
    for i, kind in enumerate(kinds):
        total += 2 * cfg.d_model  # norms
        if kind == "M":
            total += _ssm_params(cfg)
            continue
        if kind == "A" and cfg.family == "hybrid":
            continue  # counted once below (shared params)
        total += _attn_params(cfg)
        if cfg.moe is not None:
            if i < cfg.moe.first_dense_layers:
                total += _ffn_params(cfg.d_model, cfg.moe.dense_d_ff)
            else:
                total += cfg.d_model * cfg.moe.n_experts  # router
                n_used = (cfg.moe.top_k if active_only else cfg.moe.n_experts)
                total += n_used * _ffn_params(cfg.d_model, cfg.moe.d_ff)
                if cfg.moe.n_shared_experts:
                    total += _ffn_params(cfg.d_model,
                                         cfg.moe.shared_d_ff or cfg.moe.d_ff)
        else:
            total += _ffn_params(cfg.d_model, cfg.d_ff)
    if cfg.family == "hybrid":  # one shared attention(+ffn) block
        total += _attn_params(cfg) + _ffn_params(cfg.d_model, cfg.d_ff)
    if cfg.is_encoder_decoder:
        # encoder layers: self-attn + ffn; decoder already counted has
        # cross-attn in addition
        total += cfg.n_encoder_layers * (
            _attn_params(cfg) + _ffn_params(cfg.d_model, cfg.d_ff)
            + 2 * cfg.d_model)
        total += len(kinds) * _attn_params(cfg)  # decoder cross-attn
    return total


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
