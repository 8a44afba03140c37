"""Top-level model facade (port of ``repro/models/model.py``, serving API).

``Model(cfg)`` runs on the card by default and raises if there is none;
only an explicit ``device="cpu"`` runs on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from . import transformer as tf
from .layers import KernelConfig


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present: the port runs on the "
                           "card unless device='cpu' is asked for")
    return device


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: object
    device: object = "cuda"
    kernels: KernelConfig | None = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    # -- params / cache ----------------------------------------------------
    def init(self, seed: int = 0) -> dict:
        return tf.init_params(self.cfg, seed, device=self.device)

    def with_kernels(self, kernels: "KernelConfig | bool" = True) -> "Model":
        """Model routed through the kernel hot path: decode attention through
        ``kernels.ops.decode_attn_auto`` and MoE dispatch through the sort-
        based bucketed path into ``kernels.ops.moe_ffn``. ``False`` is a
        no-op, so engines can thread their ``kernels=`` flag through."""
        if kernels is False:
            return self
        kc = kernels if isinstance(kernels, KernelConfig) else KernelConfig()
        return dataclasses.replace(self, kernels=kc)

    def init_cache(self, batch: int, cap: int, per_slot_len: bool = False):
        return tf.init_cache(self.cfg, batch, cap, per_slot_len=per_slot_len,
                             device=self.device)

    @property
    def padded_vocab(self) -> int:
        return tf.padded_vocab(self.cfg)

    # -- serving -----------------------------------------------------------
    def prefill(self, params, inputs, cache):
        """inputs: {"tokens": (B, S)}. A fresh prefill from position 0; the
        cache is written in place. Returns (logits, cache)."""
        logits, _ = tf.forward(params, self.cfg, tokens=inputs["tokens"],
                               mode="prefill", cache=cache,
                               kernels=self.kernels)
        return logits, cache

    def decode_step(self, params, token, cache, row_mask=None):
        """token: (B, 1). Returns (logits (B, 1, V), cache), the cache updated
        in place. ``row_mask`` (B,) bool: rows where it is False keep their
        cache state and fill level (their logits are computed and can be
        discarded)."""
        logits, _ = tf.forward(params, self.cfg, tokens=token, mode="decode",
                               cache=cache, kernels=self.kernels,
                               row_mask=row_mask)
        return logits, cache

    def prefill_slot(self, params, inputs, cache, slot: int, *, cap: int):
        """Prefill ONE request into row ``slot`` of a per-slot cache: run it
        against a fresh zero batch-1 cache (no state of the slot's previous
        occupant can leak), then copy that into the slot's row. Returns
        (logits, cache)."""
        sub = tf.init_cache(self.cfg, 1, cap, device=self.device)
        logits, sub = self.prefill(params, inputs, sub)
        return logits, tf.merge_cache_slot(cache, sub, slot)
