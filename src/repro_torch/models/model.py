"""Top-level model facade (port of ``repro/models/model.py``, serving API).

``Model(cfg)`` runs on the card by default and raises if there is none;
only an explicit ``device="cpu"`` runs on the CPU. ``replication`` is the
physical layout of the params' MoE expert leaves (the counterpart of the
reference's ``ParallelContext.moe_replication``) and ``pc`` the
expert-parallel layout of the MoE layers (``layers.ParallelContext``;
``serving.distributed.distribute`` binds one); every call passes both to
the MoE layers.
"""

from __future__ import annotations

import dataclasses

import torch

from . import transformer as tf
from .layers import KernelConfig, ParallelContext
from .moe import ReplicationSpec


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
    replication: ReplicationSpec | None = None
    pc: ParallelContext | None = None

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
    def prefill(self, params, inputs, cache, collect_moe_stats: bool = False,
                continuation: bool = False):
        """inputs: {"tokens": (B, S)}. A fresh prefill from position 0, or
        with ``continuation=True`` one that resumes at the cache's fill
        level (a scalar, or a (B,) vector: each row at its own offset), so
        a prompt absorbed chunk by chunk equals a one-shot prefill. The
        cache is written in place. Returns (logits, cache), plus the
        (n_moe_layers, B, S, E) per-position routing counts when
        ``collect_moe_stats`` (mask left-pad positions before
        aggregating)."""
        out = tf.forward(params, self.cfg, tokens=inputs["tokens"],
                         mode="prefill", cache=cache, kernels=self.kernels,
                         continuation=continuation,
                         collect_moe_stats=collect_moe_stats,
                         replication=self.replication, pc=self.pc)
        if collect_moe_stats:
            return out[0], cache, out[2]
        return out[0], cache

    def decode_step(self, params, token, cache, row_mask=None):
        """token: (B, 1). Returns (logits (B, 1, V), cache), the cache updated
        in place. ``row_mask`` (B,) bool: rows where it is False keep their
        cache state and fill level (their logits are computed and can be
        discarded)."""
        logits, _ = tf.forward(params, self.cfg, tokens=token, mode="decode",
                               cache=cache, kernels=self.kernels,
                               row_mask=row_mask,
                               replication=self.replication, pc=self.pc)
        return logits, cache

    def decode_step_stats(self, params, token, cache, row_mask=None):
        """``decode_step`` that also returns the (n_moe_layers, B, E) float32
        per-slot routed-choice counts (the live traffic signal of
        ``serving.monitor.TrafficMonitor``)."""
        logits, _, stats = tf.forward(
            params, self.cfg, tokens=token, mode="decode", cache=cache,
            kernels=self.kernels, row_mask=row_mask, collect_moe_stats=True,
            replication=self.replication, pc=self.pc)
        return logits, cache, stats[:, :, 0, :]          # S == 1 at decode

    def prefill_slot(self, params, inputs, cache, slot: int, *, cap: int,
                     collect_moe_stats: bool = False):
        """Prefill ONE request into row ``slot`` of a per-slot cache. The
        row ends up as the reference's fresh zero batch-1 cache would after
        its merge (no state of the slot's previous occupant can leak): the
        whole prompt is the first and only chunk of ``prefill_chunk_slot``.
        Returns (logits, cache), plus the (n_moe_layers, 1, S, E) routing
        counts when ``collect_moe_stats``."""
        return self.prefill_chunk_slot(params, inputs, cache, slot,
                                       first=True, cap=cap,
                                       collect_moe_stats=collect_moe_stats)

    def merge_slot(self, cache, sub, slot: int):
        """Write a completed batch-1 prefill cache into row ``slot`` of the
        shared per-slot cache (in place). Returns ``cache``."""
        return tf.merge_cache_slot(cache, sub, slot)

    def prefill_chunk_slot(self, params, inputs, cache, slot: int, *,
                           first: bool, cap: int,
                           collect_moe_stats: bool = False):
        """One chunk of a chunked prefill for row ``slot`` of the shared
        per-slot cache, run on a batch-1 view of that row
        (``slice_cache_slot``), so the chunk writes the row and its fill
        level in place and no merge copy follows.

        ``first=True`` zeroes the row's cache and runs a fresh prefill
        from position 0: the row ends up as the reference's fresh zero
        batch-1 cache would after the merge, so nothing of the slot's
        previous occupant survives. Later chunks resume at the row's
        recorded fill level. Between chunks the engine freezes the row
        against decode writes (``decode_step(row_mask=...)``). ``cap`` is
        the cache capacity, as in the reference (it sizes the fresh cache
        there; here it must match the shared cache). Returns (logits,
        cache), plus the chunk's (n_moe_layers, 1, C, E) routing counts
        when ``collect_moe_stats``."""
        have = tf.cache_leaves(cache)[0].shape[2]   # (count, B, cap, ...)
        if cap != have:
            raise ValueError(f"cap {cap} != the cache's capacity {have}")
        sub = tf.slice_cache_slot(cache, slot)
        if first:
            for leaf in tf.cache_leaves(sub):
                leaf.zero_()
            sub["len"].zero_()
        out = self.prefill(params, inputs, sub, continuation=not first,
                           collect_moe_stats=collect_moe_stats)
        return (out[0], cache) + tuple(out[2:])

    @property
    def n_moe_layers(self) -> int:
        """MoE layer count, in the canonical routing-stats order."""
        return tf.moe_layer_count(self.cfg)

    def chunkable_len(self, cache_cap: int) -> int | None:
        """Longest (padded) prompt absorbable in chunks: ``None`` when
        unbounded, 0 when the arch cannot chunk at all. MLA is 0, as in
        the reference: its prefill writes the latent cache from offset 0
        only. Global GQA caches continue without bound. (The reference's
        other bounds come with layer kinds the port does not have:
        encoder-decoder 0, sliding-window rings the ring size.)"""
        return 0 if self.cfg.mla is not None else None

    def supports_chunked_prefill(self, total_len: int,
                                 cache_cap: int) -> bool:
        """Whether a ``total_len``-token (padded) prompt may be absorbed in
        chunks (see ``chunkable_len``)."""
        lim = self.chunkable_len(cache_cap)
        return lim is None or total_len <= lim
