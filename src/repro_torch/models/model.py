"""Top-level model facade (port of ``repro/models/model.py``): params,
caches, training logits, serving, and ``cross_entropy``.

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

from ..bridge import map_tree
from ..device import resolve_device
from . import transformer as tf
from .layers import KernelConfig, ParallelContext
from .moe import ReplicationSpec


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

    def init_cache(self, batch: int, cap: int, src_len: int = 0,
                   per_slot_len: bool = False):
        """``src_len``: the source positions of an encoder-decoder's cross
        K/V (0 for every other family). With a mesh ``pc``, ``batch``,
        ``cap`` and ``src_len`` are global and the cache is this rank's
        zero shard under ``sharding.cache_specs`` (they must be the
        ``pc``'s)."""
        pc = self.pc
        if pc is None or pc.mesh is None:
            return tf.init_cache(self.cfg, batch, cap, src_len=src_len,
                                 per_slot_len=per_slot_len,
                                 device=self.device)
        from ..bridge import shard_cache
        from ..sharding import cache_specs
        if (batch, cap, src_len) != (pc.batch, pc.cap, pc.src_len):
            raise ValueError(f"the mesh pc is laid out for batch {pc.batch}, "
                             f"cap {pc.cap} and src_len {pc.src_len}, not "
                             f"{batch}, {cap} and {src_len}")
        full = tf.init_cache(self.cfg, batch, cap, src_len=src_len,
                             per_slot_len=per_slot_len, device="meta")
        shard = shard_cache(full, cache_specs(self.cfg, pc.mesh, batch, cap,
                                              src_len), pc.mesh,
                            pc.mesh.rank)
        return map_tree(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                              device=self.device), shard)

    @property
    def padded_vocab(self) -> int:
        return tf.padded_vocab(self.cfg)

    # -- training ----------------------------------------------------------
    def train_logits(self, params, batch, remat: bool = True):
        """batch: {"tokens": (B, S)}, plus "frames" (B, S_src,
        frontend_dim) for an encoder-decoder (the encoder's input; the
        tokens are the decoder's) and optionally "embeds" (B, S,
        frontend_dim) for a patch-input config. The cacheless forward from
        position 0, each block under ``torch.utils.checkpoint`` when
        ``remat``. Returns (logits (B, S, padded_vocab), aux_loss).

        Training takes the reference's plain route: the dense MoE dispatch
        and ``attention_core``. A model with ``kernels`` attached raises
        ValueError: the CUDA ``moe_gmm`` has no backward, so its expert
        leaves would get no grad on the card. So does a ``replication``
        (each copy of an expert would get its own grad, and the copies
        would stop being identical) and the EP engines' ``pc`` without a
        mesh (its ranks each hold every expert leaf, so a step would train
        copies; the reference trains on a mesh). A mesh ``pc`` runs the
        rank program (``sharding.make_pc``): params and batch are this
        rank's shards, the logits come back gathered over the vocab, and
        the MoE layers dispatch over the mesh's EP group ("ep" or
        "aurora"); its grads follow ``distributed.mesh``'s convention
        (``training.loop.loss_and_grads``)."""
        pc = self.pc
        if self.kernels is not None:
            raise ValueError("train_logits runs the plain route: the "
                             "kernels have no backward (use a Model "
                             "without with_kernels)")
        if pc is not None and pc.mesh is None and pc.expert_parallel:
            raise ValueError("expert-parallel training runs on a mesh pc "
                             "(sharding.make_pc), not the EP engines' "
                             "layout")
        if self.replication is not None:
            raise ValueError("replicated experts cannot be trained: their "
                             "copies would drift apart")
        if pc is not None and pc.mesh is None:
            pc = None
        enc_out = None
        if self.cfg.is_encoder_decoder:
            enc_out = tf.encode(params, self.cfg, batch["frames"], pc)
        return tf.forward(params, self.cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"), enc_out=enc_out,
                          mode="train", remat=remat, pc=pc)

    # -- serving -----------------------------------------------------------
    def prefill(self, params, inputs, cache, collect_moe_stats: bool = False,
                continuation: bool = False):
        """inputs: {"tokens": (B, S)} | {"embeds": (B, S, frontend_dim)}
        (patch embeddings of a vlm) | {"frames": (B, S_src,
        frontend_dim), "tokens"} (an encoder-decoder: the encoder runs
        over the frames, and the decoder's cross K/V are written into the
        cache, which must hold S_src source positions). A fresh prefill
        from position 0, or with ``continuation=True`` one that resumes at
        the cache's fill level (a scalar, or a (B,) vector: each row at its
        own offset), so a prompt absorbed chunk by chunk equals a one-shot
        prefill. The cache is written in place. Returns (logits, cache),
        plus the (n_moe_layers, B, S, E) per-position routing counts when
        ``collect_moe_stats`` (mask left-pad positions before
        aggregating)."""
        enc_out = None
        if self.cfg.is_encoder_decoder:
            enc_out = tf.encode(params, self.cfg, inputs["frames"], self.pc)
        out = tf.forward(params, self.cfg, tokens=inputs.get("tokens"),
                         embeds=inputs.get("embeds"), enc_out=enc_out,
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
        recorded fill level. Zeroing the row is also what keeps an SSM
        slot's conv window and state from leaking into its next request.
        Between chunks the engine freezes the row against decode writes
        (``decode_step(row_mask=...)``). ``cap`` is the cache capacity, as
        in the reference (it sizes the fresh cache there; here it must
        match the shared cache's, rings included). Returns (logits,
        cache), plus the chunk's (n_moe_layers, 1, C, E) routing counts
        when ``collect_moe_stats``."""
        tf.check_capacity(self.cfg, cache, cap)
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
        only; so is an encoder-decoder (its encoder would re-run per
        chunk). A sliding-window ring continues exactly while the prompt
        stays inside it (a prompt that wraps it would lose slot identity
        mid-prefill), so a stack with L layers is bounded by the ring,
        ``transformer.entry_capacity("L", ...)``. SSM state and global GQA
        caches continue without bound."""
        cfg = self.cfg
        if cfg.mla is not None or cfg.is_encoder_decoder:
            return 0
        if any(k == "L" for seg in tf.segments_of(cfg) for k in seg.kinds):
            return tf.entry_capacity("L", cfg, cache_cap)
        return None

    def supports_chunked_prefill(self, total_len: int,
                                 cache_cap: int) -> bool:
        """Whether a ``total_len``-token (padded) prompt may be absorbed in
        chunks (see ``chunkable_len``)."""
        lim = self.chunkable_len(cache_cap)
        return lim is None or total_len <= lim


def cross_entropy(logits, labels, vocab: int):
    """Mean cross-entropy over tokens (the reference's ``cross_entropy``).
    logits (B, S, Vpad) may carry padded vocab slots, which get -1e30; the
    log-sum-exp is taken in float32 about its detached max, and the label's
    logit is a select-and-sum over the vocab."""
    vpad = logits.shape[-1]
    logits = logits.float()
    slot = torch.arange(vpad, device=logits.device)
    if vpad > vocab:
        logits = torch.where(slot >= vocab, -1e30, logits)
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    lab = torch.where(slot == labels[..., None], logits, 0.0).sum(dim=-1)
    return (lse - lab).mean()
