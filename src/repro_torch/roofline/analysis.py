"""Three-term roofline of one step on an H100 (port of
``repro/roofline/analysis.py``).

Per (arch x shape x card count), from the dry run (``launch.dryrun``):

    compute    = FLOPs            / peak_FLOP/s
    memory     = HBM bytes        / HBM_bw
    collective = collective bytes / link_bw

each per card. FLOPs come from ``torch.utils.flop_counter`` over the step
traced on the ``meta`` device; the collective bytes are the EP rounds'
(``ep_round_bytes``), reckoned from the capacity buckets' shapes. The
reference parses XLA's HLO text for its collective bytes
(``collective_bytes_from_hlo``); the port compiles no HLO, so that
function has no counterpart here. MODEL_FLOPS = 6·N·D (6·N_active·D for
MoE) and the useful-compute ratio MODEL_FLOPS / FLOPs are recorded as in
the reference.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HW:
    """Per-card hardware constants. The defaults are NVIDIA's H100 SXM5
    data sheet figures, not measurements: dense bf16 tensor-core FLOP/s
    (989 TF/s without sparsity), HBM3 bandwidth (3.35 TB/s) and NVLink 4
    bandwidth per direction (900 GB/s bidirectional, 450 GB/s each way)."""
    peak_flops: float = 989e12        # bf16 FLOP/s
    hbm_bw: float = 3.35e12           # bytes/s
    link_bw: float = 450e9            # bytes/s, one direction


H100 = HW()


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D train, 2·N·D inference (N = active params)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: 1 token per seq


def ep_round_bytes(cfg, n_tokens: int, n_ranks: int) -> int:
    """Bytes the EP permutation rounds copy for ONE MoE layer over
    ``n_ranks`` ranks, self-traffic excluded: what
    ``distributed.LocalGroup.copy_bytes`` counts for the layer.

    ``ep_dispatch_combine`` pads the ``n_tokens`` tokens to a multiple of
    the ranks, so each rank routes ``t_loc = ceil(n_tokens / n_ranks)``
    tokens into per-expert buckets of ``capacity(t_loc, ...)`` rows. Every
    round moves each pair's whole bucket block, (E/n, C, d), whatever the
    routing: the dispatch copies it for each of the n(n-1) ordered pairs
    (an exact cover of rounds holds each pair once), and the return copies
    the experts' outputs back through the same pairs. The kernel path pads
    a rank's rows to ``align_capacity(rows, block_c)`` only inside
    ``alltoall.rank_ffn``, after the arrival, and cuts the padding off
    before the return, so the padding never travels. The activations'
    element size is ``cfg.dtype``'s; the layout is unreplicated (a
    replication's E' physical experts would take E's place). The
    monolithic all-to-all moves the same bytes between ranks in one
    exchange (``LocalGroup`` does not count it)."""
    if cfg.moe is None or n_ranks <= 1:
        return 0
    from ..models.moe import capacity
    moe = cfg.moe
    elem = {"float32": 4, "bfloat16": 2}[cfg.dtype]
    t_loc = -(-n_tokens // n_ranks)
    cap = capacity(t_loc, moe.top_k, moe.n_experts, moe.capacity_factor)
    pairs = n_ranks * (n_ranks - 1)
    return 2 * pairs * (moe.n_experts // n_ranks) * cap * cfg.d_model * elem


def roofline_report(flops: float, hbm_bytes: float, collective_bytes: float,
                    n_devices: int, cfg=None, shape=None,
                    hw: HW = H100, arg_bytes: float | None = None,
                    out_bytes: float | None = None) -> dict:
    """The three roofline terms (seconds) + bottleneck + useful-FLOP ratio.

    ``flops``/``hbm_bytes``/``collective_bytes`` are PER CARD, so each term
    divides by one card's rate. ``n_devices`` scales MODEL_FLOPS (a global
    quantity) down to per card for the useful-compute ratio.
    """
    compute_s = flops / hw.peak_flops if flops else 0.0
    memory_s = hbm_bytes / hw.hbm_bw if hbm_bytes else 0.0
    collective_s = collective_bytes / hw.link_bw if collective_bytes else 0.0
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get) if any(terms.values()) else "none"
    rec = dict(terms, dominant=dominant)
    if arg_bytes is not None:
        # Analytic HBM floor: every live byte (weights + state in, state
        # out) touched exactly once.
        rec["memory_floor_s"] = (arg_bytes + (out_bytes or 0.0)) / hw.hbm_bw
    if cfg is not None and shape is not None:
        mf = model_flops(cfg, shape)
        rec["model_flops"] = mf
        rec["useful_flop_ratio"] = (mf / n_devices / flops) if flops else 0.0
    return rec
