#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit. Phases, each printing one JSON line; any failure exits
non-zero:

1. device: a CUDA card, its name and power limit (``nvidia-smi``); TF32 off.
2. build: every kernel under ``src/repro_torch/kernels/csrc``, one ``nvcc``
   per source, all at once.
3. parity: each kernel against its plain PyTorch version on the card, at the
   serving path's shapes (bf16: decode and prefill buckets, fill levels
   0, 1 and S; ``decode_attn`` also at the dense families' G = 3, G = 1
   with D = 256, G = 8 and at a 1024-ring at capacity), at ragged edges,
   and at small fp32 shapes.
4. reference: reduced phi3.5-MoE (fp32) served on the card through the
   kernels and through the plain path, with one-shot admission and with
   three chunked ones (chunks of 8; chunks of 8 with a budget of 12 and a
   pool of 3; EDF over the same chunk and budget with a TTFT tenant);
   kernel and plain streams must be identical, and the chunked streams
   (pooled, budgeted, EDF) must equal the serialised chunked ones. Then
   two tenants in ``ColocatedContinuousEngine`` and three in
   ``MultiTenantContinuousEngine`` (chunks of 8), with and without a
   forced re-plan: kernel streams equal plain ones, re-planned streams
   equal static ones, at least one placement adopted.
5. serve: full-width phi3.5-MoE cut to 8 layers (bf16, seeded random
   weights) in ``ContinuousEngine(kernels=True)`` serving a Poisson stream
   with one-shot admission; every request gets all its tokens, logits are
   finite, and the kernels' launch counters match the path (decode_attn: 8
   per decode step; moe_gmm: 8 per decode step and per prefill). Step ms
   (pure decode steps and steps that ran a prefill), TTFT, tok/s and peak
   memory are printed, not gated.
6. serve_chunked: the same model and stream with chunked admission, twice:
   chunks of 64 serialised, then a pool of 4 under a budget of 136 tokens
   (8 decode tokens and two chunks). Gates: every request complete, the
   two runs' streams identical, no prefill left in flight, finite logits,
   and exact launch counts (decode_attn: 8 per decode step; moe_gmm: 8 per
   decode step and per chunk call). The same numbers as serve are printed,
   and the ms of one 64-token chunk.
7. timing: each kernel at the serve phase's decode shapes (CUDA events,
   L2 flushed before each launch) beside its plain version, its bound and
   a one-call PyTorch yardstick where one exists; then ``moe_gmm`` at the
   batch-1 prefill buckets (C = 16, 24, 48 for 64, 128, 256 tokens).
8. profile: ten decode steps of the served model, then ten 64-token
   chunk calls, under ``torch.profiler``: host wall time against device
   busy time (the idle share) and the kernels that take the device time.
9. serve_colocated: the serve phase's model as tenant A beside tenants B
   and C (seeds 1 and 2, ~21.3 GB each), each with its own stream: (a)
   ``ColocatedContinuousEngine`` with the planner's pairing, (b) the same
   with a forced re-planner, (c) ``MultiTenantContinuousEngine`` over
   three tenants with chunks of 64, without and with a forced re-group.
   Gates: re-planned and re-grouped streams equal the static runs', at
   least one adoption each, exact launch counts, each adoption's
   transient memory (its peak beyond the memory before it) within one
   (16, 4096, 6400) expert slab. Lockstep
   step ms, tok/s per tenant, re-plan step ms, the host ms of planning and
   of observing the counts, and each adoption's ms and memory are printed.
   Then the profile of a 2-tenant lockstep decode step, with and without
   the routing counts, and the two timed in alternated rounds.
10. serve_replicated: the serve phase's model and stream, monitored. A
   ``plan_replicated`` replication (padded to 20 physical experts with the
   planner's best copies) of the counts the ``TrafficMonitor`` saw
   unreplicated is (a) adopted
   before the stream and (b) adopted mid-stream by a forced
   ``OnlineReplanner.maybe_replicate``, then dropped with
   ``adopt_replication(None)``. Gates: streams equal the serve phase's,
   exact launch counts, each adoption's transient memory within one
   widened (n_phys, d, F) slab. Printed: n_phys, the engine's weights
   before and after, step ms replicated against unreplicated (alternated
   decode rounds), and ``moe_gmm`` at E' = n_phys, C = 8 against its bound.
11. chaos: a ``ChaosHarness`` over the replicated engine (4 virtual
   devices, slot % 4): a corruption of a routed replicated hot expert
   (repaired from a replica), of a routed unreplicated one (restored from
   the pristine host copy), a straggler, and the loss of one device
   (requeue, degraded re-plan adopted; the lost device stands for the 4
   of the planner's 16 whose index % 4 is its own). Gates: streams equal
   the serve phase's, every action seen, the degraded plan's survivors
   the other 12, exact launch counts (from the hub's spans).
   Printed: per-step checkpoint ms, restore + repair + re-run ms, the
   pristine copy's bytes and seconds.
12. telemetry: the serve stream without and with a ``Telemetry`` hub
   (``block_steps=True``): streams equal, one span per step callable run,
   JSONL and Chrome trace written under ``chiprun_out/``; step ms of both.
13. serve_ep: the serve phase's model and stream through
   ``DistributedEngine`` over ``LocalGroup(4, cuda)`` (4 in-process ranks
   of 4 experts, shards that are views of the served params): (a) "ep",
   (b) "aurora" with round robin, (c) "aurora" with rounds from the
   monitored counts adopted mid-stream, (d) (b) with the overlap. Gates:
   the four streams identical, every request complete, finite logits,
   exact launch counts (decode_attn 8 per decode step; moe_gmm 8 x 4 per
   decode step and per prefill, 8 x 4 x (R + 1) with the overlap's R
   rounds), the EP layer within 2e-2 of the plain EP layer (fp32) and
   of the unsharded kernel layer, the peak within 1 GB of the serve phase's.
   Printed: decode-step ms in alternated rounds, a profile of the (b)
   and (d) decode steps, one rank's ``moe_gmm`` against its bound, the
   round copies' bytes and ms, the drops of a padded 256-token prefill.
   The exchange is in-process: no network cost is measured.
14. serve_dense, beside the still loaded phi3.5-MoE, one dense model at
   a time (each freed before the next is made), full width in bf16:
   phi4-mini cut to 8 of 32 layers (G = 3) on the serve stream one-shot
   and with chunks of 64, through ``ServingEngine`` (8 prompts of 128
   tokens, 32 new) and in ``ColocatedContinuousEngine`` beside
   phi3.5-MoE (both on the serve stream); gemma-7b cut to 8 of 28 layers
   (G = 1, D = 256) one-shot;
   gemma3-27b cut to 6 layers (one LLLLLG block, cache 4096, rings of 1024,
   prompts padded to multiples of 64) on the first 8 requests of the
   serve stream and a 1000-token and a 2100-token prompt; qwen3-32b cut
   to 4 layers (q/k-norm, G = 8) one-shot. Gates: every request
   complete, exact launch counts (``decode_attn`` once per layer and
   decode step, ``moe_gmm`` 0; colocated: 8 + 8 ``decode_attn`` a step,
   8 ``moe_gmm`` a step and a phi3.5 prefill), finite logits, the peak
   beyond what was held before within 2 GB of the model's weights and
   caches (the peak over the weights alone printed beside it), gemma3's
   flash branch taken and its rings wrapped in prefill and in decode
   (seen at the calls: ``_attn_tally``), each colocated tenant's stream
   its solo stream, and ``decode_attn`` within 2e-2 of its plain version
   on each arch's served layers (gemma3: a wrapped ring and the 4096
   global cache), each then timed beside SDPA and its bound. Printed: the
   serve numbers, the static batch's tok/s, a profile of phi4-mini's
   decode step, and whether the chunked and static streams equal the
   one-shot ones (bf16 rounding may part them: not gated).
15. serve_families, beside the still loaded phi3.5-MoE, one model at a
   time (each freed before the next is made), full width and depth in
   bf16: mamba2-1.3b (48 Mamba2 layers) on the serve stream one-shot and
   with chunks of 64; zamba2-7b (70 Mamba2 layers and one shared
   attention block used 11 times, D = 112) and qwen2-vl-7b (28 layers,
   M-RoPE, G = 7) on the serve stream one-shot, qwen2-vl also one batch-1
   prefill of 256 seeded patch embeddings; SeamlessM4T (24 encoder and
   24 decoder layers, D = 64) through ``ServingEngine`` (8 prompts of 128
   tokens, frames (8, 128, 1024), 32 new). Gates: every request
   complete, finite logits, exact launch counts (``decode_attn`` once per
   attention layer and decode step, by (H, S) at the call sites;
   ``moe_gmm`` 0), the peak within 2 GB of the weights and caches, and
   ``decode_attn`` within 2e-2 of its plain version on each attention
   arch's served layer, then timed beside SDPA and its bound. Printed:
   the serve numbers, a profile of three of each arch's frozen decode
   steps (3000-5000 kernels a step make a longer trace slow to read), and
   whether mamba2's chunked stream equals its one-shot one (not gated).
   Then mamba2, zamba2 and qwen2-vl, each still held, serve their stream
   beside phi3.5-MoE serving the serve stream in
   ``ColocatedContinuousEngine`` (8 slots, cache 512, kernels on; no
   pairing: the families have no experts), and mamba2, kept until
   qwen2-vl is loaded, serves with both in ``MultiTenantContinuousEngine``.
   Gates: every request complete, finite logits, each tenant's stream
   its solo stream (the same kernels on the same batch shapes), exact
   launch counts per tenant (``decode_attn`` per attention layer and
   lockstep step, told apart by heads and head_dim; ``moe_gmm`` per
   phi3.5 MoE layer and decode or prefill), the peak within 2 GB of the
   weights and caches. Printed: the lockstep step's mean, p50 and p95
   beside the sum of the tenants' solo step means, and a profile of one
   frozen lockstep step. SeamlessM4T does not colocate: the
   engines pass no frames to its encoder.
16. serve_deepseek, run last, after the phi3.5 model, params and engines
   are freed (under 1 GB must stay allocated): full-width DeepSeek-V3 cut
   to 5 layers (the 3 published dense layers and 2 MoE layers; MLA, 256
   experts top-8, sigmoid router, shared expert; bf16, ~53.2 GB) serving
   the serve phase's stream one-shot, then through ``DistributedEngine``
   over ``LocalGroup(4, cuda)`` (64 experts a rank) as "ep" and "aurora".
   Gates: every request complete, finite logits, exact launch counts
   (``moe_gmm`` 2 per decode step and per prefill, x 4 under EP;
   ``decode_attn`` 0), the peak within 2 GB of the weights (EP: within
   1 GB of the unsharded run's), ``moe_gmm`` within 2e-2 of its plain
   version on the served layer's leaves at a real decode step's buckets
   (256, 8, 7168, 2048), a 256-token prefill's and one EP rank's (over
   slices of 32 experts: the plain version upcasts the weights), the EP
   streams identical, the EP layer within 2e-2 of the unsharded kernel
   layer at the decode batch. Printed: weights GB, init s, step ms, TTFT,
   tok/s, ``moe_gmm`` ms beside its bound, a decode-step profile, EP
   decode steps in alternated rounds, the phase's seconds.
17. train, once DeepSeek-V3 is freed (under 1 GB must stay
   allocated; train_mesh, 20., follows it). Training takes the reference's plain route (dense MoE
   dispatch, ``attention_core``; neither Pallas kernel has a backward):
   (a) one ``make_train_step`` of each of the ten reduced archs (fp32,
   B 2, S 16, frames for SeamlessM4T) on the card and on the CPU from the
   same weights and batch: the loss within 1e-5 relative, every grad leaf
   and updated param leaf within 1e-5 + 1e-4 x the leaf's largest
   magnitude; (b) reduced phi3.5-MoE through ``train_loop`` on the card,
   40 steps (the reference's MoE loss check: the last ce below the
   first, aux finite), then an exact checkpoint round trip of its params
   and optimizer state; (c) full-width phi3.5-MoE cut to 2 layers (bf16,
   remat, fp32 moments, lr 1e-3, warmup 2) on ``SyntheticLMData`` at
   batch 1 x 4096 (the flash branch), 10 steps: loss and aux finite at
   every step, every grad leaf finite, every param leaf moved by step 1,
   the peak within 4 GB of ``TRAIN_PEAK_GB``; printed: step ms, tokens/s,
   the model FLOPs' share of 989 TF/s, forward+backward against the
   optimizer (CUDA events) and a profile of one step; (d) ``python -m
   repro_torch.launch.train`` in a subprocess (reduced, 3 steps, a
   checkpoint). Gate over the phase: both kernels' launch counters
   unmoved.
18. dryrun, in three parts, each right after the phase it checks (it
   reuses what that phase built): after serve_families, phi3.5 as the
   serve phases run it; at the end of serve_deepseek, DeepSeek-V3 as it
   is loaded there; at the end of train (c), its step. The predictions
   are ``repro_torch.launch.dryrun.run_one``'s, traced on the ``meta``
   device. Gates: (a) the argument bytes of the decode step at 8 slots
   and cache 512 (params, a fresh cache, the tokens; phi3.5 and
   DeepSeek-V3) and of the train step (params, AdamW state, the batch)
   equal the live trees' bytes exactly; (b) the predicted arguments plus
   temp within 10 % of ``max_memory_allocated`` over one plain-path call
   of phi3.5's decode step and of the train step (less the bytes the card
   held that are not the arguments); (c) ``FlopCounterMode`` over that
   call on the card equals the prediction; (d) ``ep_round_bytes`` equals
   ``LocalGroup(4, cuda).copy_bytes`` over phi3.5's decode step and a
   1000-token prefill on the kernel path (round-robin aurora rounds, sync
   and pipelined). Printed: the step's median ms beside the roofline
   terms on the H100 data sheet's constants (``roofline.H100``).

19. serve_mesh, after the dryrun part of phi3.5 and before DeepSeek-V3
   is made: the reference's mesh layout (``sharding.rules``) as the rank
   program on 4 in-process ranks of the card (``ThreadMesh``, a (1, 4)
   mesh over (data, model)), bf16 at full width, the kernels on. First
   ``decode_attn``'s LSE output against its plain version at the per-rank
   shapes (8, 8, 2, 128, 128), (8, 16, 2, 128, 128) and those the rank
   program launches, (8, 32, 8, 128, 128), (8, 64, 8, 128, 128), (8, 32,
   32, 112, 128) (zamba2) and (8, 16, 16, 64, 128) (SeamlessM4T), fill
   levels 0 to 128 (output within 2e-2, LSE within 1e-5, an empty shard's
   LSE -inf), and with a null LSE (the same output bit for bit). Then
   phi3.5-MoE at 2 layers (the loaded
   params' first 2 layers cut into 4 shards: experts over (data, model),
   heads 32/4, kv heads 8/4, vocab over model; capacity factor 8.0 on
   both sides, so no token is dropped by either dispatch), the same in
   fp32 at 2 layers, qwen3-32b at 2 of 64 layers (head-parallel dense,
   made and freed here), then mamba2-1.3b at 4 of 48 layers, zamba2-7b
   at 14 of 81 (two uses of the shared block) and SeamlessM4T at 4
   encoder and 4 decoder
   layers over frames (8, 128, 1024) (32 source positions a rank), each
   in bf16 and again in fp32 at 2, 7 and 2 + 2 layers, each made and
   freed here; each on 8 prompts of 380 tokens with a cache of 512 (128
   positions a rank: the prompts fill ranks 0-2, and the decode's writes
   cross into rank 3's shard): the unsharded greedy stream of 16 tokens
   fed to the rank program, whose logits must lie within 2e-2 (qwen3 and
   the families in bf16) or 1e-4 (fp32) of the unsharded largest logit,
   beside the control's own kernel-against-plain error (zamba2 in bf16,
   which bf16 rounding alone puts 0.04 off an fp32 copy of its weights,
   is held within 0.06 of that copy instead, and two layout faults
   planted in its rank program must land past 0.06), for phi3.5 in bf16
   in the median over rows and steps (near-tied top-2 choices flip
   under rounding, in the unsharded kernel and plain paths too); the rank
   program's own greedy stream compared (first divergence printed; the
   families' bf16 runs are teacher-forced only); exact launches over its
   runs (``decode_attn`` per attention layer, rank and step, ``moe_gmm``
   per MoE layer, rank and call); in bf16, rank 0's argument bytes
   equal to the dry run's ``lowering_args`` on the same mesh and step,
   to the byte; the thread transport's collective bytes over one plain
   decode step equal to the counting transport's. The ``kernels`` line
   gains ``decode_attn`` at rank 0's shard with the LSE (phi3.5, qwen3,
   zamba2, SeamlessM4T; beside the memory-efficient SDPA kernel with
   ``compute_log_sumexp``) and ``moe_gmm`` at rank 0's experts, each
   within 2e-2 of its plain version.

20. train_mesh, after train: sharded training on the mesh rank program,
   4 thread ranks of the card on a (2, 2) mesh over (data, model), the
   plain route (no kernel has a backward). First, why thread ranks run
   one joint backward: two thread ranks whose all_reduce has a per-rank
   backward waiting at the thread barrier, each calling backward itself,
   block CUDA's one autograd thread until the barrier times out (5 s;
   printed, not gated), where ``RankMesh.grad`` gives the right grads
   (gated). (a) One ``make_train_step`` of
   each of the ten reduced archs (fp32, B 4 x S 16, frames of 8 for
   SeamlessM4T, capacity factor E so no token is dropped) against the
   unsharded card step from the same weights and batch (its MoE aux the
   mean over the 4 token shards, as the EP layer's ``ep_mean`` takes
   it): the loss within 1e-5 relative, the updated params and both AdamW
   moments, reassembled from the shards, within 1e-5 + 1e-4 x each
   leaf's largest magnitude. (b) The same at full width: phi3.5-MoE at 1
   layer in fp32 (experts over data x model, 4 a rank), batch 2 x 2048,
   one step, the unsharded step run first and only its updated params
   and moments kept (on the host). (c) phi3.5-MoE at 2 layers in bf16
   with remat, batch 2 x 2048, 5 steps: losses finite, rank 0's argument
   bytes and each step's collective bytes equal to the dry run's trace of
   rank 0 on ``meta`` to the byte; printed: step ms and their median, a
   profile of one step (device kernels a step), the card's peak beside 4
   x the dry run's per-device total. (d) Neither kernel's launch counter
   moves. (e) (b)'s model and batch under Aurora's rounds: one step
   through the round-pipelined EP body (``ep_overlap``) against the same
   step through the synchronous one, at (a)'s tolerance; printed: both
   runs' step ms. (f) The same for the reduced MoE archs. Alone:
   ``python3 -c "import sys; sys.path.insert(0, 'src');
   import chip_smoke as c; c.phase_device(); c.phase_train_mesh()"``.
21. legacy_and_examples, after serve_ep (phi3.5 still loaded): the serve
   phase's model in a ``ContinuousEngine`` built with the reference's
   legacy keywords (``prefill_chunk=64, kernels=True``) warns once and
   emits the greedy streams of the ``EngineConfig``-built engine (its
   launches join the kernel rows'); then each ``examples/torch/*.py``
   ``main`` on the card at reduced flags (``train_moe`` 20 steps, first
   and last ce printed; their output in
   ``chiprun_out/examples_stdout.txt``), with nothing of JAX imported.

Phase 4 also serves the four reduced dense archs (phi4-mini, gemma-7b,
qwen3-32b, gemma3-27b with its LG layers and a ring of 16; fp32) through
the kernels and the plain path (streams identical; gemma3 also with
chunks of 4, equal to its one-shot stream), and each through the static
``ServingEngine``, equal to ``ContinuousEngine`` when every request
arrives at t = 0. It serves reduced DeepSeek-V3 (fp32, D + E, 4 experts top-2,
sigmoid, shared expert) through the kernels and the plain path (streams
identical), and at capacity factor 8.0 unsharded and through
``DistributedEngine`` over ``LocalGroup(4, cuda)`` as "ep" and "aurora"
(streams equal the unsharded one). It serves reduced mamba2, zamba2 and
qwen2-vl (fp32) through ``ContinuousEngine`` and reduced SeamlessM4T
through ``ServingEngine`` with seeded frames, on the kernels and on the
plain path (streams identical; mamba2 also with chunks of 4, equal to its
one-shot stream). It also serves reduced phi3.5-MoE
widened to 8 experts (cf 8.0) through ``DistributedEngine`` over
``LocalGroup(4, cuda)``: "ep", "aurora" (round robin, and rounds adopted
from a trace), the overlap, and a ``ChaosHarness`` loss of rank 3 that
rebuilds the group over 2 ranks; kernel streams equal plain ones and all
equal the unsharded stream. The
parity phase holds ``moe_gmm`` at one EP rank's shapes too: (4, 8, 4096)
and (4, 2, 4096) in bf16.

The parity phase also holds ``moe_gmm`` at replicated group sizes and with
NaN-poisoned experts (NaN exactly in a live poisoned group's live rows,
zeros elsewhere in it and in a dead poisoned group), and gates that each
kernel's wrapper refuses a CUDA input that needs a grad (neither kernel
has a backward) before it launches. Then a ``{"kernels":
[...]}`` line (``moe_gmm`` at phi3.5's decode bucket and at DeepSeek-V3's,
``decode_attn`` at phi3.5's shape, at each dense arch's and at zamba2's,
qwen2-vl's and SeamlessM4T's) and, last,
the ``{"ok": true, ...}`` line. Nothing of JAX
is imported.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

N_LAYERS = 8                     # depth cut: full widths, 8 of 32 layers
SLOTS, CACHE_CAP = 8, 512
# Physical expert slots asked of plan_replicated (its total_multiple): one
# card gains nothing from replicas, so the phases ask for the planner's 4
# best copies even on near-balanced counts.
PHYS_SLOTS = 20


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond, phase: str, msg: str) -> None:
    if not cond:
        emit(phase, ok=False, error=msg)
        raise SystemExit(1)


def max_errs(got, want):
    diff = (got.float() - want.float()).abs()
    rel = diff / want.float().abs().clamp_min(1e-6)
    return float(diff.max()), float(rel.max())


def time_ms(fn, flush, iters: int = 20) -> float:
    """Mean device ms of ``fn`` over ``iters`` runs, CUDA events around each
    run, the L2 cache overwritten (``flush``) before each, after warm-up.
    A ~0.5 ms device spin before each start event lets the host enqueue the
    whole run first, so host launch latency stays out of the device time."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def h100():
    """The H100 SXM's data-sheet rates, ``repro_torch.roofline.H100``:
    ``hbm_bw`` 3.35e12 B/s, ``peak_flops`` 989e12 dense bf16 FLOP/s."""
    from repro_torch.roofline import H100
    return H100


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the bf16 tensor-core rate."""
    t_bytes, t_ops = nbytes / h100().hbm_bw, flops / h100().peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    import torch
    require(torch.cuda.is_available(), "device", "torch.cuda.is_available() "
            "is false: this smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", ok=True, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    print(smi, flush=True)
    return smi


def phase_build():
    from repro_torch.kernels import _build
    out = _build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in out["logs"].items()}
    emit("build", ok=True, seconds=out["seconds"], ptxas=ptxas)


def _moe_case(torch, gen, e, c, d, f, dtype, sizes):
    dev = "cuda"
    x = torch.randn((e, c, d), generator=gen, device=dev, dtype=dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    x[torch.arange(c, device=dev)[None, :] >= gs[:, None]] = 0   # pad rows
    w = [torch.randn(shape, generator=gen, device=dev, dtype=dtype) * s
         for shape, s in (((e, d, f), d ** -0.5), ((e, d, f), d ** -0.5),
                          ((e, f, d), f ** -0.5))]
    return x, w, gs


def phase_parity():
    """Each kernel against its plain version. Tolerances: bf16 2e-2 (the
    reference's kernel tolerance; h and the output round to bf16 at places
    that depend on summation order), fp32 1e-4 (sums over up to 6400 terms
    in another order). Rows past a bucket's group size must be exactly 0."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decode_attn import geometry as attn_geometry
    from repro_torch.kernels.moe_gmm import geometry as moe_geometry
    from repro_torch.kernels.moe_gmm import moe_gmm
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"moe_gmm": 0.0, "decode_attn": 0.0}
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    full = (16, 4096, 6400)                     # E, d, F of phi3.5-MoE
    # Group sizes: empty experts, full buckets and partial ones, at the
    # decode bucket (C = 8), the prefill buckets (16, 24, 48) and a prompt
    # of 3 tokens; then ragged d/F, a bucket taller than one row block, and
    # the fp32 route.
    moe_cases = [
        (full, 3, torch.bfloat16, [0, 3, 1, 0, 2, 3, 0, 0, 1, 0, 0, 3, 0, 0, 2, 0]),
        (full, 8, torch.bfloat16, [0, 8, 3, 0, 1, 8, 2, 0, 5, 0, 1, 7, 0, 2, 0, 4]),
        (full, 16, torch.bfloat16,
         [16, 0, 9, 16, 1, 8, 15, 0, 3, 16, 7, 0, 12, 16, 2, 5]),
        (full, 24, torch.bfloat16,
         [24, 0, 17, 9, 0, 24, 1, 12, 0, 20, 5, 0, 24, 8, 16, 0]),
        (full, 48, torch.bfloat16,
         [48, 31, 0, 47, 17, 48, 8, 33, 0, 40, 25, 1, 48, 36, 9, 29]),
        ((3, 96, 136), 40, torch.bfloat16, [0, 40, 13]),
        ((2, 64, 128), 100, torch.bfloat16, [100, 70]),
        ((3, 96, 128), 40, torch.float32, [0, 40, 13]),
        # One EP rank's experts (16 over 4 ranks): the synchronous body's
        # received buckets at decode (4 sources x C = 2, each source's
        # kept rows a prefix of its segment; the group size is the live
        # extent) and the pipeline's per-source chunks (C = 2).
        ((4,) + full[1:], 8, torch.bfloat16, [0, 6, 8, 3]),
        ((4,) + full[1:], 2, torch.bfloat16, [2, 0, 1, 2]),
    ]
    # The decode bucket over the physical groups of a replication: each
    # hot expert's rows split over its copies (``physical_group_sizes``).
    from repro_torch.models.moe import ReplicationSpec, physical_group_sizes
    rep_spec = ReplicationSpec.from_counts(
        (3, 1, 1, 2, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1, 1, 2))
    rep_sizes = physical_group_sizes(rep_spec, torch.tensor(
        [8, 0, 3, 5, 1, 0, 2, 0, 8, 0, 6, 1, 0, 2, 0, 4],
        dtype=torch.int32)).tolist()
    moe_cases.append(((rep_spec.n_phys,) + full[1:], 8, torch.bfloat16,
                      rep_sizes))
    for (e, d, f), c, dtype, sizes in moe_cases:
        x, (wg, wu, wd), gs = _moe_case(torch, gen, e, c, d, f, dtype, sizes)
        got = moe_gmm(x, wg, wu, wd, group_sizes=gs)
        want = ref.moe_ffn_ref(x, wg, wu, wd, group_sizes=gs)
        torch.cuda.synchronize()
        ab, rel = max_errs(got, want)
        dead_zero = bool((got[torch.arange(c, device="cuda")[None, :]
                              >= gs[:, None]] == 0).all())
        emit("parity", kernel="moe_gmm", shape=[e, c, d, f],
             dtype=str(dtype), route=moe_geometry(e, c, d, f, dtype)["route"],
             group_sizes=sizes, max_abs_err=ab, max_rel_err=rel,
             tol=tol[dtype], dead_rows_zero=dead_zero)
        require(ab <= tol[dtype] and dead_zero, "parity",
                f"moe_gmm {[e, c, d, f]} {dtype}: max abs err {ab}, "
                f"dead rows zero {dead_zero}")
        if dtype == torch.bfloat16:
            results["moe_gmm"] = max(results["moe_gmm"], ab)
        del x, wg, wu, wd
    _nan_parity(torch, gen, moe_gmm, ref, tol)
    # Fill levels: 0 (every score masked: the mean of V), 1, S, and fills
    # that are not multiples of 8, each through the serve path's entry
    # point. The first case is the served shape (2 blocks a row, each
    # copying its share in one tile: one buffer); the second has G = 8 and
    # 32 blocks a row; the third's share outgrows shared memory, so it
    # takes the two-buffer route (each tile copied during the one before);
    # the last two are fp32, one with 32 lanes per position.
    attn_cases = [
        (8, 32, 8, 128, CACHE_CAP, torch.bfloat16,
         [0, 1, CACHE_CAP, 77, 176, 316, 203, 299]),
        # The dense families' served shapes: G = 3 (phi4-mini), G = 1 at
        # D = 256 (gemma-7b: 32 lanes a position), G = 8 (qwen3), and
        # gemma3's 1024-ring (rows at its capacity: wrapped) beside its
        # 4096-position global cache.
        (8, 24, 8, 128, CACHE_CAP, torch.bfloat16,
         [1, CACHE_CAP, 200, 77, 0, 316, 511, 9]),
        (8, 16, 16, 256, CACHE_CAP, torch.bfloat16,
         [CACHE_CAP, 1, 130, 77, 400, 0, 255, 256]),
        (8, 64, 8, 128, CACHE_CAP, torch.bfloat16,
         [77, CACHE_CAP, 1, 300, 0, 128, 199, 450]),
        (8, 32, 16, 128, 1024, torch.bfloat16,
         [1024, 1024, 1, 300, 1023, 0, 700, 1024]),
        (8, 32, 16, 128, 4096, torch.bfloat16,
         [2143, 1087, 1, 300, 4096, 0, 700, 3001]),
        (2, 16, 2, 128, 4096, torch.bfloat16, [4093, 1500]),
        (2, 32, 8, 128, 16384, torch.bfloat16, [16384, 9001]),
        (3, 8, 2, 64, 200, torch.float32, [0, 13, 200]),
        (2, 4, 4, 128, 300, torch.float32, [300, 129]),
    ]
    for b, h, hkv, d, s, dtype, fills in attn_cases:
        q = torch.randn((b, h, d), generator=gen, device="cuda", dtype=dtype)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda",
                            dtype=dtype) for _ in range(2))
        valid = torch.tensor(fills, dtype=torch.int32, device="cuda")
        got = ops.decode_attn_auto(q, k, v, valid)
        want = ref.decode_attn_ref(q, k, v, valid)
        torch.cuda.synchronize()
        ab, rel = max_errs(got, want)
        geo = attn_geometry(b, h, hkv, s, d, dtype)
        emit("parity", kernel="decode_attn", shape=[b, h, hkv, d, s],
             dtype=str(dtype), max_abs_err=ab, max_rel_err=rel,
             tol=tol[dtype], valid_len=fills,
             geometry={k_: geo[k_] for k_ in ("split", "lpp", "tile",
                                              "buffers", "smem")})
        require(ab <= tol[dtype], "parity",
                f"decode_attn {[b, h, hkv, d, s]} {dtype}: max abs err {ab}")
        if dtype == torch.bfloat16:
            results["decode_attn"] = max(results["decode_attn"], ab)
    _grad_refusal(torch, gen)
    return results


def _grad_refusal(torch, gen):
    """Neither kernel has a backward: given a CUDA input that needs a grad
    (grad enabled), each wrapper raises before it launches, where it
    would otherwise return a result that silently carries no grad."""
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.moe_gmm import moe_gmm
    x, ws, gs = _moe_case(torch, gen, 2, 8, 64, 128, torch.bfloat16, [8, 3])
    q = torch.randn((2, 8, 128), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kv = torch.randn((2, 64, 2, 128), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    valid = torch.tensor([64, 17], dtype=torch.int32, device="cuda")
    calls = {"moe_gmm": lambda: moe_gmm(x.requires_grad_(True), *ws,
                                        group_sizes=gs),
             "decode_attn": lambda: decode_attn(q.requires_grad_(True), kv,
                                                kv, valid)}
    before = (moe_gmm.launches, decode_attn.launches)
    refused = {}
    for name, call in calls.items():
        try:
            call()
            refused[name] = None
        except RuntimeError as e:
            refused[name] = str(e)
    emit("parity", part="grad_refusal", refused=refused)
    require(all(m is not None and "no backward: train on the plain path" in m
                for m in refused.values())
            and (moe_gmm.launches, decode_attn.launches) == before,
            "parity", f"a kernel took an input that needs a grad: {refused}")


def _nan_parity(torch, gen, moe_gmm, ref, tol):
    """Expert 1's weights NaN with 5 live rows, expert 2's NaN with none:
    NaN must fill exactly expert 1's live rows (the kernel never reads a
    dead group's weights and writes zeros past a group's size), as in the
    plain version; the other rows agree within the tolerance."""
    e, c, d, f = 4, 8, 256, 512
    sizes = [3, 5, 0, 8]
    for dtype in (torch.bfloat16, torch.float32):
        x, ws, gs = _moe_case(torch, gen, e, c, d, f, dtype, sizes)
        for w in ws:
            w[1:3] = float("nan")
        got = moe_gmm(x, *ws, group_sizes=gs)
        want = ref.moe_ffn_ref(x, *ws, group_sizes=gs)
        torch.cuda.synchronize()
        expect = torch.zeros((e, c), dtype=torch.bool, device="cuda")
        expect[1, :sizes[1]] = True
        nan_rows = torch.isnan(got).any(-1)
        exact = (torch.equal(nan_rows, expect)
                 and bool(torch.isnan(got[1, :sizes[1]]).all())
                 and bool((got[1, sizes[1]:] == 0).all())
                 and bool((got[2] == 0).all())
                 and torch.equal(torch.isnan(want).any(-1), expect))
        ab, rel = max_errs(got[~expect], want[~expect])
        emit("parity", kernel="moe_gmm", case="nan_poisoned_experts",
             shape=[e, c, d, f], dtype=str(dtype), group_sizes=sizes,
             poisoned=[1, 2], nan_exactly_in_live_rows=exact,
             max_abs_err=ab, max_rel_err=rel, tol=tol[dtype])
        require(exact and ab <= tol[dtype], "parity",
                f"moe_gmm NaN case {dtype}: NaN rows exact {exact}, max "
                f"abs err {ab}")


def _stream(cfg, n, prompt_lo, prompt_hi, new_lo, new_hi, seed):
    import numpy as np
    from repro_torch.serving import poisson_requests
    rng = np.random.default_rng(seed)
    reqs = poisson_requests(rng, n, 0.5, cfg.vocab, prompt_hi, new_lo, new_hi)
    for r in reqs:
        r.prompt = r.prompt[: int(rng.integers(prompt_lo, prompt_hi + 1))]
    return reqs


def phase_reference():
    """Kernel path vs plain path on the card, reduced phi3.5-MoE in fp32,
    with one-shot and with chunked admission. One request carries a tight
    deadline of its own, so EDF reorders admission."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import (ContinuousEngine, EdfAdmission,
                                     EngineConfig, TenantSpec)
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    model = Model(cfg, device="cuda")
    params = model.init(0)
    configs = {
        "one_shot": {},
        "chunk8": {"prefill_chunk": 8},
        "chunk8_budget12_pool3": {"prefill_chunk": 8,
                                  "step_token_budget": 12,
                                  "prefill_pool": 3},
        "edf_chunk8_budget12_ttft": {
            "admission": EdfAdmission(chunk=8, budget=12),
            "tenants": (TenantSpec(name="smoke", ttft_p95=8.0),)},
    }
    streams = {}
    for name, kw in configs.items():
        for kernels in (True, False):
            eng = ContinuousEngine(model, params, batch_slots=3, cache_cap=64,
                                   config=EngineConfig(kernels=kernels, **kw))
            reqs = _stream(cfg, 6, 5, 20, 4, 12, seed=1)
            reqs[3].deadline = reqs[3].arrival + 1.0
            eng.serve(reqs)
            streams[name, kernels] = [list(r.out_tokens) for r in reqs]
    same = {name: streams[name, True] == streams[name, False]
            for name in configs}
    chunked = [name for name in configs if name != "one_shot"]
    as_serial = {name: streams[name, True] == streams["chunk8", True]
                 for name in chunked}
    emit("reference", arch=cfg.arch_id, requests=len(streams["chunk8", True]),
         configs=list(configs), kernel_equals_plain=same,
         chunked_equals_serialised=as_serial)
    require(all(same.values()), "reference",
            f"kernel-path greedy streams differ from the plain path's: {same}")
    require(all(as_serial.values()), "reference",
            f"chunked streams differ from the serialised ones: {as_serial}")
    _reference_colocated(cfg, model)
    _reference_ep(cfg)
    _reference_deepseek()
    _reference_dense()
    _reference_families()


def _widen(cfg, n_experts: int):
    """``cfg`` with ``n_experts`` experts at capacity factor 8.0 (no drops
    on either side, as in the reference's EP tests)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=n_experts, capacity_factor=8.0))


def _reference_ep(cfg):
    """``DistributedEngine`` over ``LocalGroup(4, cuda)`` on the reduced
    model widened to 8 experts (cf 8.0): "ep", "aurora" with round robin,
    "aurora" with rounds adopted from a trace mid-stream, and the
    round-pipelined overlap, each through the kernels and through the
    plain path; then a ``ChaosHarness`` loss of rank 3 that rebuilds the
    group over ranks 0 and 1 (``adopt_degraded``). Gates: kernel streams
    equal plain ones, and every stream equals the unsharded kernel
    stream."""
    from repro_torch.core import (AuroraPlanner, homogeneous_cluster,
                                  synthetic_trace)
    from repro_torch.distributed import LocalGroup
    from repro_torch.models import Model
    from repro_torch.serving import (ChaosHarness, ContinuousEngine,
                                     DeviceLoss, DistributedEngine,
                                     EngineConfig, FaultInjector, FaultPlan,
                                     HealthMonitor, serve_stream)
    cfg = _widen(cfg, 8)
    model = Model(cfg, device="cuda")
    params = model.init(0)
    trace = synthetic_trace("drift", n_experts=8, n_layers=2, seed=9)

    def reqs():
        return _stream(cfg, 6, 5, 20, 4, 12, seed=1)

    base = ContinuousEngine(model, params, batch_slots=3, cache_cap=64,
                            config=EngineConfig(kernels=True))
    want = [list(r.out_tokens) for r in base.serve(reqs())]
    streams = {}
    for name, impl, overlap in (("ep", "ep", False),
                                ("aurora_round_robin", "aurora", False),
                                ("aurora_adopted", "aurora", False),
                                ("overlap", "aurora", True)):
        for kernels in (True, False):
            eng = DistributedEngine(
                model, params, batch_slots=3, cache_cap=64,
                group=LocalGroup(4, "cuda"), moe_impl=impl, overlap=overlap,
                config=EngineConfig(kernels=kernels))
            rs = reqs()
            if name == "aurora_adopted":
                def step(eng=eng):
                    worked = eng.step()
                    if eng.decode_steps == 4 and eng.rounds is None:
                        eng.adopt(trace)
                    return worked
                serve_stream(step, [(eng, rs)])
                require(eng.rounds is not None, "reference",
                        "no rounds adopted mid-stream")
            else:
                eng.serve(rs)
            streams[name, kernels] = [list(r.out_tokens) for r in rs]
    inj = FaultInjector(FaultPlan((DeviceLoss(step=3, device=3),)),
                        n_devices=4, health=HealthMonitor(
                            n_devices=4, heartbeat_timeout=2))
    eng = DistributedEngine(model, params, batch_slots=3, cache_cap=64,
                            group=LocalGroup(4, "cuda"), overlap=True,
                            config=EngineConfig(kernels=True,
                                                step_wrapper=inj.wrap))
    harness = ChaosHarness(eng, inj,
                           planner=AuroraPlanner(homogeneous_cluster(8)),
                           trace=trace)
    streams["degraded", True] = [list(r.out_tokens)
                                 for r in harness.serve(reqs())]
    kernel_plain = {name: streams[name, True] == streams[name, False]
                    for name, k in streams if k and (name, False) in streams}
    unsharded = {name: streams[name, True] == want for name, k in streams
                 if k}
    emit("reference", engines="DistributedEngine over LocalGroup(4, cuda)",
         experts=8, capacity_factor=8.0, kernel_equals_plain=kernel_plain,
         equals_unsharded_kernel_stream=unsharded,
         degraded_ranks=eng.group.n,
         recoveries=[r["action"] for r in harness.recoveries])
    require(all(kernel_plain.values()), "reference",
            f"EP kernel streams differ from the plain ones: {kernel_plain}")
    require(all(unsharded.values()) and eng.group.n == 2, "reference",
            f"EP streams differ from the unsharded one: {unsharded}, "
            f"degraded group of {eng.group.n} ranks")


def _reference_deepseek():
    """Reduced DeepSeek-V3 (fp32; a dense layer D and an MoE layer E; MLA;
    4 experts top-2, sigmoid router, shared expert) served on the card
    through the kernels and through the plain path; then, at capacity
    factor 8.0 (nothing drops), unsharded and through
    ``DistributedEngine`` over ``LocalGroup(4, cuda)`` as "ep" and as
    "aurora" (one expert a rank). Gates: kernel stream = plain stream,
    EP streams = the unsharded one."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import LocalGroup
    from repro_torch.models import Model
    from repro_torch.serving import (ContinuousEngine, DistributedEngine,
                                     EngineConfig)
    cfg = get_config("deepseek-v3-671b").reduced()
    wide = _widen(cfg, 4)

    def served(c, make):
        model = Model(c, device="cuda")
        eng = make(model, model.init(0))
        reqs = _stream(c, 6, 5, 20, 4, 12, seed=1)
        eng.serve(reqs)
        return [list(r.out_tokens) for r in reqs]

    def one_card(kernels):
        return lambda model, params: ContinuousEngine(
            model, params, batch_slots=3, cache_cap=64,
            config=EngineConfig(kernels=kernels))

    def ranks(impl):
        return lambda model, params: DistributedEngine(
            model, params, batch_slots=3, cache_cap=64,
            group=LocalGroup(4, "cuda"), moe_impl=impl,
            config=EngineConfig(kernels=True))

    streams = {"cf1.25_kernels": served(cfg, one_card(True)),
               "cf1.25_plain": served(cfg, one_card(False)),
               "cf8_kernels": served(wide, one_card(True)),
               "cf8_ep": served(wide, ranks("ep")),
               "cf8_aurora": served(wide, ranks("aurora"))}
    same = streams["cf1.25_kernels"] == streams["cf1.25_plain"]
    ep = {impl: streams[f"cf8_{impl}"] == streams["cf8_kernels"]
          for impl in ("ep", "aurora")}
    emit("reference", arch=cfg.arch_id, layers="D + E", router="sigmoid",
         shared_expert=True, kernel_equals_plain=same,
         ep_equals_unsharded_cf8=ep)
    require(same, "reference", "reduced DeepSeek kernel stream differs from "
            "the plain stream")
    require(all(ep.values()), "reference", f"reduced DeepSeek EP streams "
            f"differ from the unsharded one: {ep}")


DENSE_ARCHS = ("phi4-mini-3.8b", "gemma-7b", "qwen3-32b", "gemma3-27b")


def _reference_dense():
    """The four reduced dense archs (fp32; gemma3 with its LG layers and a
    ring of 16) on the card. A stream of 6 requests (prompts of 5-16
    tokens, up to 24 new tokens, so gemma3's rings wrap) through
    ``ContinuousEngine`` on the kernels and on the plain path, one-shot
    and, for gemma3, with chunks of 4 (the ring bounds the chunked
    prompt); then 4 requests at t = 0 through the static
    ``ServingEngine`` and through ``ContinuousEngine`` with the same pad
    length. Gates: kernel streams equal plain ones, gemma3's chunked
    stream its one-shot stream, the static streams the continuous ones."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import (ContinuousEngine, EngineConfig,
                                     Request, ServingEngine)
    out = {}
    for arch in DENSE_ARCHS:
        cfg = get_config(arch).reduced()
        model = Model(cfg, device="cuda")
        params = model.init(0)
        runs = {"one_shot": {}}
        if cfg.layer_pattern:
            runs["chunk4"] = {"prefill_chunk": 4}
        streams = {}
        for name, kw in runs.items():
            for kernels in (True, False):
                eng = ContinuousEngine(
                    model, params, batch_slots=3, cache_cap=64,
                    config=EngineConfig(kernels=kernels, **kw))
                reqs = _stream(cfg, 6, 5, 16, 4, 24, seed=1)
                eng.serve(reqs)
                streams[name, kernels] = [list(r.out_tokens) for r in reqs]

        def t0():
            return [Request(prompt=[i + 1, i + 2, i + 3, i + 4],
                            max_new_tokens=n)
                    for i, n in enumerate((20, 3, 12, 6))]
        static = ServingEngine(model, params, batch_slots=4, cache_cap=64,
                               kernels=True).serve(t0())
        cont = ContinuousEngine(
            model, params, batch_slots=4, cache_cap=64,
            config=EngineConfig(kernels=True, prefill_len=4)).serve(t0())
        out[arch] = {
            "kernel_equals_plain": all(streams[n, True] == streams[n, False]
                                       for n in runs),
            "chunked_equals_one_shot": (streams["chunk4", True]
                                        == streams["one_shot", True]
                                        if "chunk4" in runs else None),
            "static_equals_continuous_t0": (
                [r.out_tokens for r in static] == [r.out_tokens
                                                   for r in cont])}
    emit("reference", archs=list(DENSE_ARCHS), dense=out)
    bad = {a: v for a, v in out.items() if False in v.values()}
    require(not bad, "reference", f"reduced dense streams differ: {bad}")


def _reference_families():
    """The four reduced families of this slice (fp32) on the card: mamba2,
    zamba2 and qwen2-vl through ``ContinuousEngine`` on the kernels and on
    the plain path (a stream of 6 requests, prompts of 5-16 tokens, up to
    24 new tokens), mamba2 also with chunks of 4; SeamlessM4T through
    ``ServingEngine`` with seeded frames (4 prompts, 12 frames each), on
    the kernels and on the plain path. Gates: kernel streams equal plain
    ones, mamba2's chunked stream its one-shot stream."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import (ContinuousEngine, EngineConfig,
                                     Request, ServingEngine)
    out = {}
    for arch in FAMILIES:
        cfg = get_config(arch).reduced()
        model = Model(cfg, device="cuda")
        params = model.init(0)
        streams = {}
        if cfg.is_encoder_decoder:
            frames = np.random.default_rng(3).standard_normal(
                (4, 12, cfg.frontend_dim), dtype=np.float32)
            for kernels in (True, False):
                reqs = [Request(prompt=[i + 1, i + 2, i + 3],
                                max_new_tokens=n)
                        for i, n in enumerate((20, 3, 12, 6))]
                ServingEngine(model, params, batch_slots=4, cache_cap=64,
                              kernels=kernels).serve(reqs, frames=frames)
                streams["static", kernels] = [r.out_tokens for r in reqs]
            runs = ("static",)
        else:
            runs = {"one_shot": {}}
            if cfg.family == "ssm":
                runs["chunk4"] = {"prefill_chunk": 4}
            for name, kw in runs.items():
                for kernels in (True, False):
                    eng = ContinuousEngine(
                        model, params, batch_slots=3, cache_cap=64,
                        config=EngineConfig(kernels=kernels, **kw))
                    reqs = _stream(cfg, 6, 5, 16, 4, 24, seed=1)
                    eng.serve(reqs)
                    streams[name, kernels] = [list(r.out_tokens)
                                              for r in reqs]
        out[arch] = {
            "kernel_equals_plain": all(streams[n, True] == streams[n, False]
                                       for n in runs),
            "chunked_equals_one_shot": (streams["chunk4", True]
                                        == streams["one_shot", True]
                                        if "chunk4" in runs else None)}
    emit("reference", archs=list(FAMILIES), families=out)
    bad = {a: v for a, v in out.items() if False in v.values()}
    require(not bad, "reference", f"reduced family streams differ: {bad}")


def _reference_colocated(cfg, model):
    """Two and three tenants of the reduced model (weights from seeds 0, 1,
    2) with chunked admission (chunks of 8), each run with and without a
    re-planner forced to adopt every changed placement
    (``OnlineReplanner(interval=3, threshold=-1.0, warmup=1)``), through
    the kernels and through the plain path. Gates: kernel streams equal
    plain ones, re-planned streams equal the run without, and each forced
    run applied at least one placement."""
    from repro_torch.core import AuroraPlanner, homogeneous_cluster
    from repro_torch.serving import (ColocatedContinuousEngine, EngineConfig,
                                     MultiTenantContinuousEngine,
                                     OnlineReplanner)
    planner = AuroraPlanner(homogeneous_cluster(cfg.moe.n_experts))
    streams, applied = {}, {}
    for tenants in (2, 3):
        for kernels in (True, False):
            for forced in (False, True):
                replan = (OnlineReplanner(planner, interval=3, threshold=-1.0,
                                          warmup=1) if forced else None)
                config = EngineConfig(kernels=kernels, prefill_chunk=8)
                params = [model.init(seed) for seed in range(tenants)]
                reqs = [_stream(cfg, 6, 5, 20, 4, 12, seed=1 + t)
                        for t in range(tenants)]
                if tenants == 2:
                    eng = ColocatedContinuousEngine(
                        model, model, *params, batch_slots=3, cache_cap=64,
                        config=config, replan=replan)
                    eng.serve(*reqs)
                else:
                    eng = MultiTenantContinuousEngine(
                        [model] * 3, params, batch_slots=3, cache_cap=64,
                        config=config, replan=replan)
                    eng.serve(reqs)
                key = (tenants, kernels, forced)
                streams[key] = [[list(r.out_tokens) for r in rs]
                                for rs in reqs]
                applied[key] = sum(e.applied for e in eng.replan_events)
    same = {f"{n}_tenants_{'replan' if f else 'static'}":
            streams[n, True, f] == streams[n, False, f]
            for n in (2, 3) for f in (False, True)}
    replanned = {f"{n}_tenants_{'kernels' if k else 'plain'}":
                 streams[n, k, True] == streams[n, k, False]
                 for n in (2, 3) for k in (True, False)}
    adopted = {f"{n}_tenants_{'kernels' if k else 'plain'}":
               applied[n, k, True] for n in (2, 3) for k in (True, False)}
    emit("reference", engines="colocated (2 tenants), multi-tenant (3)",
         prefill_chunk=8, kernel_equals_plain=same,
         replanned_equals_static=replanned, applied_events=adopted)
    require(all(same.values()), "reference",
            f"colocated kernel streams differ from the plain ones: {same}")
    require(all(replanned.values()), "reference",
            f"re-planned streams differ from the static ones: {replanned}")
    require(all(adopted.values()), "reference",
            f"a forced re-planner adopted nothing: {adopted}")


def _percentiles(xs, prefix: str) -> dict:
    import numpy as np
    a = np.asarray(xs, dtype=float)
    if not a.size:
        return {f"{prefix}_n": 0}
    return {f"{prefix}_n": int(a.size), f"{prefix}_mean": float(a.mean()),
            f"{prefix}_p50": float(np.percentile(a, 50)),
            f"{prefix}_p95": float(np.percentile(a, 95))}


def _serve_run(eng, pools):
    """Serve ``pools`` ((slot pool, requests) pairs: the engine itself for a
    ``ContinuousEngine``, one pool per tenant for the colocated engines)
    through ``serve_stream`` with ``eng.step``, each engine step timed on
    the host clock and synchronised. The kernels' launch counters are set
    to 0 just before the run and read just after. TTFT of a request: from
    the start of the tick it was submitted in to the end of the step that
    emitted its first token, in ms and in engine steps (that step
    included). Steps in which a re-planner made a decision are timed
    apart (``replan_step_ms``). Returns (launches, calls, numbers), where
    calls are the engine's decode steps (lockstep steps decode every
    tenant), its prefill calls (one-shot or chunk) and its tenants."""
    import torch
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.serving import serve_stream
    steps, submitted, first = [], {}, {}
    reqs = [r for _, rs in pools for r in rs]
    replan = getattr(eng, "replan", None)

    def state():
        return (sum(p.prefills for p, _ in pools), eng.decode_steps,
                sum(p.num_active for p, _ in pools),
                len(replan.events) if replan is not None else 0)

    def timed_step():
        t = time.perf_counter()
        for pool, _ in pools:
            for r in pool.queue:
                submitted.setdefault(id(r), (len(steps), t))
        before = state()
        worked = eng.step()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after = state()
        steps.append(((t1 - t) * 1e3, after[0] - before[0],
                      after[1] - before[1], before[2], after[3] > before[3]))
        for r in reqs:
            if r.out_tokens and id(r) not in first:
                first[id(r)] = (len(steps), t1)
        return worked

    pre0, dec0 = state()[:2]
    torch.cuda.reset_peak_memory_stats()
    moe_gmm.launches = decode_attn.launches = 0
    t0 = time.perf_counter()
    serve_stream(timed_step, pools)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"moe_gmm": moe_gmm.launches,
                "decode_attn": decode_attn.launches}
    calls = {"decode_steps": eng.decode_steps - dec0,
             "prefill_calls": state()[0] - pre0, "tenants": len(pools)}
    pure = [s for s in steps if s[1] == 0 and s[2] and s[3] > 0
            and not s[4]]
    with_prefill = [s for s in steps if s[1] > 0 and not s[4]]
    ttft_steps = [first[id(r)][0] - submitted[id(r)][0] for r in reqs]
    ttft_ms = [(first[id(r)][1] - submitted[id(r)][1]) * 1e3 for r in reqs]
    total = sum(len(r.out_tokens) for r in reqs)
    pure_ms = sum(s[0] for s in pure)
    out = {"requests": len(reqs), "tokens": total, "wall_s": wall,
           "tok_per_s": total / wall, **calls, "engine_steps": len(steps),
           "decode_tok_per_s": (sum(s[3] for s in pure) / (pure_ms / 1e3)
                                if pure else None),
           **_percentiles([s[0] for s in pure], "step_ms"),
           **_percentiles([s[0] for s in with_prefill], "prefill_step_ms"),
           **_percentiles([s[0] for s in steps if s[4]], "replan_step_ms"),
           "ttft_steps": ttft_steps, "ttft_ms": ttft_ms,
           **_percentiles(ttft_steps, "ttft_steps"),
           **_percentiles(ttft_ms, "ttft_ms"),
           "max_memory_allocated_GB": torch.cuda.max_memory_allocated() / 1e9}
    if len(pools) > 1:
        out["tenant_tok_per_s"] = [sum(len(r.out_tokens) for r in rs) / wall
                                   for _, rs in pools]
    return launches, calls, out


def _check_launches(phase, launches, calls, attn_layers=N_LAYERS,
                    moe_layers=N_LAYERS):
    """Exact counts: one ``decode_attn`` per GQA layer of every tenant's
    decode, one ``moe_gmm`` per MoE layer (per rank body under expert
    parallelism) of every decode and prefill call."""
    decodes = calls["decode_steps"] * calls["tenants"]
    want = {"decode_attn": decodes * attn_layers,
            "moe_gmm": (decodes + calls["prefill_calls"]) * moe_layers}
    require(launches == want, phase,
            f"launch counts {launches} != expected {want}")


def _finite_decode(phase, eng, params):
    """Logits of one more decode over the served cache (every row frozen,
    so the cache is left as it is): finite, of the padded-vocab width."""
    import torch
    frozen = torch.zeros(SLOTS, dtype=torch.bool, device=eng.device)
    logits, _ = eng.model.decode_step(params, eng.tokens, eng.cache, frozen)
    finite = bool(torch.isfinite(logits).all())
    require(finite and tuple(logits.shape) == (SLOTS, 1,
                                               eng.model.padded_vocab),
            phase, f"decode logits {tuple(logits.shape)} finite={finite}")
    return finite


def phase_serve():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import ContinuousEngine, EngineConfig

    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"),
                              n_layers=N_LAYERS)
    model = Model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(params))
    eng = ContinuousEngine(model, params, batch_slots=SLOTS,
                           cache_cap=CACHE_CAP,
                           config=EngineConfig(kernels=True))
    eng.serve(_stream(cfg, 1, 64, 64, 2, 2, seed=2))          # warm-up
    torch.cuda.synchronize()

    reqs = _stream(cfg, 10, 64, 200, 16, 64, seed=0)
    launches, calls, numbers = _serve_run(eng, [(eng, reqs)])
    complete = all(len(r.out_tokens) == r.max_new_tokens for r in reqs)
    require(complete, "serve", "a request did not get all its tokens")
    _check_launches("serve", launches, calls)
    finite = _finite_decode("serve", eng, params)
    prefill_ms = _prefill_ms(model.with_kernels(), params, eng.cache_cap)
    emit("serve", ok=True, arch=cfg.arch_id, n_layers=N_LAYERS,
         depth_cut="8 of 32 layers, every published width",
         dtype=cfg.dtype, weights_GB=weight_bytes / 1e9, init_s=init_s,
         slots=SLOTS, cache_cap=CACHE_CAP, admission="one-shot",
         **numbers, prefill_ms=prefill_ms, launches=launches,
         logits_finite=finite)
    streams = [list(r.out_tokens) for r in reqs]
    return model, params, eng, launches, numbers, streams


def phase_serve_chunked(model, params):
    """The serve phase's model and stream with chunks of 64 tokens: (a)
    serialised, (b) a pool of 4 under a budget of 136 tokens per step."""
    import torch
    from repro_torch.serving import ContinuousEngine, EngineConfig
    cfg = model.cfg
    runs = {"serialised": EngineConfig(kernels=True, prefill_chunk=64),
            "pool4_budget136": EngineConfig(kernels=True, prefill_chunk=64,
                                            prefill_pool=4,
                                            step_token_budget=136)}
    streams, total = {}, {"moe_gmm": 0, "decode_attn": 0}
    for name, config in runs.items():
        eng = ContinuousEngine(model, params, batch_slots=SLOTS,
                               cache_cap=CACHE_CAP, config=config)
        eng.serve(_stream(cfg, 1, 128, 128, 2, 2, seed=2))    # warm-up
        torch.cuda.synchronize()
        reqs = _stream(cfg, 10, 64, 200, 16, 64, seed=0)
        launches, calls, numbers = _serve_run(eng, [(eng, reqs)])
        phase = f"serve_chunked[{name}]"
        require(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
                phase, "a request did not get all its tokens")
        require(eng.num_pending == 0, phase,
                f"{eng.num_pending} prefills left in flight")
        _check_launches(phase, launches, calls)
        finite = _finite_decode(phase, eng, params)
        streams[name] = [list(r.out_tokens) for r in reqs]
        for k in total:
            total[k] += launches[k]
        emit("serve_chunked", ok=True, run=name, prefill_chunk=64,
             prefill_pool=config.prefill_pool,
             step_token_budget=config.step_token_budget, **numbers,
             chunk_ms=_chunk_ms(eng, params), launches=launches,
             logits_finite=finite)
    same = streams["serialised"] == streams["pool4_budget136"]
    emit("serve_chunked", identical=same)
    require(same, "serve_chunked",
            "pooled streams differ from the serialised ones")
    return total


def _instrument(eng, rec):
    """Wrap the re-planning engine ``eng`` so ``rec`` collects: the host ms
    of each planning decision (a ``maybe_replan``/``maybe_regroup`` call
    that recorded an event); of each ``TrafficMonitor.observe`` (numpy on
    the host); of each pool's ``_observe_decode_routing`` (the counts'
    copy to the host, which waits for the step's decodes, and the
    observe); and of each adoption (``_timed_adoption``: synchronised ms,
    memory before and after, the transient)."""
    rp = eng.replan
    pools = eng.pools if hasattr(eng, "pools") else [eng.pool_a, eng.pool_b]
    name = "maybe_regroup" if hasattr(eng, "pools") else "maybe_replan"

    def timed(fn, key, only_events=False):
        def wrapper(*a, **k):
            n = len(rp.events)
            t = time.perf_counter()
            out = fn(*a, **k)
            if not only_events or len(rp.events) > n:
                rec[key].append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    setattr(rp, name, timed(getattr(rp, name), "plan_ms", True))
    for pool in pools:
        pool.monitor.observe = timed(pool.monitor.observe, "observe_ms")
        pool._observe_decode_routing = timed(pool._observe_decode_routing,
                                             "observe_routing_ms")
    adopt = eng.adopt
    eng.adopt = lambda plan: _timed_adoption(rec, adopt, plan)


def _replan_numbers(rec, numbers):
    """Summary of an ``_instrument`` record; the run's peak memory takes in
    the peaks before each adoption's reset."""
    peaks = rec["peaks"] + [numbers["max_memory_allocated_GB"] * 1e9]
    numbers["max_memory_allocated_GB"] = max(peaks) / 1e9
    return {**_percentiles(rec["plan_ms"], "plan_host_ms"),
            **_percentiles(rec["observe_ms"], "observe_host_ms"),
            **_percentiles(rec["observe_routing_ms"],
                           "observe_decode_routing_ms"),
            **_percentiles([a["ms"] for a in rec["adopt"]], "adopt_ms"),
            "adoptions": rec["adopt"]}


def phase_serve_colocated(model, params, solo):
    """Colocation at full width: tenant A is the serve phase's model and
    params (seed 0), tenant B the same config from seed 1, C from seed 2;
    8 slots, cache 512 and the serve phase's kind of stream each (seeds 0,
    1, 2). B's pairing comes from ``plan_colocated`` on synthetic traces,
    as in the launcher, re-seated into its params in place.

    (a) ``ColocatedContinuousEngine``, one-shot admission, no re-plan;
    (b) the same with a re-planner forced to adopt every changed pairing
    (interval 16, threshold -1, warmup 1): streams equal (a), at least one
    adoption, the final pairing that of the last applied event, and each
    adoption's transient memory within one (E, d, F) expert slab;
    (c) ``MultiTenantContinuousEngine`` over A, B, C with chunks of 64,
    from the identity placement, without and then with a forced
    re-group: streams equal, at least one adoption, tenant 0 still the
    anchor. Launch counts are exact in every
    run. Returns the launches of the four runs and the 2-tenant engines,
    for the profile."""
    import torch
    from repro_torch.core import (AuroraPlanner, homogeneous_cluster,
                                  synthetic_trace)
    from repro_torch.serving import (ColocatedContinuousEngine, EngineConfig,
                                     MultiTenantContinuousEngine,
                                     OnlineReplanner, reseat_pairing)
    cfg = model.cfg
    n = cfg.moe.n_experts
    slab = n * cfg.d_model * cfg.moe.d_ff * params["embed"].element_size()
    params_b = model.init(1)
    planner = AuroraPlanner(homogeneous_cluster(n))
    plan = planner.plan_colocated(
        synthetic_trace("a", n_experts=n, n_layers=2, seed=0),
        synthetic_trace("b", n_experts=n, n_layers=2, seed=1))
    reseat_pairing(params_b, list(range(n)), plan.pair, cfg)
    total = {"moe_gmm": 0, "decode_attn": 0}
    streams, engines = {}, {}
    solo_ms = {k: solo[k] for k in ("step_ms_mean", "step_ms_p50",
                                    "step_ms_p95")}

    def run(name, eng, pools, chunk=None):
        launches, calls, numbers = _serve_run(eng, pools)
        phase = f"serve_colocated[{name}]"
        require(all(len(r.out_tokens) == r.max_new_tokens
                    for _, rs in pools for r in rs), phase,
                "a request did not get all its tokens")
        _check_launches(phase, launches, calls)
        for pool, _ in pools:
            _finite_decode(phase, pool, pool.params)
        for k in total:
            total[k] += launches[k]
        streams[name] = [[list(r.out_tokens) for r in rs] for _, rs in pools]
        return launches, numbers

    def two_tenant_reqs():
        return [(_stream(cfg, 10, 64, 200, 16, 64, seed=s)) for s in (0, 1)]

    for name in ("a_static", "b_replan"):
        replan = (OnlineReplanner(planner, interval=16, threshold=-1.0,
                                  warmup=1) if name == "b_replan" else None)
        eng = ColocatedContinuousEngine(
            model, model, params, params_b, batch_slots=SLOTS,
            cache_cap=CACHE_CAP, config=EngineConfig(kernels=True),
            pair=plan.pair, replan=replan)
        if replan is None:                                    # warm-up
            eng.serve(_stream(cfg, 1, 64, 64, 2, 2, seed=2),
                      _stream(cfg, 1, 64, 64, 2, 2, seed=3))
        rec = {k: [] for k in ("plan_ms", "observe_ms", "observe_routing_ms",
                               "adopt", "peaks")}
        if replan is not None:
            _instrument(eng, rec)
        reqs = two_tenant_reqs()
        launches, numbers = run(name, eng, [(eng.pool_a, reqs[0]),
                                            (eng.pool_b, reqs[1])])
        extra = {}
        if replan is not None:
            events = eng.replan_events
            applied = [e for e in events if e.applied]
            extra = {**_replan_numbers(rec, numbers),
                     "events": len(events), "applied": len(applied),
                     "final_pair": eng.pair, "initial_pair": plan.pair}
            require(applied and eng.pair == applied[-1].pair, name,
                    f"{len(applied)} pairings applied, final pair "
                    f"{eng.pair}")
            worst = max(a["transient_bytes"] for a in rec["adopt"])
            require(worst <= slab + 2 ** 20, name,
                    f"an adoption took {worst} bytes beyond the weights; "
                    f"one expert slab is {slab}")
        emit("serve_colocated", ok=True, run=name, admission="one-shot",
             pair=plan.pair, **numbers, solo_step_ms=solo_ms,
             launches=launches, **extra)
        engines[name] = eng
    same = streams["a_static"] == streams["b_replan"]
    emit("serve_colocated", tenants=2, replanned_equals_static=same)
    require(same, "serve_colocated",
            "re-planned streams differ from the static run's")

    # (c): three tenants from the identity placement (B's params are
    # re-seated back from the pairing (b) left in them).
    reseat_pairing(params_b, engines["b_replan"].pair, list(range(n)), cfg)
    params_c = model.init(2)
    for name in ("c_static", "c_regroup"):
        replan = (OnlineReplanner(planner, interval=16, threshold=-1.0,
                                  warmup=1) if name == "c_regroup" else None)
        eng = MultiTenantContinuousEngine(
            [model] * 3, [params, params_b, params_c], batch_slots=SLOTS,
            cache_cap=CACHE_CAP,
            config=EngineConfig(kernels=True, prefill_chunk=64),
            replan=replan)
        rec = {k: [] for k in ("plan_ms", "observe_ms", "observe_routing_ms",
                               "adopt", "peaks")}
        if replan is not None:
            _instrument(eng, rec)
        reqs = [_stream(cfg, 10, 64, 200, 16, 64, seed=s) for s in (0, 1, 2)]
        launches, numbers = run(name, eng, list(zip(eng.pools, reqs)))
        extra = {}
        if replan is not None:
            applied = [e for e in eng.replan_events if e.applied]
            anchored = all(g[0] == i for i, g in enumerate(eng.groups))
            extra = {**_replan_numbers(rec, numbers),
                     "events": len(eng.replan_events),
                     "applied": len(applied), "anchor_kept": anchored}
            require(applied and anchored, name,
                    f"{len(applied)} groupings applied, tenant 0 anchored: "
                    f"{anchored}")
            worst = max(a["transient_bytes"] for a in rec["adopt"])
            require(worst <= slab + 2 ** 20, name,
                    f"an adoption took {worst} bytes beyond the weights; "
                    f"one expert slab is {slab}")
        emit("serve_colocated", ok=True, run=name, prefill_chunk=64,
             **numbers, solo_step_ms=solo_ms, launches=launches, **extra)
        del eng
    same = streams["c_static"] == streams["c_regroup"]
    emit("serve_colocated", tenants=3, regrouped_equals_static=same)
    require(same, "serve_colocated",
            "re-grouped streams differ from the static run's")
    del params_c
    return total, engines


def _chunk_ms(eng, params):
    """Host ms of one 64-token chunk call (synchronised) into slot 0 of the
    engine's cache after its run: the first chunk of a prompt and a
    continuation at offset 192 (the last chunk of a 256-token prompt);
    best of three each. Launch counters are left as they were."""
    import torch
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.moe_gmm import moe_gmm
    counts = (moe_gmm.launches, decode_attn.launches)
    toks = torch.randint(1, eng.model.cfg.vocab, (1, 64), device=eng.device)
    out = {}
    for name, first, fill in (("first", True, 0),
                              ("continuation_at_192", False, 192)):
        best = math.inf
        for _ in range(3):
            eng.cache["len"][0] = fill
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.model.prefill_chunk_slot(params, {"tokens": toks}, eng.cache,
                                         0, first=first, cap=CACHE_CAP)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        out[name] = best * 1e3
    eng.cache["len"][0] = 0
    moe_gmm.launches, decode_attn.launches = counts
    return out


def _prefill_ms(model, params, cap):
    """Host ms of one batch-1 prefill (synchronised) at each pow2 bucket the
    stream's 64-200-token prompts fall into; best of three."""
    import torch
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.moe_gmm import moe_gmm
    counts = (moe_gmm.launches, decode_attn.launches)
    out = {}
    for p in (64, 128, 256):
        toks = torch.randint(1, model.cfg.vocab, (1, p), device="cuda")
        best = math.inf
        for _ in range(3):
            cache = model.init_cache(1, cap)
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.prefill(params, {"tokens": toks}, cache)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        out[str(p)] = best * 1e3
    moe_gmm.launches, decode_attn.launches = counts
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _moe_timing(model, params, n_tokens, gen, flush, spec=None):
    """``moe_gmm`` on layer 0's experts over the buckets of ``n_tokens``
    random tokens routed by layer 0's router: C = ``capacity(n_tokens)``
    (8 at the decode step's 8 slots; 16, 24, 48 at a batch-1 prefill of 64,
    128, 256 tokens). With a replication ``spec`` the experts are widened to
    its ``n_phys`` physical copies and the buckets follow the shard-of-token
    rule. Bound: the live (physical) experts' weights, x and y once each,
    and the group sizes."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_gmm import align_capacity, moe_gmm
    from repro_torch.models import moe as tm
    cfg = model.cfg
    layer0 = params["segments"][0][0]["moe"]
    ex = {k: v[0] for k, v in layer0["experts"].items()}
    d, e, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff
    if spec is not None:
        p2l = torch.tensor(spec.phys_to_logical, device="cuda")
        ex = {k: v.index_select(0, p2l) for k, v in ex.items()}
    dtype = ex["w_gate"].dtype
    xt = torch.randn((n_tokens, d), generator=gen, device="cuda", dtype=dtype)
    _, idx, _ = tm.route(layer0["router"][0], xt, cfg.moe)
    cap = tm.capacity(n_tokens, cfg.moe.top_k, e, cfg.moe.capacity_factor)
    cap = align_capacity(cap, model.with_kernels().kernels.block_c)
    _, sizes, slot, keep = tm.sort_dispatch(idx, e, cap)
    gs = tm.physical_group_sizes(spec, torch.clamp(sizes, max=cap))
    n_phys = spec.n_phys if spec is not None else e
    buf = torch.zeros((n_phys, cap, d), dtype=dtype, device="cuda")
    kept = keep.reshape(-1)
    pe, ps = tm.physical_slots(spec, idx.reshape(-1).long(),
                               slot.reshape(-1).long())
    buf[pe[kept], ps[kept]] = xt[
        torch.arange(n_tokens, device="cuda").repeat_interleave(
            cfg.moe.top_k)[kept]]
    live_rows = int(gs.sum())
    live_experts = int((gs > 0).sum())
    args = (buf, ex["w_gate"], ex["w_up"], ex["w_down"])
    ms = time_ms(lambda: moe_gmm(*args, group_sizes=gs), flush)
    plain = time_ms(lambda: ref.moe_ffn_ref(*args, group_sizes=gs), flush, 5)
    nbytes = ((live_experts * 3 * d * f + 2 * buf.numel())
              * buf.element_size() + n_phys * 4)
    b_ms, b_by = bound(nbytes, 2 * 3 * d * f * live_rows)
    return {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "tokens": n_tokens,
            "shape": [n_phys, cap, d, f], "live_experts": live_experts,
            "group_sizes": gs.tolist(), "bytes": nbytes,
            "bound_share": b_ms / ms}


def _attn_timing(q, k, v, valid, flush):
    """``decode_attn`` on q (B, H, D) over k/v (B, S, Hkv, D) at fill
    levels ``valid`` (B,): its ms beside the plain version's and SDPA's
    (GQA, a boolean fill-level mask), and its bound (the live K and V, q
    and the output once each, the fill levels)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attn import decode_attn
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    ms = time_ms(lambda: decode_attn(q, k, v, valid), flush)
    plain = time_ms(lambda: ref.decode_attn_ref(q, k, v, valid), flush)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)             # (B, Hkv, S, D)
    mask = (torch.arange(s, device="cuda")[None, :]
            < valid[:, None])[:, None, None, :]
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True), flush)
    n_valid = int(valid.sum())
    nbytes = ((2 * n_valid * hkv * d + 2 * q.numel()) * q.element_size()
              + b * 4)
    b_ms, b_by = bound(nbytes, 4 * h * d * n_valid)
    return {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "shape": [b, h, hkv, d, s],
            "valid_len": valid.tolist(), "bytes": nbytes,
            "bound_share": b_ms / ms}


def phase_timing(model, params, eng, launches, errs):
    """Each kernel at the serve phase's decode shapes, on layer 0's tensors;
    then ``moe_gmm`` at the batch-1 prefill buckets, on timing lines of
    their own (the ``kernels`` line keeps the decode shapes)."""
    import torch
    cfg = model.cfg
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []

    # moe_gmm: the decode step's buckets, then the prefill buckets.
    rows.append({"name": "moe_gmm", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
                 "replaces": "src/repro/kernels/moe_gmm.py:112",
                 "launches": launches["moe_gmm"],
                 "max_abs_err": errs["moe_gmm"],
                 **_moe_timing(model, params, SLOTS, gen, flush)})

    # decode_attn: layer 0's served cache, at each slot's fill level.
    k = eng.cache["segments"][0][0]["k"][0]
    v = eng.cache["segments"][0][0]["v"][0]
    q = torch.randn((SLOTS, cfg.n_heads, cfg.head_dim), generator=gen,
                    device="cuda", dtype=k.dtype)
    valid = torch.clamp(eng.cache["len"] + 1, max=CACHE_CAP).to(torch.int32)
    rows.append({"name": "decode_attn", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
                 "replaces": "src/repro/kernels/decode_attn.py:91",
                 "launches": launches["decode_attn"],
                 "max_abs_err": errs["decode_attn"],
                 **_attn_timing(q, k, v, valid, flush)})
    for r in rows:
        emit("timing", **r)
    for n_tokens in (64, 128, 256):
        emit("timing", name="moe_gmm", step="prefill",
             **_moe_timing(model, params, n_tokens, gen, flush))
    return rows


def _profile(path: str, step, steps: int) -> None:
    """``step`` run ``steps`` times, timed once plain and once under
    ``torch.profiler``; the idle share is one minus the device kernels'
    busy time over the plain step time (the profiler slows the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    run()                                                   # warm-up
    plain_ms = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = run()
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps,
                e.count / steps)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(k[1] for k in kernels)
    kernels.sort(key=lambda k: -k[1])
    emit("profile", path=path, steps=steps, step_ms=plain_ms,
         step_ms_profiled=profiled_ms,
         device_busy_ms_per_step=busy if kernels else None,
         device_idle_share=(1 - busy / plain_ms) if kernels else None,
         device_kernels_per_step=sum(k[2] for k in kernels),
         top=[{"name": n[:70], "ms_per_step": t, "calls_per_step": c}
              for n, t, c in kernels[:12]])


def phase_profile(eng, steps: int = 10):
    """Decode steps as the engine runs them (every row frozen, so the served
    cache is left as it is): step, argmax, copy of the tokens to the host.
    Then the first 64-token chunk of a prompt into slot 0, with the argmax
    of its last position copied to the host, as admission does."""
    import torch
    mask = torch.zeros(SLOTS, dtype=torch.bool, device=eng.device)
    vocab = eng.model.cfg.vocab

    def decode():
        logits, _ = eng.model.decode_step(eng.params, eng.tokens, eng.cache,
                                          mask)
        torch.argmax(logits[:, :, :vocab], dim=-1).cpu()

    toks = torch.randint(1, vocab, (1, 64), device=eng.device)

    def chunk():
        logits, _ = eng.model.prefill_chunk_slot(
            eng.params, {"tokens": toks}, eng.cache, 0, first=True,
            cap=CACHE_CAP)
        int(torch.argmax(logits[0, -1, :vocab]))

    _profile("decode_step", decode, steps)
    _profile("chunk64_first", chunk, steps)


def phase_profile_lockstep(engines, steps: int = 10, repeats: int = 6):
    """A 2-tenant lockstep decode step as ``ColocatedContinuousEngine`` runs
    it (every row frozen): both tenants' decodes, then both argmax copies
    to the host. Then the re-planning engine's step, which also returns
    the routing counts and folds them into its monitors
    (``_observe_decode_routing``: the host copy, then ``observe``) before
    the argmaxes. Then the cost of the counts alone: ``repeats`` rounds of
    ``steps`` steps each way, alternating which way goes first; the host
    ms per step of each round and the medians are printed."""
    import numpy as np
    import torch
    fns = {}
    for path, eng in (("lockstep2_decode", engines["a_static"]),
                      ("lockstep2_decode_stats", engines["b_replan"])):
        pools = [eng.pool_a, eng.pool_b]
        masks = [torch.zeros(SLOTS, dtype=torch.bool, device=p.device)
                 for p in pools]
        frozen = np.zeros(SLOTS, bool)

        def step(eng=eng, pools=pools, masks=masks, frozen=frozen):
            out = eng._step([p.params for p in pools],
                            [p.tokens for p in pools],
                            [p.cache for p in pools], masks)
            for stats in out[2:]:
                for p, s in zip(pools, stats):
                    p._observe_decode_routing(s, frozen)
            for p, logits in zip(pools, out[0]):
                torch.argmax(logits[:, :, :p.model.cfg.vocab], dim=-1).cpu()

        _profile(path, step, steps)
        fns[path] = step
    ms = {path: [] for path in fns}
    for r in range(repeats):
        for path in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(steps):
                fns[path]()
            torch.cuda.synchronize()
            ms[path].append((time.perf_counter() - t) * 1e3 / steps)
    emit("profile", path="lockstep2_counts_alternated", steps=steps,
         repeats=repeats, step_ms=ms,
         median_ms={k: float(np.median(v)) for k, v in ms.items()})


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _timed_adoption(rec, fn, *args, widens: bool = False):
    """``fn(*args)`` synchronised: its ms, the memory allocated before and
    after it, and its transient. An in-place re-seat (the default) must
    end where it began, so its transient is the peak beyond the memory
    before it: a second copy of the weights, whether freed or kept, shows
    in full. An adoption that ``widens`` the weights (a replication) may
    end larger, so its transient is the peak beyond the larger of the
    two layouts. The peak counter is reset for it, so the peak before it
    is kept in ``rec["peaks"]``."""
    import torch
    torch.cuda.synchronize()
    rec["peaks"].append(torch.cuda.max_memory_allocated())
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    rec["adopt"].append({
        "ms": (time.perf_counter() - t) * 1e3, "before_GB": before / 1e9,
        "after_GB": after / 1e9, "peak_GB": peak / 1e9,
        "transient_bytes": peak - (max(before, after) if widens
                                   else before)})
    return out


class _Stepper:
    """What ``_serve_run`` drives: ``step`` (here another loop's, such as
    ``ChaosHarness.step``), the engine's ``decode_steps``, and the
    re-planner whose decisions are timed apart (None: none)."""

    def __init__(self, eng, step, replan=None):
        self.eng, self.step, self.replan = eng, step, replan

    @property
    def decode_steps(self):
        return self.eng.decode_steps


def _replicating_step(eng, replan, rec, drop_after: int, **plan_kw):
    """``eng.step`` followed, after each decode step, by a forced
    ``maybe_replicate`` on the engine's monitor until a replication is
    adopted, and by ``adopt_replication(None)`` ``drop_after`` decode
    steps later; both adoptions timed into ``rec``."""
    state = {"adopted_at": None, "dropped_at": None, "spec": None}

    def step():
        before = eng.decode_steps
        worked = eng.step()
        now = eng.decode_steps
        if now == before:
            return worked
        if state["adopted_at"] is None:
            plan = replan.maybe_replicate(now, eng.monitor, None, **plan_kw)
            if plan is not None:
                _timed_adoption(rec, eng.adopt, plan, widens=True)
                state["adopted_at"], state["spec"] = now, eng.model.replication
        elif state["dropped_at"] is None and \
                now >= state["adopted_at"] + drop_after:
            _timed_adoption(rec, eng.adopt_replication, None, widens=True)
            state["dropped_at"] = now
        return worked
    return step, state


def _decode_rounds(fns, steps: int = 10, repeats: int = 6):
    """Host ms per decode step (synchronised) of each of ``fns``, timed in
    ``repeats`` rounds of ``steps`` steps, alternating which goes first;
    returns each round's ms and the medians."""
    import numpy as np
    import torch
    ms = {k: [] for k in fns}
    for fn in fns.values():
        fn()                                                # warm-up
    for r in range(repeats):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(steps):
                fns[k]()
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t) * 1e3 / steps)
    return ms, {k: float(np.median(v)) for k, v in ms.items()}


def _frozen_decode(eng, wrapped: bool = False):
    """One decode step over the engine's cache with every row frozen (the
    cache is left as it is), then the argmax copy to the host; through the
    engine's wrapped step callable (its spans, with a hub) if ``wrapped``,
    else the model's."""
    import torch
    mask = torch.zeros(SLOTS, dtype=torch.bool, device=eng.device)
    vocab = eng.model.cfg.vocab
    fn = eng._decode if wrapped else eng.model.decode_step

    def decode():
        logits = fn(eng.params, eng.tokens, eng.cache, mask)[0]
        torch.argmax(logits[:, :, :vocab], dim=-1).cpu()
    return decode


def phase_serve_replicated(model, params, want, solo):
    """The serve phase's model and stream through monitored engines. An
    unreplicated run gives the routing counts; ``plan_replicated`` (the
    card's 16 expert slots as the planner's 16 devices, padded to
    ``PHYS_SLOTS`` physical experts with its best copies, none beyond)
    turns them into a replication, which is (a)
    adopted before the stream and (b) adopted mid-stream by a forced
    ``OnlineReplanner.maybe_replicate`` (interval 16), then dropped 24
    decode steps later. Gates: every stream equals the serve phase's,
    exact launch counts, finite logits, each adoption's transient within
    one widened (n_phys, d, F) slab. Returns the launches, the
    replication and the unreplicated run's monitor."""
    import torch
    from repro_torch.core import AuroraPlanner, homogeneous_cluster
    from repro_torch.models.moe import ReplicationSpec
    from repro_torch.serving import (ContinuousEngine, EngineConfig,
                                     OnlineReplanner, TrafficMonitor)
    cfg = model.cfg
    n = cfg.moe.n_experts
    planner = AuroraPlanner(homogeneous_cluster(n))
    plan_kw = {"tolerance": 0.0, "max_total_replicas": 0,
               "total_multiple": PHYS_SLOTS}
    total = {"moe_gmm": 0, "decode_attn": 0}
    solo_ms = {k: solo[k] for k in ("step_ms_mean", "step_ms_p50",
                                    "step_ms_p95")}

    def engine():
        return ContinuousEngine(
            model, params, batch_slots=SLOTS, cache_cap=CACHE_CAP,
            config=EngineConfig(kernels=True),
            monitor=TrafficMonitor(n, model.n_moe_layers))

    def run(name, eng, stepper=None):
        reqs = _stream(cfg, 10, 64, 200, 16, 64, seed=0)
        launches, calls, numbers = _serve_run(stepper or eng, [(eng, reqs)])
        phase = f"serve_replicated[{name}]"
        require(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
                phase, "a request did not get all its tokens")
        _check_launches(phase, launches, calls)
        _finite_decode(phase, eng, eng.params)
        same = [list(r.out_tokens) for r in reqs] == want
        require(same, phase, "streams differ from the serve phase's "
                "unreplicated stream")
        for k in total:
            total[k] += launches[k]
        return launches, numbers

    def slab(spec):
        return (spec.n_phys * cfg.d_model * cfg.moe.d_ff
                * params["embed"].element_size())

    def check_adoptions(phase, rec, specs):
        worst = max(a["transient_bytes"] for a in rec["adopt"])
        limit = max(slab(s) for s in specs) + 2 ** 20
        require(worst <= limit, phase, f"an adoption took {worst} bytes "
                f"beyond the two layouts; one widened slab is {limit}")

    base = engine()
    launches, numbers = run("unreplicated", base)
    emit("serve_replicated", ok=True, run="unreplicated", **numbers,
         solo_step_ms=solo_ms, launches=launches, identical=True)
    t = time.perf_counter()
    plan = planner.plan_replicated(base.monitor.trace(), **plan_kw)
    plan_ms = (time.perf_counter() - t) * 1e3
    spec = ReplicationSpec.from_counts([len(h) for h in plan.replication])
    require(spec is not None and spec.n_phys == PHYS_SLOTS,
            "serve_replicated", f"plan_replicated gave {plan.replication}")

    eng = engine()
    rec = {"adopt": [], "peaks": []}
    weights_before = _nbytes(eng.params)
    _timed_adoption(rec, eng.adopt, plan, widens=True)
    weights_after = _nbytes(eng.params)
    require(eng.model.replication == spec, "serve_replicated[a]",
            f"adopted {eng.model.replication}, planned {spec}")
    check_adoptions("serve_replicated[a]", rec, [spec])
    launches, numbers = run("a_adopted_before", eng)
    numbers["max_memory_allocated_GB"] = max(
        rec["peaks"] + [numbers["max_memory_allocated_GB"] * 1e9]) / 1e9
    rounds, medians = _decode_rounds({"unreplicated": _frozen_decode(base),
                                      "replicated": _frozen_decode(eng)})
    emit("serve_replicated", ok=True, run="a_adopted_before",
         counts=list(spec.counts), n_phys=spec.n_phys, plan_host_ms=plan_ms,
         engine_weights_GB_before=weights_before / 1e9,
         engine_weights_GB_after=weights_after / 1e9, adoptions=rec["adopt"],
         **numbers, solo_step_ms=solo_ms, launches=launches, identical=True,
         decode_step_ms_rounds=rounds, decode_step_ms_median=medians)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    emit("timing", name="moe_gmm", step="decode_replicated",
         counts=list(spec.counts),
         **_moe_timing(model, params, SLOTS, gen, flush, spec))
    monitor = base.monitor
    del eng, base, flush
    torch.cuda.empty_cache()

    eng = engine()
    rec = {"adopt": [], "peaks": []}
    replan = OnlineReplanner(planner, interval=16, threshold=-1.0, warmup=1)
    step, state = _replicating_step(eng, replan, rec, 24, **plan_kw)
    launches, numbers = run("b_mid_stream", eng, _Stepper(eng, step, replan))
    require(state["adopted_at"] is not None and state["dropped_at"]
            is not None and eng.model.replication is None,
            "serve_replicated[b]", f"adoption state {state}")
    check_adoptions("serve_replicated[b]", rec, [state["spec"]])
    numbers["max_memory_allocated_GB"] = max(
        rec["peaks"] + [numbers["max_memory_allocated_GB"] * 1e9]) / 1e9
    emit("serve_replicated", ok=True, run="b_mid_stream",
         adopted_at=state["adopted_at"], dropped_at=state["dropped_at"],
         counts=list(state["spec"].counts), n_phys=state["spec"].n_phys,
         events=len(replan.events), adoptions=rec["adopt"], **numbers,
         launches=launches, identical=True)
    del eng
    torch.cuda.empty_cache()
    return total, spec, monitor


def phase_chaos(model, params, want, spec, monitor):
    """A ``ChaosHarness`` over an engine serving the serve stream with
    ``spec``'s replicas live, 4 virtual devices (slot % 4), a hub counting
    the step callables. The plan: a straggler (device 1, x4 for 40 steps),
    the home copy of the most routed replicated expert corrupted at step 10
    (repaired from its replica), the most routed single-copy expert at step
    30 (restored from the pristine host copy), device 3 lost at step 50
    (requeue, then ``plan_degraded`` on the unreplicated run's trace
    adopted). The planner sees the card's 16 expert slots as 16 devices;
    virtual device d stands for those of slot % 4 == d, so the loss of
    device 3 fails 4 of them. Gates: streams equal the serve phase's,
    every action seen, the degraded plan's survivors exactly the other
    12, exact launch counts."""
    import collections
    import torch
    from repro_torch.core import AuroraPlanner, homogeneous_cluster
    from repro_torch.serving import (ChaosHarness, ContinuousEngine,
                                     DeviceLoss, EngineConfig,
                                     ExpertCorruption, FaultInjector,
                                     FaultPlan, HealthMonitor, Straggler,
                                     Telemetry)
    cfg = model.cfg
    n = cfg.moe.n_experts
    rates = monitor.rates.sum(axis=0)
    hot = max((e for e in range(n) if spec.counts[e] > 1),
              key=lambda e: rates[e])
    single = max((e for e in range(n) if spec.counts[e] == 1),
                 key=lambda e: rates[e])
    plan = FaultPlan((Straggler(step=4, device=1, factor=4.0, duration=40),
                      ExpertCorruption(step=10, expert=hot),
                      ExpertCorruption(step=30, expert=single),
                      DeviceLoss(step=50, device=3)))
    hub = Telemetry(block_steps=False)
    inj = FaultInjector(plan, n_devices=4, health=HealthMonitor(
        n_devices=4, heartbeat_timeout=2, telemetry=hub))
    eng = ContinuousEngine(
        model, params, batch_slots=SLOTS, cache_cap=CACHE_CAP,
        config=EngineConfig(kernels=True, step_wrapper=inj.wrap,
                            telemetry=hub))
    eng.adopt_replication(spec.counts)
    torch.cuda.synchronize()
    t = time.perf_counter()
    harness = ChaosHarness(
        eng, inj, planner=AuroraPlanner(homogeneous_cluster(n)),
        trace=monitor.trace(),
        hosts_of_device=lambda d: [e for e in range(n) if e % 4 == d])
    pristine_s = time.perf_counter() - t
    rec = {"checkpoint_ms": [], "recover_nan_ms": [], "adopt": [],
           "peaks": []}

    def timed(fn, key):
        def wrapper(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            rec[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper
    eng.checkpoint = timed(eng.checkpoint, "checkpoint_ms")
    harness._recover_nan = timed(harness._recover_nan, "recover_nan_ms")
    adopt = eng.adopt
    eng.adopt = lambda plan_: _timed_adoption(rec, adopt, plan_, widens=True)
    reqs = _stream(cfg, 10, 64, 200, 16, 64, seed=0)
    launches, calls, numbers = _serve_run(_Stepper(eng, harness.step),
                                          [(eng, reqs)])
    phase = "chaos"
    require(all(len(r.out_tokens) == r.max_new_tokens for r in reqs), phase,
            "a request did not get all its tokens")
    same = [list(r.out_tokens) for r in reqs] == want
    require(same, phase, "streams differ from the never-faulted run's")
    actions = collections.Counter(r["action"] for r in harness.recoveries)
    expected = {"repaired-from-replica", "restored-pristine",
                "requeued+replanned", "observed"}
    require(expected <= set(actions), phase,
            f"recovery actions {dict(actions)}, expected {sorted(expected)}")
    lost = {e for e in range(n) if e % 4 == 3}
    survivors = [list(r["survivors"]) for r in harness.recoveries
                 if r["action"] == "requeued+replanned"]
    require(survivors == [sorted(set(range(n)) - lost)], phase,
            f"degraded plans' survivors {survivors}, device 3 held {lost}")
    spans = collections.Counter(s.name for s in hub.spans)
    want_l = {"decode_attn": spans["decode_step"] * N_LAYERS,
              "moe_gmm": (spans["decode_step"] + spans["prefill"])
              * N_LAYERS}
    require(launches == want_l, phase,
            f"launch counts {launches} != expected {want_l} (spans)")
    recoveries = [{"action": r["action"], "kind": r["event"].kind,
                   "step": r["event"].step, "device": r["event"].device,
                   **{k: r[k] for k in ("bad_phys", "requeued", "survivors")
                      if k in r}} for r in harness.recoveries]
    emit("chaos", ok=True, faults=[repr(f) for f in plan.faults],
         replication=list(spec.counts), hot_expert=hot,
         single_expert=single, recoveries=recoveries,
         actions=dict(actions), final_replication=(
             list(eng.model.replication.counts)
             if eng.model.replication is not None else None),
         pristine_bytes=harness.pristine_bytes, pristine_s=pristine_s,
         **_percentiles(rec["checkpoint_ms"], "checkpoint_ms"),
         restore_repair_rerun_ms=rec["recover_nan_ms"],
         adoptions=rec["adopt"], **numbers, launches=launches,
         spans=dict(spans), identical=same)
    del eng, harness, adopt
    gc.collect()                      # the timed methods close cycles
    torch.cuda.empty_cache()
    return launches


def phase_telemetry(model, params, want):
    """The serve stream without and with a ``Telemetry`` hub
    (``block_steps=True``), alternated (without, with, with, without).
    Gates: streams equal the serve phase's, exact launch counts, one span
    per step callable run (prefill, decode_step) and per engine step. The
    last hub's JSONL and Chrome trace go to ``chiprun_out/``. Then frozen
    decode steps through each engine's step callable, with and without
    the hub's span wrapper, in alternated rounds."""
    import collections
    from repro_torch.serving import ContinuousEngine, EngineConfig, Telemetry
    cfg = model.cfg
    total = {"moe_gmm": 0, "decode_attn": 0}
    step_ms = {"no_hub": [], "hub": []}
    engines = {}
    for name in ("no_hub", "hub", "hub", "no_hub"):
        hub = Telemetry(block_steps=True) if name == "hub" else None
        eng = ContinuousEngine(model, params, batch_slots=SLOTS,
                               cache_cap=CACHE_CAP,
                               config=EngineConfig(kernels=True,
                                                   telemetry=hub))
        reqs = _stream(cfg, 10, 64, 200, 16, 64, seed=0)
        launches, calls, numbers = _serve_run(eng, [(eng, reqs)])
        phase = f"telemetry[{name}]"
        _check_launches(phase, launches, calls)
        same = [list(r.out_tokens) for r in reqs] == want
        require(same, phase, "streams differ from the serve phase's")
        for k in total:
            total[k] += launches[k]
        step_ms[name].append(numbers["step_ms_mean"])
        extra = {}
        if hub is not None:
            spans = collections.Counter(s.name for s in hub.spans)
            exact = (spans["prefill"] == calls["prefill_calls"]
                     and spans["decode_step"] == calls["decode_steps"]
                     and spans["engine_step"] == numbers["engine_steps"])
            require(exact, phase, f"spans {dict(spans)} for {calls} and "
                    f"{numbers['engine_steps']} engine steps")
            extra = {"spans": dict(spans), "events": dict(hub.bus.counts),
                     "metrics": sorted(hub.snapshot()["metrics"])}
            base = os.path.join(ROOT, "chiprun_out", "telemetry_serve")
            os.makedirs(os.path.dirname(base), exist_ok=True)
            hub.write_jsonl(base + ".jsonl")
            hub.write_chrome_trace(base + ".trace.json")
            extra["written"] = [base + ".jsonl", base + ".trace.json"]
        emit("telemetry", ok=True, run=name, **numbers, launches=launches,
             identical=same, **extra)
        engines[name] = eng
    rounds, medians = _decode_rounds(
        {k: _frozen_decode(e, wrapped=True) for k, e in engines.items()})
    emit("telemetry", step_ms_mean=step_ms, decode_call_ms_rounds=rounds,
         decode_call_ms_median=medians)
    return total


def _ep_layer_checks(model, params, eng):
    """Layer 0's MoE on one real decode batch (the embeddings of the
    engine's current tokens, normed) and one 256-token prefill (the
    stream's longest prompt in its padded bucket): the EP layer over
    ``eng``'s group against the plain EP layer (same ranks,
    ``_experts_ffn``) and, at the decode batch, the unsharded
    ``moe_apply_kernel`` (both drop-free there: the capacity clamps to the
    token count). The plain layer runs on fp32 copies of the tokens and
    the experts, as the kernels' plain versions upcast (``kernels/ref.py``):
    in bf16 it rounds each product to bf16 and lands as far from the fp32
    layer as the kernel does (PERF.md §6), so that comparison is
    printed beside, not gated. Also the dropped assignments of the
    prefill, EP (per-source capacity) against unsharded."""
    import torch
    from repro_torch.distributed.alltoall import ep_dispatch_combine
    from repro_torch.models import moe as tm
    from repro_torch.models.layers import rmsnorm
    cfg = model.cfg
    layer = params["segments"][0][0]
    p0 = {"router": layer["moe"]["router"][0],
          "experts": {k: v[0] for k, v in layer["moe"]["experts"].items()}}
    ex32 = {k: v.float() for k, v in p0["experts"].items()}
    kc = model.with_kernels().kernels
    pc = eng.model.pc
    # The stream's longest prompt, left-padded with 0 to its 256 bucket as
    # the engine pads it (the pad rows all route alike, so they drop).
    prompt = max((r.prompt for r in _stream(cfg, 10, 64, 200, 16, 64,
                                            seed=0)), key=len)
    padded = [0] * (256 - len(prompt)) + [int(t) for t in prompt]
    toks = {"decode": eng.tokens[:, 0],
            "prefill256": torch.tensor(padded, device="cuda")}
    out = {}
    for name, t in toks.items():
        x = params["embed"][t] * cfg.d_model ** 0.5
        x = rmsnorm(layer["ln2"][0], x, cfg.norm_eps)
        y_k, _ = ep_dispatch_combine(x, p0["router"], p0["experts"], cfg.moe,
                                     cfg.act, pc, kernels=kc)
        y_p, _ = ep_dispatch_combine(x.float(), p0["router"], ex32, cfg.moe,
                                     cfg.act, pc)
        y_pb, _ = ep_dispatch_combine(x, p0["router"], p0["experts"],
                                      cfg.moe, cfg.act, pc)
        row = {"tokens": int(t.numel()),
               "max_abs_y": float(y_k.float().abs().max()),
               "vs_plain_ep_max_abs_err": max_errs(y_k, y_p)[0],
               "vs_bf16_plain_ep_max_abs_err": max_errs(y_k, y_pb)[0],
               "bf16_plain_vs_plain_ep_max_abs_err": max_errs(y_pb, y_p)[0]}
        if name == "decode":
            y_u, _ = tm.moe_apply_kernel(p0, x, cfg.moe, cfg.act, kc)
            row["vs_unsharded_max_abs_err"] = max_errs(y_k, y_u)[0]
        else:
            _, idx, _ = tm.route(p0["router"], x, cfg.moe)
            k, e = cfg.moe.top_k, cfg.moe.n_experts
            cap = tm.capacity(256, k, e, cfg.moe.capacity_factor)
            _, keep = tm.dispatch_indices(idx, e, cap)
            n = pc.group.n
            t_loc = 256 // n
            cap_loc = tm.capacity(t_loc, k, e, cfg.moe.capacity_factor)
            kept = sum(int(tm.dispatch_indices(idx[r * t_loc:(r + 1) * t_loc],
                                               e, cap_loc)[1].sum())
                       for r in range(n))
            row.update(dropped_unsharded=256 * k - int(keep.sum()),
                       dropped_ep=256 * k - kept, capacity_unsharded=cap,
                       capacity_per_source=cap_loc)
        out[name] = row
    return out


def _exchange_ms(group, n_ep, epd, cap, d, dtype, rounds, flush):
    """Device ms of one dispatch exchange of the decode step's buckets
    over ``group`` (one copy per pair of each round), and its bytes."""
    import torch
    from repro_torch.distributed.alltoall import ep_all_to_all
    bufs = [torch.randn((n_ep, epd, cap, d), device="cuda").to(dtype)
            for _ in range(n_ep)]
    before = group.copy_bytes
    ep_all_to_all(bufs, group, rounds)
    # The monolithic exchange is one transposing copy of every buffer.
    nbytes = (group.copy_bytes - before if rounds is not None
              else sum(b.numel() * b.element_size() for b in bufs))
    return time_ms(lambda: ep_all_to_all(bufs, group, rounds), flush), nbytes


def phase_serve_ep(model, params, want, solo, monitor, serve_peak_gb):
    """The serve phase's model and stream through ``DistributedEngine`` over
    ``LocalGroup(4, cuda)``: 4 in-process ranks of 4 experts each, whose
    expert shards are views of the served params. (a) "ep"; (b) "aurora"
    with round robin; (c) "aurora" with rounds from ``rounds_from_trace``
    on the monitored counts of the replicated phase's unreplicated run,
    adopted mid-stream; (d) (b) with the overlap. Gates: the four streams
    identical, every request complete, finite logits, exact launch counts
    (decode_attn 8 per decode step; moe_gmm 8 x 4 per decode step and per
    prefill on the synchronous paths, 8 x 4 x (R + 1) with the overlap's R
    rounds), the EP layer within 2e-2 of the plain EP layer (fp32) at a
    decode batch and a 256-token prefill and of the unsharded kernel layer at the
    decode batch, the peak within 1 GB of the serve phase's. Printed:
    decode-step ms in alternated rounds (unsharded, a, b, d), profiles of
    the (b) and (d) decode steps, one rank's ``moe_gmm`` against its bound
    at the synchronous and the pipelined bucket shapes, the round copies'
    bytes and ms, the prefill's dropped assignments EP against
    unsharded."""
    import torch
    from repro_torch.distributed import LocalGroup, round_robin_rounds
    from repro_torch.serving import (ContinuousEngine, DistributedEngine,
                                     EngineConfig, rounds_from_trace)
    cfg = model.cfg
    n_ep, n_e = 4, cfg.moe.n_experts
    epd = n_e // n_ep
    emit("serve_ep", note="the exchange is in-process on one card: the "
         "ranks' round transfers are device-to-device copies, so the cost "
         "of a network between cards is not measured here")
    adopted = rounds_from_trace(monitor.trace(), n_ep)
    runs = {"a_ep": ("ep", False), "b_aurora_round_robin": ("aurora", False),
            "c_aurora_adopted": ("aurora", False),
            "d_aurora_overlap": ("aurora", True)}
    streams, engines, total = {}, {}, {"moe_gmm": 0, "decode_attn": 0}
    group_copies = {}
    for name, (impl, overlap) in runs.items():
        group = LocalGroup(n_ep, "cuda")
        eng = DistributedEngine(model, params, batch_slots=SLOTS,
                                cache_cap=CACHE_CAP, group=group,
                                moe_impl=impl, overlap=overlap,
                                config=EngineConfig(kernels=True))
        eng.serve(_stream(cfg, 1, 64, 64, 2, 2, seed=2))      # warm-up
        torch.cuda.synchronize()
        state = {}
        stepper = eng
        if name == "c_aurora_adopted":
            def step(eng=eng):
                worked = eng.step()
                if eng.decode_steps >= 24 and "at" not in state:
                    eng.adopt(monitor.trace())
                    state["at"] = eng.decode_steps
                return worked
            stepper = _Stepper(eng, step)
        copies0 = (group.copies, group.copy_bytes)
        reqs = _stream(cfg, 10, 64, 200, 16, 64, seed=0)
        launches, calls, numbers = _serve_run(stepper, [(eng, reqs)])
        phase = f"serve_ep[{name}]"
        require(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
                phase, "a request did not get all its tokens")
        rounds = 1 + len(eng.rounds or round_robin_rounds(n_ep)) \
            if overlap else 1
        per_call = N_LAYERS * n_ep * rounds
        want_l = {"decode_attn": calls["decode_steps"] * N_LAYERS,
                  "moe_gmm": (calls["decode_steps"] + calls["prefill_calls"])
                  * per_call}
        require(launches == want_l, phase,
                f"launch counts {launches} != expected {want_l}")
        finite = _finite_decode(phase, eng, params)
        require(numbers["max_memory_allocated_GB"] <= serve_peak_gb + 1.0,
                phase, f"peak {numbers['max_memory_allocated_GB']} GB, the "
                f"serve phase's {serve_peak_gb} GB + 1 GB allowed")
        if name == "c_aurora_adopted":
            require(eng.rounds == adopted and "at" in state, phase,
                    f"rounds {eng.rounds} adopted at {state}")
        streams[name] = [list(r.out_tokens) for r in reqs]
        for k in total:
            total[k] += launches[k]
        group_copies[name] = (group.copies - copies0[0],
                              group.copy_bytes - copies0[1])
        emit("serve_ep", ok=True, run=name, moe_impl=impl, overlap=overlap,
             ranks=n_ep, transport=group.transport,
             rounds=[list(r) for r in (eng.rounds or ())],
             adopted_at=state.get("at"), **numbers, solo_step_ms={
                 k: solo[k] for k in ("step_ms_mean", "step_ms_p50",
                                      "step_ms_p95")},
             launches=launches, moe_gmm_per_call=per_call,
             round_copies=group_copies[name][0],
             round_copy_bytes=group_copies[name][1],
             round_copy_bytes_per_call=group_copies[name][1] / max(
                 1, calls["decode_steps"] + calls["prefill_calls"]),
             equals_serve_stream=streams[name] == want, logits_finite=finite)
        if name != "c_aurora_adopted":          # kept for the timing
            engines[name] = eng
        del eng
    same = all(v == streams["a_ep"] for v in streams.values())
    emit("serve_ep", identical=same,
         equals_serve_stream={k: v == want for k, v in streams.items()})
    require(same, "serve_ep", "the EP runs' streams differ from each other")

    layer = _ep_layer_checks(model, params, engines["b_aurora_round_robin"])
    ok = (all(r["vs_plain_ep_max_abs_err"] <= 2e-2 for r in layer.values())
          and layer["decode"]["vs_unsharded_max_abs_err"] <= 2e-2)
    emit("serve_ep", layer_checks=layer, tol=2e-2, ok=ok)
    require(ok, "serve_ep", f"EP layer errors {layer}")

    unsharded = ContinuousEngine(model, params, batch_slots=SLOTS,
                                 cache_cap=CACHE_CAP,
                                 config=EngineConfig(kernels=True))
    unsharded.serve(_stream(cfg, 10, 64, 200, 16, 64, seed=0))
    fns = {"unsharded": _frozen_decode(unsharded)}
    fns.update({k: _frozen_decode(engines[k]) for k in
                ("a_ep", "b_aurora_round_robin", "d_aurora_overlap")})
    rounds_ms, medians = _decode_rounds(fns)
    emit("serve_ep", decode_step_ms_rounds=rounds_ms,
         decode_step_ms_median=medians)
    _profile("ep_aurora_decode", fns["b_aurora_round_robin"], 10)
    _profile("ep_aurora_overlap_decode", fns["d_aurora_overlap"], 10)

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for step, c, sizes in (("ep_rank_sync", n_ep * 2, [6, 8, 0, 3]),
                           ("ep_rank_overlap_chunk", 2, [2, 1, 0, 2])):
        rows.append(_rank_moe_timing(model, params, epd, c, sizes, gen,
                                     flush))
        emit("timing", name="moe_gmm", step=step, **rows[-1])
    for name, rounds in (("monolithic", None),
                         ("round_robin", round_robin_rounds(n_ep))):
        ms, nbytes = _exchange_ms(LocalGroup(n_ep, "cuda"), n_ep, epd, 2,
                                  cfg.d_model, params["embed"].dtype, rounds,
                                  flush)
        emit("timing", name="ep_exchange", exchange=name,
             shape=[n_ep, epd, 2, cfg.d_model], ms=ms,
             round_copy_bytes=nbytes, per_decode_step=2 * N_LAYERS,
             ms_per_decode_step=ms * 2 * N_LAYERS)
    del engines, unsharded, flush
    gc.collect()
    torch.cuda.empty_cache()
    return total


EXAMPLES = {                     # examples/torch/<name>.py: reduced flags
    "quickstart": [], "continuous_serving": [], "scheduled_dispatch": [],
    "serve_colocated": [], "serve_multi_tenant": [],
    "train_moe": ["--steps", "20"],
}


def phase_legacy_and_examples(model, params):
    """The reference's legacy engine keywords and the port's six examples
    on the card. (a) The serve phase's phi3.5 (8 layers) in a
    ``ContinuousEngine`` built with ``prefill_chunk=64, kernels=True``
    as keywords: exactly one ``DeprecationWarning``, and the greedy
    streams of the ``EngineConfig``-built engine on a short stream. The
    launch counters are set to 0 before the two runs and read after (the
    return value, added to the kernel rows). (b) Each example's ``main``
    from ``examples/torch`` on the card, at its reduced flags
    (``train_moe`` 20 steps: its first and last ce are printed); what the
    examples print goes to ``chiprun_out/examples_stdout.txt``."""
    import importlib.util
    import io
    import warnings
    import torch
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.serving import ContinuousEngine, EngineConfig
    phase = "legacy_and_examples"
    t_phase = time.perf_counter()
    moe_gmm.launches = decode_attn.launches = 0
    out = {}
    for how in ("legacy", "config"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if how == "legacy":
                eng = ContinuousEngine(model, params, SLOTS, CACHE_CAP,
                                       prefill_chunk=64, kernels=True)
            else:
                eng = ContinuousEngine(model, params, SLOTS, CACHE_CAP,
                                       config=EngineConfig(
                                           prefill_chunk=64, kernels=True))
            reqs = _stream(model.cfg, 4, 64, 200, 8, 16, seed=5)
            t1 = time.perf_counter()
            eng.serve(reqs)
            torch.cuda.synchronize()
        out[how] = {
            "streams": [list(map(int, r.out_tokens)) for r in reqs],
            "warnings": [str(w.message) for w in caught
                         if issubclass(w.category, DeprecationWarning)],
            "serve_s": time.perf_counter() - t1}
        del eng
    launches = {"moe_gmm": moe_gmm.launches,
                "decode_attn": decode_attn.launches}
    same = out["legacy"]["streams"] == out["config"]["streams"]
    emit(phase, part="legacy_keywords", arch=model.cfg.arch_id,
         n_layers=model.cfg.n_layers, identical=same,
         legacy_warnings=out["legacy"]["warnings"],
         config_warnings=out["config"]["warnings"],
         serve_s={k: v["serve_s"] for k, v in out.items()},
         launches=launches)
    require(same and len(out["legacy"]["warnings"]) == 1
            and not out["config"]["warnings"]
            and all(v > 0 for v in launches.values()), phase,
            "the legacy-keyword engine against the EngineConfig one")
    torch.cuda.empty_cache()
    buf, ran = io.StringIO(), {}
    for name, argv in EXAMPLES.items():
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", os.path.join(ROOT, "examples", "torch",
                                            f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t1 = time.perf_counter()
        print(f"== examples/torch/{name}.py {' '.join(argv)}", file=buf)
        with contextlib.redirect_stdout(buf):
            res = mod.main(list(argv))
        torch.cuda.synchronize()
        ran[name] = {"seconds": time.perf_counter() - t1}
        if name == "train_moe":
            ran[name].update(steps=res[-1]["step"] + 1,
                             first_ce=res[0]["ce"], last_ce=res[-1]["ce"])
        if name == "scheduled_dispatch":
            ran[name]["max_abs_diff"] = res
    path = os.path.join(ROOT, "chiprun_out", "examples_stdout.txt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(buf.getvalue())
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "repro"))
    emit(phase, part="examples", examples=ran, stdout=path,
         jax_or_repro_imported=leaked)
    require(not leaked and math.isfinite(ran["train_moe"]["last_ce"]),
            phase, f"examples: {ran}, imported {leaked}")
    emit(phase, ok=True, seconds=time.perf_counter() - t_phase)
    return launches


def _rank_moe_timing(model, params, epd, c, sizes, gen, flush):
    """``moe_gmm`` over one rank's ``epd`` experts (views of layer 0's
    leaves) at bucket height ``c`` with group sizes ``sizes``; bound: the
    live experts' weights, x and y once each, and the group sizes."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_gmm import moe_gmm
    cfg = model.cfg
    d, f = cfg.d_model, cfg.moe.d_ff
    ex = {k: v[0][:epd] for k, v in
          params["segments"][0][0]["moe"]["experts"].items()}
    dtype = ex["w_gate"].dtype
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    buf = torch.randn((epd, c, d), generator=gen, device="cuda").to(dtype)
    buf[torch.arange(c, device="cuda")[None, :] >= gs[:, None]] = 0
    args = (buf, ex["w_gate"], ex["w_up"], ex["w_down"])
    ms = time_ms(lambda: moe_gmm(*args, group_sizes=gs), flush)
    plain = time_ms(lambda: ref.moe_ffn_ref(*args, group_sizes=gs), flush, 5)
    live = int((gs > 0).sum())
    nbytes = ((live * 3 * d * f + 2 * buf.numel()) * buf.element_size()
              + epd * 4)
    b_ms, b_by = bound(nbytes, 2 * 3 * d * f * int(gs.sum()))
    return {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": [epd, c, d, f],
            "group_sizes": sizes, "live_experts": live, "bytes": nbytes,
            "bound_share": b_ms / ms}

# The dense families at full width: (arch, depth cut or None, cache cap).
# (arch, depth cut, cache): every width kept, the depths cut so that the
# whole script stays well inside its time limit.
DENSE_SERVED = (("phi4-mini-3.8b", 8, CACHE_CAP),
                ("gemma-7b", 8, CACHE_CAP), ("gemma3-27b", 6, 4096),
                ("qwen3-32b", 4, CACHE_CAP))


@contextlib.contextmanager
def _attn_tally():
    """What the GQA layers did while the block runs, seen at their call
    sites: ``t["shapes"][(H, S)]``, ``decode_attn``'s launches by the
    shape they ran at (each call of ``attention.decode_attn_auto`` adds
    the kernel counter's rise during that call under its q's heads and
    its cache's positions), and ``t["heads_dim"][(H, D)]`` the same by
    its q's heads and head_dim (which tells colocated tenants apart);
    ``t["ring_prefill"]``, layer calls of a fresh
    prefill that wrote a ring smaller than its prompt (``pos % cap``);
    ``t["ring_decode"]``, live rows whose decode write wrapped a full ring
    back to slot 0 (``length == cap``), summed over the ring layers' calls
    on the card and read once when the block ends."""
    import torch
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.models import attention as tattn
    t = {"shapes": collections.Counter(),
         "heads_dim": collections.Counter(), "ring_prefill": 0,
         "ring_decode": 0}
    wraps = []
    auto, block = tattn.decode_attn_auto, tattn.attn_block

    def counted_auto(q, k, *args, **kw):
        n = decode_attn.launches
        out = auto(q, k, *args, **kw)
        t["shapes"][(q.shape[1], k.shape[1])] += decode_attn.launches - n
        t["heads_dim"][(q.shape[1], q.shape[-1])] += decode_attn.launches - n
        return out

    def observed_block(p, x, **kw):
        if kw["cache"] is None:                 # an encoder layer
            return block(p, x, **kw)
        cap, window = kw["cache"]["k"].shape[1], kw.get("window")
        mode = kw.get("mode", "prefill")
        if mode == "prefill" and kw.get("length") is None and cap < x.shape[1]:
            t["ring_prefill"] += 1
        elif mode == "decode" and window is not None and cap <= window:
            hit = kw["length"] == cap
            if kw.get("row_mask") is not None:
                hit = hit & kw["row_mask"]
            wraps.append(hit.sum())
        return block(p, x, **kw)
    tattn.decode_attn_auto, tattn.attn_block = counted_auto, observed_block
    try:
        yield t
    finally:
        tattn.decode_attn_auto, tattn.attn_block = auto, block
    t["ring_decode"] = int(torch.stack(wraps).sum()) if wraps else 0


def _attn_layers(cfg) -> int:
    """Decoder layers with GQA self-attention (every layer but Mamba2's)."""
    return sum(kind != "M" for kind in cfg.layer_kinds())


def _attn_shapes(cfg, cap: int, steps: int):
    """``decode_attn``'s launches by (H, S) in ``steps`` decode steps of
    ``cfg``'s stack over a cache of ``cap``: one per attention layer, at
    the layer cache's capacity (``transformer.entry_capacity``)."""
    from repro_torch.models import transformer as tt
    want = collections.Counter()
    for kind in cfg.layer_kinds():
        if kind != "M":
            want[(cfg.n_heads, tt.entry_capacity(kind, cfg, cap))] += steps
    return want


def _peak_gate(run, peak_gb, params, *held):
    """The dense runs' memory gate: ``peak_gb`` (the peak beyond what was
    allocated before the model was made) within 2 GB of ``params``' weights
    and the caches of ``held`` ((model, cap) pairs, or (model, cap,
    src_len) for an encoder-decoder's cross K/V). Returns both sides, and
    the peak over the weights alone."""
    weights = _nbytes(params) / 1e9
    held_gb = weights + sum(_cache_bytes(m, SLOTS, *caps)
                            for m, *caps in held) / 1e9
    require(peak_gb <= held_gb + 2.0, run, f"peak {peak_gb} GB beyond the "
            f"other models', weights + caches {held_gb} GB + 2 GB allowed")
    return {"weights_and_cache_GB": held_gb,
            "peak_beyond_other_models_GB": peak_gb,
            "peak_over_weights_GB": peak_gb - weights}


def _cache_bytes(model, batch: int, cap: int, src_len: int = 0) -> int:
    """Bytes of ``model``'s per-slot cache (rings, SSM state and cross K/V
    of ``src_len`` positions included), from its shapes (made on the meta
    device: nothing is allocated)."""
    from repro_torch.models import transformer as tt
    cache = tt.init_cache(model.cfg, batch, cap, src_len=src_len,
                          device="meta")
    return sum(t.numel() * t.element_size() for t in tt.cache_leaves(cache))


def _dense_stream(moe_cfg, long: bool = False):
    """The serve phase's stream (phi3.5's vocabulary, which every dense
    model's vocabulary holds). With ``long``, its first 8 requests and two
    more after them: 1000 prompt tokens and 64 new ones (its decode passes
    position 1024, so gemma3's rings wrap while it decodes) and 2100
    prompt tokens (its prefill takes the flash branch and wraps the rings)
    and 32 new ones."""
    import numpy as np
    from repro_torch.serving import Request
    reqs = _stream(moe_cfg, 8 if long else 10, 64, 200, 16, 64, seed=0)
    if long:
        rng = np.random.default_rng(4)
        t = reqs[-1].arrival
        for i, (n, new) in enumerate(((1000, 64), (2100, 32))):
            reqs.append(Request(prompt=[int(x) for x in rng.integers(
                1, moe_cfg.vocab, n)], max_new_tokens=new, arrival=t + 1 + i))
    return reqs


def _attn_check(call, flush):
    """``decode_attn`` on a captured ``decode_attn_auto`` call (a served
    layer's q, cache and fill levels) against its plain version (2e-2,
    bf16), then timed (``_attn_timing``)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attn import decode_attn
    q, k, v, valid = call[0]
    valid = valid.to(torch.int32).reshape(-1)
    err = max_errs(decode_attn(q, k, v, valid),
                   ref.decode_attn_ref(q, k, v, valid))[0]
    return {"max_abs_err": err, "tol": 2e-2, **_attn_timing(q, k, v, valid,
                                                            flush)}


def _dense_run(phase, model, params, cap, config, reqs, other_gb):
    """One stream through ``ContinuousEngine`` (after a one-request
    warm-up). Gates: every request complete, exact launch counts
    (``decode_attn`` once per attention layer and decode step,
    ``moe_gmm`` never),
    ``decode_attn``'s launches by shape as each layer's cache gives them),
    finite logits, the peak beyond what was allocated before the model
    (``other_gb``) within 2 GB of its weights and cache (``_peak_gate``).
    Returns the engine, the launches, the numbers and the run's
    ``_attn_tally``."""
    import torch
    from repro_torch.serving import ContinuousEngine
    eng = ContinuousEngine(model, params, batch_slots=SLOTS, cache_cap=cap,
                           config=config)
    eng.serve(_stream(model.cfg, 1, 64, 64, 2, 2, seed=2))    # warm-up
    torch.cuda.synchronize()
    with _attn_tally() as tally:
        launches, calls, numbers = _serve_run(eng, [(eng, reqs)])
    require(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
            phase, "a request did not get all its tokens")
    require(eng.num_pending == 0, phase,
            f"{eng.num_pending} prefills left in flight")
    _check_launches(phase, launches, calls,
                    attn_layers=_attn_layers(model.cfg), moe_layers=0)
    want = _attn_shapes(model.cfg, cap, calls["decode_steps"])
    require(tally["shapes"] == want, phase, f"decode_attn launches by "
            f"(H, S) {dict(tally['shapes'])} != expected {dict(want)}")
    finite = _finite_decode(phase, eng, params)
    gate = _peak_gate(phase, numbers["max_memory_allocated_GB"] - other_gb,
                      params, (model, cap))
    return eng, launches, {**numbers, "logits_finite": finite, **gate}, tally


def phase_serve_dense(moe_model, moe_params, moe_streams):
    """The dense families at full width, one model at a time (each freed
    before the next is made), beside the served phi3.5-MoE (still held):
    phi4-mini cut to 8 of 32 layers (G = 3) on the serve stream one-shot
    and with chunks of 64, then through ``ServingEngine`` (8 prompts of
    128 tokens, 32 new) and, beside phi3.5-MoE, in
    ``ColocatedContinuousEngine``; gemma-7b cut to 8 of 28 layers (G = 1,
    D = 256) one-shot; gemma3-27b cut to 6
    layers (one LLLLLG block; cache 4096, rings of 1024; prompts padded to
    multiples of 64) on the long stream (``_dense_stream``); qwen3-32b cut
    to 4 layers (q/k-norm; G = 8) one-shot. Gates: every request
    complete, exact launch counts, finite logits, peak memory, the flash
    branch taken and rings wrapped (gemma3), each colocated tenant's
    stream its solo stream, and ``decode_attn`` within 2e-2 of its plain
    version on each arch's served layers (gemma3: a wrapped ring and a
    global cache). Returns the ``kernels`` rows of ``decode_attn`` and the
    phi3.5 tenant's launches of each kernel in the colocated run."""
    import torch
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.models import Model
    from repro_torch.models import attention as tattn
    from repro_torch.models import layers as tl
    from repro_torch.models import transformer as tt
    from repro_torch.serving import EngineConfig
    t_phase = time.perf_counter()
    moe_cfg = moe_model.cfg
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows, tol = [], 2e-2
    for arch, n_layers, cap in DENSE_SERVED:
        phase = f"serve_dense[{arch}]"
        cfg = get_config(arch)
        if n_layers is not None:
            cfg = cut_depth(cfg, n_layers)
        other_gb = torch.cuda.memory_allocated() / 1e9
        model = Model(cfg, device="cuda")
        t0 = time.perf_counter()
        params = model.init(0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        head = {"arch": arch, "n_layers": cfg.n_layers,
                "depth_cut": ("full depth" if n_layers is None else
                              f"{n_layers} of {get_config(arch).n_layers} "
                              "layers, every published width"),
                "dtype": cfg.dtype, "weights_GB": _nbytes(params) / 1e9,
                "init_s": init_s, "slots": SLOTS, "cache_cap": cap}
        long = cfg.layer_pattern is not None
        config = EngineConfig(kernels=True,
                              bucket_policy="step:64" if long else "pow2")
        ring = tt.entry_capacity("L", cfg, cap) if long else None
        n_flash = [0]
        flash = tl.flash_attention

        def counted(*a, **kw):
            n_flash[0] += 1
            return flash(*a, **kw)
        tl.flash_attention = counted
        try:
            reqs = _dense_stream(moe_cfg, long)
            eng, launches, numbers, tally = _dense_run(
                phase, model, params, cap, config, reqs, other_gb)
        finally:
            tl.flash_attention = flash
        shapes = collections.Counter(tally["shapes"])
        extra = {}
        if long:
            extra = {"flash_calls": n_flash[0],
                     "ring_prefill_layer_calls": tally["ring_prefill"],
                     "ring_decode_wraps": tally["ring_decode"],
                     "longest_prompt": max(len(r.prompt) for r in reqs)}
            require(n_flash[0] > 0 and tally["ring_prefill"]
                    and tally["ring_decode"], phase,
                    f"flash or ring wrap not reached: {extra}")
        emit("serve_dense", ok=True, run="one_shot", **head,
             admission="one-shot", **numbers, launches=launches, **extra)
        streams = [list(r.out_tokens) for r in reqs]

        # decode_attn on the served layers: every call of a frozen decode
        # over the served cache (each row at its final fill level).
        attn_calls = _calls(tattn, "decode_attn_auto", _frozen_decode(eng))
        require(len(attn_calls) == cfg.n_layers, phase,
                f"{len(attn_calls)} decode_attn calls in a decode step")
        kinds = cfg.layer_kinds()
        picks = {"": 0} if not long else {"ring": kinds.index("L"),
                                          "global": kinds.index("G")}
        checks = {tag: _attn_check(attn_calls[i], flush)
                  for tag, i in picks.items()}
        del attn_calls

        if arch == "phi4-mini-3.8b":
            _profile("phi4_mini_decode_step", _frozen_decode(eng), 10)
            del eng
            # Chunks of 64.
            creqs = _dense_stream(moe_cfg)
            ceng, claunches, cnumbers, ctally = _dense_run(
                phase + "[chunk64]", model, params, cap,
                EngineConfig(kernels=True, prefill_chunk=64), creqs,
                other_gb)
            del ceng
            emit("serve_dense", ok=True, run="chunk64", **head,
                 prefill_chunk=64, **cnumbers, launches=claunches,
                 equals_one_shot=[list(r.out_tokens) for r in creqs]
                 == streams)
            co_shapes, moe_part = _colocated_dense(
                phase, moe_model, moe_params, moe_streams, model, params,
                streams, other_gb)
            shapes += ctally["shapes"] + co_shapes + _static_dense(
                phase, model, params, head, other_gb)
        else:
            del eng
        if long:
            wrapped = sum(int(x) == ring for x in checks["ring"]["valid_len"])
            require(checks["ring"]["shape"][-1] == ring and wrapped, phase,
                    f"the ring call {checks['ring']['shape']} has no "
                    "wrapped row")
            emit("serve_dense", arch=arch, ring_rows_wrapped=wrapped)
        # Launches of each row: counted by shape in the served runs.
        own = {(h, s): n for (h, s), n in shapes.items() if h == cfg.n_heads}
        n_of = {"": sum(own.values()), "ring": own.get((cfg.n_heads, ring), 0),
                "global": own.get((cfg.n_heads, cap), 0)}
        for tag, row in checks.items():
            emit("timing", name="decode_attn", arch=arch, layers=tag or "all",
                 **row)
            require(row["max_abs_err"] <= tol, phase, f"decode_attn {tag} "
                    f"{row['shape']}: max abs err {row['max_abs_err']}")
            rows.append({"name": "decode_attn", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/"
                                   "decode_attn.cu",
                         "replaces": "src/repro/kernels/decode_attn.py:91",
                         "arch": arch + (f" ({tag}, {row['shape'][-1]})"
                                         if tag else ""),
                         "launches": n_of[tag],
                         **row})
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    emit("serve_dense", seconds=time.perf_counter() - t_phase)
    return rows, moe_part


def _static_dense(phase, model, params, head, other_gb):
    """8 prompts of 128 tokens, 32 new each, through ``ServingEngine``
    (kernel path), after a warm-up batch; then the same requests, all at
    t = 0, through ``ContinuousEngine`` with the same pad length (the
    streams are printed side by side; bf16 batched and batch-1 prefills
    may round apart, so they are not gated). Gates: complete, exact
    launch counts (``decode_attn`` once per layer and decode step, by
    shape), the peak within 2 GB of the weights and cache. Returns its
    ``decode_attn`` launches by (H, S) (``_attn_tally``)."""
    import numpy as np
    import torch
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.serving import (ContinuousEngine, EngineConfig, Request,
                                     ServingEngine)
    run = phase + "[static]"
    rng = np.random.default_rng(5)
    prompts = [[int(x) for x in rng.integers(1, model.cfg.vocab, 128)]
               for _ in range(SLOTS)]

    def reqs():
        return [Request(prompt=list(p), max_new_tokens=32) for p in prompts]
    eng = ServingEngine(model, params, batch_slots=SLOTS, cache_cap=CACHE_CAP,
                        kernels=True)
    eng.serve([Request(prompt=p[:16], max_new_tokens=2) for p in prompts])
    torch.cuda.synchronize()
    dec0 = eng.decode_steps
    torch.cuda.reset_peak_memory_stats()
    moe_gmm.launches = decode_attn.launches = 0
    t0 = time.perf_counter()
    with _attn_tally() as tally:
        out = eng.serve(reqs())
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"moe_gmm": moe_gmm.launches,
                "decode_attn": decode_attn.launches}
    steps = eng.decode_steps - dec0
    want = {"moe_gmm": 0, "decode_attn": steps * model.cfg.n_layers}
    require(launches == want, run, f"launch counts {launches} != {want}")
    want = _attn_shapes(model.cfg, CACHE_CAP, steps)
    require(tally["shapes"] == want, run, f"decode_attn launches by (H, S) "
            f"{dict(tally['shapes'])} != expected {dict(want)}")
    require(all(len(r.out_tokens) == 32 for r in out), run,
            "a request did not get all its tokens")
    gate = _peak_gate(run, torch.cuda.max_memory_allocated() / 1e9 - other_gb,
                      params, (model, CACHE_CAP))
    cont = ContinuousEngine(
        model, params, batch_slots=SLOTS, cache_cap=CACHE_CAP,
        config=EngineConfig(kernels=True, prefill_len=128)).serve(reqs())
    tokens = sum(len(r.out_tokens) for r in out)
    emit("serve_dense", ok=True, run="static", **head, batch=SLOTS,
         prompt_len=128, max_new_tokens=32, decode_steps=steps,
         wall_s=wall, tok_per_s=tokens / wall, launches=launches, **gate,
         equals_continuous_t0=[r.out_tokens for r in out]
         == [r.out_tokens for r in cont])
    return tally["shapes"]


def _colocated_dense(phase, moe_model, moe_params, moe_streams, model,
                     params, solo, other_gb):
    """The served phi3.5-MoE (tenant A) beside phi4-mini (tenant B) in
    ``ColocatedContinuousEngine`` (kernel path; no pairing: B has no
    experts), both on the serve stream. Gates: each tenant's stream
    equals its solo stream, every request complete, exact launch counts
    (``decode_attn`` 8 + 8 per lockstep step, ``moe_gmm`` 8 per step and
    per A prefill; ``decode_attn`` by shape, so by tenant), finite logits,
    the peak within 2 GB of phi4-mini's weights and both caches. Returns
    the run's ``decode_attn`` launches by (H, S) and the MoE tenant's
    launches of each kernel (its ``decode_attn`` ones counted at its
    heads)."""
    from repro_torch.serving import ColocatedContinuousEngine, EngineConfig
    run = phase + "[colocated]"
    moe_cfg = moe_model.cfg
    eng = ColocatedContinuousEngine(
        moe_model, model, moe_params, params, batch_slots=SLOTS,
        cache_cap=CACHE_CAP, config=EngineConfig(kernels=True))
    eng.serve(_stream(moe_cfg, 1, 64, 64, 2, 2, seed=2),
              _stream(moe_cfg, 1, 64, 64, 2, 2, seed=2))      # warm-up
    reqs_a = _stream(moe_cfg, 10, 64, 200, 16, 64, seed=0)
    reqs_b = _dense_stream(moe_cfg)
    pre_a = eng.pool_a.prefills
    with _attn_tally() as tally:
        launches, calls, numbers = _serve_run(
            eng, [(eng.pool_a, reqs_a), (eng.pool_b, reqs_b)])
    steps = calls["decode_steps"]
    want = {"decode_attn": steps * (moe_cfg.n_layers + model.cfg.n_layers),
            "moe_gmm": (steps + eng.pool_a.prefills - pre_a)
            * moe_cfg.n_layers}
    require(launches == want, run, f"launch counts {launches} != {want}")
    shapes = tally["shapes"]
    want = (_attn_shapes(moe_cfg, CACHE_CAP, steps)
            + _attn_shapes(model.cfg, CACHE_CAP, steps))
    require(shapes == want and moe_cfg.n_heads != model.cfg.n_heads, run,
            f"decode_attn launches by (H, S) {dict(shapes)} != expected "
            f"{dict(want)}")
    require(all(len(r.out_tokens) == r.max_new_tokens
                for r in reqs_a + reqs_b), run,
            "a request did not get all its tokens")
    for pool in (eng.pool_a, eng.pool_b):
        _finite_decode(run, pool, pool.params)
    same = {"moe_tenant": [list(r.out_tokens) for r in reqs_a] == moe_streams,
            "dense_tenant": [list(r.out_tokens) for r in reqs_b] == solo}
    gate = _peak_gate(run, numbers["max_memory_allocated_GB"] - other_gb,
                      params, (model, CACHE_CAP), (moe_model, CACHE_CAP))
    emit("serve_dense", ok=True, run="colocated", tenant_models=[
        moe_cfg.arch_id + f" ({moe_cfg.n_layers} layers)", model.cfg.arch_id],
        **numbers, launches=launches, equals_solo=same, **gate,
        decode_attn_by_heads={h: n for (h, _), n in shapes.items()})
    require(all(same.values()), run, f"colocated streams differ from the "
            f"solo ones: {same}")
    return shapes, {"moe_gmm": launches["moe_gmm"],
                    "decode_attn": sum(n for (h, _), n in shapes.items()
                                       if h == moe_cfg.n_heads)}


FAMILIES = ("mamba2-1.3b", "zamba2-7b", "qwen2-vl-7b",
            "seamless-m4t-large-v2")


@contextlib.contextmanager
def _logits_finite():
    """Whether every forward's logits were finite while the block runs (one
    device flag per call, read once when the block ends)."""
    import torch
    from repro_torch.models import transformer as tt
    flags, fwd = [], tt.forward

    def checked(*args, **kw):
        out = fwd(*args, **kw)
        flags.append(torch.isfinite(out[0]).all())
        return out
    tt.forward = checked
    seen = {}
    try:
        yield seen
    finally:
        tt.forward = fwd
    seen["calls"] = len(flags)
    seen["finite"] = bool(torch.stack(flags).all()) if flags else None


def phase_serve_families(moe_model, moe_params, moe_streams, moe_solo):
    """The SSM, hybrid, vlm and audio families at full width and depth,
    bf16, seeded weights, one model at a time (each freed before the next
    is made), beside the served phi3.5-MoE (still held): mamba2-1.3b (48
    M layers) on the serve stream one-shot, then with chunks of 64;
    zamba2-7b (70 M layers and 11 uses of the shared block, D = 112) and
    qwen2-vl-7b (28 layers, M-RoPE, G = 7) on the serve stream one-shot,
    qwen2-vl also one batch-1 prefill of 256 seeded patch embeddings;
    SeamlessM4T (24 encoder and 24 decoder layers, D = 64) through
    ``ServingEngine``: 8 prompts of 128 tokens, frames (8, 128, 1024), 32
    new tokens. Gates: every request complete, finite logits, exact launch
    counts (``moe_gmm`` 0; ``decode_attn`` once per attention layer and
    decode step, by (H, S) at the call sites), the peak within 2 GB of the
    weights and caches (``_peak_gate``), and ``decode_attn`` within 2e-2 of
    its plain version on each attention arch's first served layer, then
    timed beside SDPA and its bound. Printed: the serve numbers, a profile
    of three frozen decode steps per arch, and whether mamba2's chunked stream
    equals its one-shot one (bf16 chunk boundaries may move an argmax: not
    gated). Then each of mamba2, zamba2 and qwen2-vl, still held, serves
    its stream beside phi3.5-MoE (``moe_model``, ``moe_params``, its
    streams and solo serve numbers) serving the serve stream, in
    ``ColocatedContinuousEngine``; mamba2 is kept until qwen2-vl is
    loaded, and the three serve together in
    ``MultiTenantContinuousEngine`` (``_colocated_family``: each stream
    its solo stream, exact launches per tenant). SeamlessM4T does not
    colocate: the engines pass no frames. Returns the ``kernels`` rows of
    ``decode_attn`` and phi3.5's launches of each kernel in the colocated
    runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models import attention as tattn
    from repro_torch.serving import EngineConfig
    t_phase = time.perf_counter()
    moe_cfg = moe_model.cfg
    moe = {"model": moe_model, "params": moe_params, "solo": moe_streams,
           "solo_step_ms": moe_solo["step_ms_mean"],
           "reqs": lambda: _stream(moe_cfg, 10, 64, 200, 16, 64, seed=0)}
    moe_part = {"moe_gmm": 0, "decode_attn": 0}
    colocated = collections.Counter()          # families' decode_attn
    held = None                                # mamba2, for 3 tenants
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows, tol = [], 2e-2

    def colocate(tenants, other_gb):
        part, fams = _colocated_family("serve_families", moe, tenants,
                                       other_gb)
        for k in moe_part:
            moe_part[k] += part[k]
        colocated.update(fams)
        gc.collect()                  # the engine's step closures cycle
        torch.cuda.empty_cache()
    for arch in FAMILIES:
        t_arch = time.perf_counter()
        phase = f"serve_families[{arch}]"
        cfg = get_config(arch)
        other_gb = torch.cuda.memory_allocated() / 1e9
        model = Model(cfg, device="cuda")
        t0 = time.perf_counter()
        params = model.init(0)
        torch.cuda.synchronize()
        head = {"arch": arch, "family": cfg.family, "n_layers": cfg.n_layers,
                "attention_layers": _attn_layers(cfg),
                "encoder_layers": cfg.n_encoder_layers,
                "depth_cut": "full depth", "dtype": cfg.dtype,
                "weights_GB": _nbytes(params) / 1e9,
                "init_s": time.perf_counter() - t0, "slots": SLOTS,
                "cache_cap": CACHE_CAP}
        if cfg.is_encoder_decoder:
            step, call, launched = _static_family(phase, model, params, head,
                                                  other_gb)
        else:
            # The serve stream, its tokens drawn below the smaller of the
            # two vocabularies (zamba2's 32000 is under phi3.5's 32064).
            vcfg = dataclasses.replace(moe_cfg, vocab=min(moe_cfg.vocab,
                                                          cfg.vocab))
            def family_reqs(vcfg=vcfg):
                return _stream(vcfg, 10, 64, 200, 16, 64, seed=0)
            reqs = family_reqs()
            eng, launches, numbers, tally = _dense_run(
                phase, model, params, CACHE_CAP, EngineConfig(kernels=True),
                reqs, other_gb)
            emit("serve_families", ok=True, run="one_shot", **head,
                 admission="one-shot", **numbers, launches=launches)
            launched = collections.Counter(tally["shapes"])
            if cfg.family == "ssm":
                creqs = _stream(vcfg, 10, 64, 200, 16, 64, seed=0)
                ceng, claunches, cnumbers, _ = _dense_run(
                    phase + "[chunk64]", model, params, CACHE_CAP,
                    EngineConfig(kernels=True, prefill_chunk=64), creqs,
                    other_gb)
                del ceng
                parts = [next((i for i, (a, b) in enumerate(
                    zip(r.out_tokens, c.out_tokens)) if a != b), None)
                    for r, c in zip(reqs, creqs)]
                emit("serve_families", ok=True, run="chunk64", **head,
                     prefill_chunk=64, **cnumbers, launches=claunches,
                     equals_one_shot=parts == [None] * len(parts),
                     first_differing_token=parts)
                _ssm_chunk_witness(phase, model, params)
            if cfg.input_mode == "patches":
                _patch_prefill(phase, model, params)
            step = _frozen_decode(eng)
            call = None
            if _attn_layers(cfg):
                calls = _calls(tattn, "decode_attn_auto", step)
                require(len(calls) == _attn_layers(cfg), phase,
                        f"{len(calls)} decode_attn calls in a decode step")
                call = calls[0]
                del calls
        _profile(f"{arch}_decode_step", step, 3)
        if call is not None:
            row = _attn_check(call, flush)
            emit("timing", name="decode_attn", arch=arch, **row)
            require(row["max_abs_err"] <= tol, phase, f"decode_attn "
                    f"{row['shape']}: max abs err {row['max_abs_err']}")
            rows.append({"name": "decode_attn", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/"
                                   "decode_attn.cu",
                         "replaces": "src/repro/kernels/decode_attn.py:91",
                         "arch": arch, "launches": sum(launched.values()),
                         **row})
        del step, call
        if not cfg.is_encoder_decoder:
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            tenant = {"model": model, "params": params,
                      "reqs": family_reqs, "other_gb": other_gb,
                      "solo": [list(r.out_tokens) for r in reqs],
                      "solo_step_ms": numbers["step_ms_mean"]}
            colocate([tenant], other_gb)
            if cfg.family == "vlm" and held is not None:
                colocate([held, tenant], held["other_gb"])
                held = None
            elif cfg.family == "ssm":
                held = tenant
            del tenant
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        emit("serve_families", arch=arch,
             seconds=time.perf_counter() - t_arch)
    require(held is None, "serve_families", "the 3-tenant run did not run")
    for r in rows:
        r["launches"] += colocated[r["arch"]]
    emit("serve_families", seconds=time.perf_counter() - t_phase)
    return rows, moe_part


def _ssm_chunk_witness(phase, model, params, n: int = 300,
                       chunk: int = 64, tol: float = 1e-3):
    """Tells rounding from a fault in the SSD scan's continuation: one
    seeded prompt of ``n`` tokens prefilled into one slot one-shot (two
    blocks of the config's SSD chunk) and in chunks of ``chunk`` (each
    resuming from the slot's conv window and state), in the model's dtype
    and in fp32 on the same weights (upcast). Prints, for each, the
    largest gap of the last position's logits and of the final SSM leaves,
    each over the largest magnitude, and whether the argmax agrees. Gate:
    the fp32 logit gap within ``tol`` (a faulty continuation moves the
    logits by about their own size; fp32 rounding by far less)."""
    import torch
    from repro_torch.bridge import map_tree
    from repro_torch.models import Model
    from repro_torch.models import transformer as tt
    cfg, dev = model.cfg, model.device
    toks = torch.randint(1, cfg.vocab, (1, n),
                         generator=torch.Generator().manual_seed(7)).to(dev)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    out = {}
    for name in (cfg.dtype, "float32"):
        if name == cfg.dtype:
            m, p = model, params
        else:
            m = Model(dataclasses.replace(cfg, dtype=name), device=dev)
            p = map_tree(lambda t: t.float() if t.is_floating_point()
                         else t, params)
        runs = []
        for step in (n, chunk):
            cache = m.init_cache(1, CACHE_CAP, per_slot_len=True)
            for i, lo in enumerate(range(0, n, step)):
                logits, cache = m.prefill_chunk_slot(
                    p, {"tokens": toks[:, lo:lo + step]}, cache, 0,
                    first=i == 0, cap=CACHE_CAP)
            runs.append((logits[0, -1, :cfg.vocab], tt.cache_leaves(cache)))
        (l1, s1), (l2, s2) = runs
        out[name] = {"logit_gap": rel(l2, l1),
                     "state_gap": max(rel(b, a) for a, b in zip(s1, s2)),
                     "argmax_equal": int(l1.argmax()) == int(l2.argmax())}
        del m, p, runs, cache, logits, l1, l2, s1, s2
    emit("serve_families", run="chunk_witness", prompt=n, chunk=chunk,
         ssd_chunk=cfg.ssm.chunk, tol=tol, **out)
    require(out["float32"]["logit_gap"] <= tol, phase,
            f"fp32 chunked prefill of {n} tokens differs from the one-shot "
            f"one: {out['float32']}")
    return out


def _patch_prefill(phase, model, params):
    """One batch-1 prefill of 256 seeded patch embeddings (the vision
    stub's output, ``frontend_dim`` wide): logits finite, one row per
    patch, of the padded-vocab width."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(6)
    emb = torch.randn((1, 256, model.cfg.frontend_dim), generator=gen,
                      device="cuda")
    cache = model.init_cache(1, CACHE_CAP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = model.prefill(params, {"embeds": emb}, cache)
    finite = bool(torch.isfinite(logits).all())
    ms = (time.perf_counter() - t0) * 1e3
    require(finite and tuple(logits.shape) == (1, 256, model.padded_vocab),
            phase, f"patch prefill logits {tuple(logits.shape)} "
            f"finite={finite}")
    emit("serve_families", arch=model.cfg.arch_id, run="patch_prefill",
         patches=256, frontend_dim=model.cfg.frontend_dim,
         logits_finite=finite, ms=ms)


def _static_family(phase, model, params, head, other_gb):
    """The encoder-decoder through ``ServingEngine`` (kernel path): 8
    prompts of 128 tokens with seeded frames (8, 128, frontend_dim), 32
    new tokens each (the reference launcher's convention: frames as long
    as the prompts), after a warm-up batch. Gates: complete, finite
    logits, exact launch counts (``decode_attn`` once per decoder layer
    and decode step, by shape), the peak within 2 GB of the weights and
    cache. Returns a frozen decode step over the served batch's cache
    (prefilled again, outside the counted run), its first
    ``decode_attn_auto`` call and the run's launches by (H, S)."""
    import numpy as np
    import torch
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.models import attention as tattn
    from repro_torch.serving import Request, ServingEngine
    run = phase + "[static]"
    cfg = model.cfg
    rng = np.random.default_rng(5)
    prompts = [[int(x) for x in rng.integers(1, cfg.vocab, 128)]
               for _ in range(SLOTS)]
    frames = rng.standard_normal((SLOTS, 128, cfg.frontend_dim),
                                 dtype=np.float32)

    def reqs():
        return [Request(prompt=list(p), max_new_tokens=32) for p in prompts]
    eng = ServingEngine(model, params, batch_slots=SLOTS, cache_cap=CACHE_CAP,
                        kernels=True)
    eng.serve([Request(prompt=p[:16], max_new_tokens=2) for p in prompts],
              frames=frames[:, :16])
    torch.cuda.synchronize()
    dec0 = eng.decode_steps
    torch.cuda.reset_peak_memory_stats()
    moe_gmm.launches = decode_attn.launches = 0
    t0 = time.perf_counter()
    with _attn_tally() as tally, _logits_finite() as fin:
        out = eng.serve(reqs(), frames=frames)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"moe_gmm": moe_gmm.launches,
                "decode_attn": decode_attn.launches}
    steps = eng.decode_steps - dec0
    want = {"moe_gmm": 0, "decode_attn": steps * _attn_layers(cfg)}
    require(launches == want, run, f"launch counts {launches} != {want}")
    want = _attn_shapes(cfg, CACHE_CAP, steps)
    require(tally["shapes"] == want, run, f"decode_attn launches by (H, S) "
            f"{dict(tally['shapes'])} != expected {dict(want)}")
    require(all(len(r.out_tokens) == 32 for r in out), run,
            "a request did not get all its tokens")
    require(fin["finite"] and fin["calls"] == steps + 1, run,
            f"logits finite={fin['finite']} over {fin['calls']} calls")
    gate = _peak_gate(run, torch.cuda.max_memory_allocated() / 1e9 - other_gb,
                      params, (model, CACHE_CAP, frames.shape[1]))
    tokens = sum(len(r.out_tokens) for r in out)
    emit("serve_families", ok=True, run="static", **head, batch=SLOTS,
         prompt_len=128, frames=list(frames.shape), max_new_tokens=32,
         decode_steps=steps, wall_s=wall, tok_per_s=tokens / wall,
         launches=launches, logits_finite=fin["finite"], **gate)
    # The served batch's cache, prefilled again, for the frozen decode.
    kmodel = eng.model
    cache = kmodel.init_cache(SLOTS, CACHE_CAP, src_len=frames.shape[1],
                              per_slot_len=True)
    toks = torch.tensor(prompts, device="cuda")
    logits, _ = kmodel.prefill(params, {
        "tokens": toks, "frames": torch.from_numpy(frames).cuda()}, cache)
    tok = torch.argmax(logits[:, -1:, :cfg.vocab], dim=-1)
    frozen = torch.zeros(SLOTS, dtype=torch.bool, device="cuda")

    def step():
        lg = kmodel.decode_step(params, tok, cache, frozen)[0]
        torch.argmax(lg[:, :, :cfg.vocab], dim=-1).cpu()
    calls = _calls(tattn, "decode_attn_auto", step)
    require(len(calls) == _attn_layers(cfg), run,
            f"{len(calls)} decode_attn calls in a decode step")
    return step, calls[0], collections.Counter(tally["shapes"])


def _engine_pools(eng) -> list:
    """The slot pools of a colocated engine, tenant by tenant."""
    return list(getattr(eng, "pools", None) or (eng.pool_a, eng.pool_b))


def _lockstep_frozen(eng):
    """A lockstep decode step as the colocated engine runs it, every row of
    every tenant frozen (the served caches are left as they are): each
    tenant's decode, then each argmax copied to the host."""
    import torch
    pools = _engine_pools(eng)
    masks = [torch.zeros(SLOTS, dtype=torch.bool, device=p.device)
             for p in pools]

    def step():
        out = eng._step([p.params for p in pools], [p.tokens for p in pools],
                        [p.cache for p in pools], masks)
        for p, logits in zip(pools, out[0]):
            torch.argmax(logits[:, :, :p.model.cfg.vocab], dim=-1).cpu()
    return step


def _colocated_family(phase, moe, tenants, other_gb):
    """The served phi3.5-MoE beside family tenants on the card (kernel path,
    ``SLOTS`` slots, cache ``CACHE_CAP``): with one tenant in
    ``ColocatedContinuousEngine`` (no pairing: the family has no
    experts), with more in ``MultiTenantContinuousEngine``. ``moe`` and
    each of ``tenants``: a dict of ``model``, ``params``, ``reqs`` (a
    factory of its request stream), ``solo`` (the streams it emitted
    served alone) and ``solo_step_ms`` (its solo decode step's mean).
    Every tenant serves its own stream, after a one-request warm-up.
    Gates: every request complete; exact launch counts per tenant
    (``decode_attn`` once per attention layer of each tenant and lockstep
    step, told apart by (heads, head_dim) at the call sites, and by (H,
    S) for the run; ``moe_gmm`` once per MoE layer of phi3.5's decodes
    and prefills); finite logits of every pool; each tenant's stream its
    solo stream (the same kernels on the same batch shapes, and no
    decode drop: 8 rows top-2 fill at most 8 of an expert's 8 places);
    the peak beyond ``other_gb`` within 2 GB of the families' weights and
    every tenant's cache (``_peak_gate``). Printed: the serve numbers,
    the lockstep step's mean, p50 and p95 beside the sum of the tenants'
    solo step means, and a profile of one frozen lockstep step (busy ms,
    idle share). Returns phi3.5's launches of each kernel and each
    family's ``decode_attn`` launches, by arch."""
    from repro_torch.serving import (ColocatedContinuousEngine,
                                     EngineConfig,
                                     MultiTenantContinuousEngine)
    t0 = time.perf_counter()
    everyone = [moe] + tenants
    archs = [t["model"].cfg.arch_id for t in everyone]
    run = f"{phase}[colocated:{'+'.join(archs[1:])}]"
    config = EngineConfig(kernels=True)
    if len(tenants) == 1:
        eng = ColocatedContinuousEngine(
            moe["model"], tenants[0]["model"], moe["params"],
            tenants[0]["params"], batch_slots=SLOTS, cache_cap=CACHE_CAP,
            config=config)
    else:
        eng = MultiTenantContinuousEngine(
            [t["model"] for t in everyone], [t["params"] for t in everyone],
            batch_slots=SLOTS, cache_cap=CACHE_CAP, config=config)
    pools = _engine_pools(eng)
    warm = [_stream(t["model"].cfg, 1, 64, 64, 2, 2, seed=2)
            for t in everyone]
    if len(tenants) > 1:
        eng.serve(warm)
    else:
        eng.serve(*warm)
    reqs = [t["reqs"]() for t in everyone]
    pre_a = pools[0].prefills
    with _attn_tally() as tally:
        launches, calls, numbers = _serve_run(eng, list(zip(pools, reqs)))
    steps = calls["decode_steps"]
    cfgs = [p.model.cfg for p in pools]
    per_tenant = {a: tally["heads_dim"][(c.n_heads, c.head_dim)]
                  for a, c in zip(archs, cfgs) if _attn_layers(c)}
    want = {a: steps * _attn_layers(c) for a, c in zip(archs, cfgs)
            if _attn_layers(c)}
    require(per_tenant == want and len({(c.n_heads, c.head_dim)
                                        for c in cfgs if _attn_layers(c)})
            == len(want), run, f"decode_attn launches by tenant "
            f"{per_tenant} != expected {want}")
    want = {"decode_attn": steps * sum(_attn_layers(c) for c in cfgs),
            "moe_gmm": (steps + pools[0].prefills - pre_a)
            * cfgs[0].n_layers}
    require(launches == want, run, f"launch counts {launches} != {want}")
    want = sum((_attn_shapes(c, CACHE_CAP, steps) for c in cfgs),
               collections.Counter())
    require(tally["shapes"] == want, run, f"decode_attn launches by (H, S) "
            f"{dict(tally['shapes'])} != expected {dict(want)}")
    require(all(len(r.out_tokens) == r.max_new_tokens
                for rs in reqs for r in rs), run,
            "a request did not get all its tokens")
    for pool in pools:
        _finite_decode(run, pool, pool.params)
    same = {a: [list(r.out_tokens) for r in rs] == t["solo"]
            for a, rs, t in zip(archs, reqs, everyone)}
    gate = _peak_gate(run, numbers["max_memory_allocated_GB"] - other_gb,
                      [t["params"] for t in tenants],
                      *[(p.model, CACHE_CAP) for p in pools])
    solo_sum = sum(t["solo_step_ms"] for t in everyone)
    emit("serve_families", ok=True, run="colocated", tenant_archs=archs,
         engine=type(eng).__name__, **numbers, launches=launches,
         decode_attn_by_tenant=per_tenant, equals_solo=same, **gate,
         solo_step_ms_means=[t["solo_step_ms"] for t in everyone],
         solo_step_ms_sum=solo_sum,
         lockstep_over_solo_sum=numbers.get("step_ms_mean", 0) / solo_sum)
    require(all(same.values()), run, f"colocated streams differ from the "
            f"solo ones: {same}")
    _profile("lockstep_" + "+".join(archs[1:]), _lockstep_frozen(eng), 1)
    emit("serve_families", tenant_archs=archs,
         seconds=time.perf_counter() - t0)
    return ({"moe_gmm": launches["moe_gmm"],
             "decode_attn": per_tenant[archs[0]]},
            {a: n for a, n in per_tenant.items() if a != archs[0]})

DS_LAYERS, DS_MOE_LAYERS = 5, 2  # DeepSeek-V3 cut: 3 dense + 2 MoE layers
DS_SLICE = 32                    # experts per plain-version comparison


def _calls(module, name: str, run):
    """(args, kwargs) of every call of ``module.name`` while ``run()``
    runs; the kernels' launch counters are left as they were."""
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.moe_gmm import moe_gmm
    counts = (moe_gmm.launches, decode_attn.launches)
    fn, seen = getattr(module, name), []

    def keep(*args, **kw):
        seen.append((args, kw))
        return fn(*args, **kw)
    setattr(module, name, keep)
    try:
        run()
    finally:
        setattr(module, name, fn)
    moe_gmm.launches, decode_attn.launches = counts
    return seen


def _ds_gmm_check(call, flush):
    """``moe_gmm`` on a captured ``ops.moe_ffn`` call (the served layer's
    own expert leaves and its real buckets) against its plain version.
    The plain version upcasts every weight to fp32, so it runs over slices
    of ``DS_SLICE`` experts (the whole call's fp32 copies would not fit
    beside the weights); its time is the sum over the slices. Bound: the
    live experts' weights, x and y once each, and the group sizes."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_gmm import moe_gmm
    (buf, wg, wu, wd), kw = call[0][:4], call[1]
    gs = kw["group_sizes"]
    e, c, d = buf.shape
    f = wg.shape[-1]
    slices = [slice(e0, e0 + DS_SLICE) for e0 in range(0, e, DS_SLICE)]

    def plain():
        return [ref.moe_ffn_ref(buf[sl], wg[sl], wu[sl], wd[sl],
                                group_sizes=gs[sl]) for sl in slices]
    got = moe_gmm(buf, wg, wu, wd, group_sizes=gs)
    err = max(max_errs(got[sl], want)[0]
              for sl, want in zip(slices, plain()))
    dead_zero = bool((got[torch.arange(c, device="cuda")[None, :]
                          >= gs[:, None]] == 0).all())
    del got
    ms = time_ms(lambda: moe_gmm(buf, wg, wu, wd, group_sizes=gs), flush)
    plain_ms = time_ms(plain, flush, 5)
    live = int((gs > 0).sum())
    nbytes = ((live * 3 * d * f + 2 * buf.numel()) * buf.element_size()
              + e * 4)
    b_ms, b_by = bound(nbytes, 2 * 3 * d * f * int(gs.sum()))
    return {"shape": [e, c, d, f], "max_abs_err": err,
            "dead_rows_zero": dead_zero, "tol": 2e-2, "ms": ms,
            "plain_ms": plain_ms, "plain_over": f"{len(slices)} slices of "
            f"{DS_SLICE} experts", "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "live_experts": live,
            "rows": int(gs.sum()), "bytes": nbytes, "bound_share": b_ms / ms}


def phase_serve_deepseek():
    """Full-width DeepSeek-V3 cut to 5 layers (the 3 published dense layers
    and 2 MoE layers; bf16, seeded random weights) serving the serve
    phase's stream through ``ContinuousEngine(kernels=True)``, then
    through ``DistributedEngine`` over ``LocalGroup(4, cuda)`` (64 experts
    a rank, views of the served leaves) as "ep" and as "aurora". Runs
    last, after the phi3.5 model is freed. Gates: every request complete,
    finite logits, exact launch counts (``moe_gmm`` 2 per decode step and
    per prefill, x 4 rank bodies under EP; ``decode_attn`` 0: MLA decodes
    in plain PyTorch, as the reference does), the peak within 2 GB of the
    weights (EP: within 1 GB of the unsharded run's), ``moe_gmm`` within
    2e-2 of its plain version on the served E layer's leaves at a real
    decode step's buckets and at a 256-token prefill's, the two EP
    streams identical, and at the decode batch the EP layer within 2e-2
    of the unsharded kernel layer. Printed: weights GB, init s, step ms,
    TTFT, tok/s, prefill ms per bucket, ``moe_gmm`` ms beside its bound
    (unsharded decode and prefill buckets, one EP rank's decode bucket),
    a profile of a decode step, EP decode steps in alternated rounds and
    the phase's seconds. Returns the ``kernels`` row of ``moe_gmm`` at the
    decode bucket."""
    import torch
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.distributed import LocalGroup
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.models import moe as tm
    from repro_torch.models import transformer as tt
    from repro_torch.serving import (ContinuousEngine, DistributedEngine,
                                     EngineConfig)
    t_phase = time.perf_counter()
    phase = "serve_deepseek"
    torch.cuda.reset_peak_memory_stats()
    cfg = cut_depth(get_config("deepseek-v3-671b"), DS_LAYERS)
    require(tt.moe_layer_count(cfg) == DS_MOE_LAYERS, phase,
            f"{cfg.n_layers} layers hold {tt.moe_layer_count(cfg)} MoE "
            "layers")
    model = Model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = _nbytes(params)
    eng = ContinuousEngine(model, params, batch_slots=SLOTS,
                           cache_cap=CACHE_CAP,
                           config=EngineConfig(kernels=True))
    eng.serve(_stream(cfg, 1, 64, 64, 2, 2, seed=2))          # warm-up
    torch.cuda.synchronize()
    reqs = _stream(cfg, 10, 64, 200, 16, 64, seed=0)
    launches, calls, numbers = _serve_run(eng, [(eng, reqs)])
    require(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
            phase, "a request did not get all its tokens")
    _check_launches(phase, launches, calls, attn_layers=0,
                    moe_layers=DS_MOE_LAYERS)
    finite = _finite_decode(phase, eng, params)
    peak = numbers["max_memory_allocated_GB"]
    require(peak <= weight_bytes / 1e9 + 2.0, phase,
            f"peak {peak} GB, weights {weight_bytes / 1e9} GB + 2 GB allowed")
    streams = {"unsharded": [list(r.out_tokens) for r in reqs]}
    total = dict(launches)
    prefill_ms = _prefill_ms(model.with_kernels(), params, CACHE_CAP)
    emit(phase, ok=True, arch=cfg.arch_id, n_layers=cfg.n_layers,
         dense_layers=cfg.moe.first_dense_layers,
         depth_cut="3 dense + 2 MoE of 61 layers, every published width",
         dtype=cfg.dtype, weights_GB=weight_bytes / 1e9, init_s=init_s,
         slots=SLOTS, cache_cap=CACHE_CAP, admission="one-shot", **numbers,
         prefill_ms=prefill_ms, launches=launches, logits_finite=finite)

    # What the checks below run on: the first E layer's MoE input and
    # its ``moe_gmm`` buckets in a real decode step over the served cache
    # (every row frozen), and its buckets for the stream's longest prompt
    # in its 256-token bucket. The kernels run on the layer's own leaves.
    decode = _frozen_decode(eng)
    moe_args = _calls(tt, "moe_apply", decode)[0][0]
    dec_call = _calls(ops, "moe_ffn", decode)[0]
    prompt = max((r.prompt for r in reqs), key=len)
    toks = torch.tensor([[0] * (256 - len(prompt)) + [int(t) for t in prompt]],
                        device="cuda")
    kmodel = model.with_kernels()
    pre_call = _calls(ops, "moe_ffn", lambda: kmodel.prefill(
        params, {"tokens": toks}, kmodel.init_cache(1, CACHE_CAP)))[0]

    # Expert parallelism over 4 in-process ranks.
    fns = {"unsharded": decode}
    ep_layer = {}
    for impl in ("ep", "aurora"):
        run = f"{phase}[{impl}]"
        ep = DistributedEngine(model, params, batch_slots=SLOTS,
                               cache_cap=CACHE_CAP,
                               group=LocalGroup(4, "cuda"), moe_impl=impl,
                               config=EngineConfig(kernels=True))
        ep.serve(_stream(cfg, 1, 64, 64, 2, 2, seed=2))       # warm-up
        torch.cuda.synchronize()
        reqs = _stream(cfg, 10, 64, 200, 16, 64, seed=0)
        launches, calls, ep_numbers = _serve_run(ep, [(ep, reqs)])
        require(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
                run, "a request did not get all its tokens")
        _check_launches(run, launches, calls, attn_layers=0,
                        moe_layers=DS_MOE_LAYERS * ep.n_ep)
        ep_finite = _finite_decode(run, ep, params)
        ep_peak = ep_numbers["max_memory_allocated_GB"]
        require(ep_peak <= peak + 1.0, run, f"peak {ep_peak} GB, the "
                f"unsharded run's {peak} GB + 1 GB allowed")
        streams[impl] = [list(r.out_tokens) for r in reqs]
        for k in total:
            total[k] += launches[k]
        p, x = moe_args[0], moe_args[1]
        kc = kmodel.kernels
        y_ep, _ = tm.moe_apply_ep(p, x, cfg.moe, cfg.act, ep.model.pc, kc)
        y_u, _ = tm.moe_apply_kernel(p, x, cfg.moe, cfg.act, kc)
        ep_layer[impl] = max_errs(y_ep, y_u)[0]
        emit(phase, ok=True, run=impl, ranks=ep.n_ep,
             experts_per_rank=cfg.moe.n_experts // ep.n_ep, **ep_numbers,
             launches=launches, logits_finite=ep_finite,
             equals_unsharded_stream=streams[impl] == streams["unsharded"],
             decode_layer_vs_unsharded_max_abs_err=ep_layer[impl])
        fns[impl] = _frozen_decode(ep)
    same = streams["ep"] == streams["aurora"]
    emit(phase, ep_identical=same, ep_layer_vs_unsharded=ep_layer, tol=2e-2)
    require(same, phase, "the EP runs' streams differ from each other")
    require(all(v <= 2e-2 for v in ep_layer.values()), phase,
            f"EP layer against the unsharded kernel layer: {ep_layer}")

    # moe_gmm against its plain version and its bound: the unsharded
    # decode and prefill buckets, then one EP rank's decode bucket.
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    gmm = {"decode": _ds_gmm_check(dec_call, flush),
           "prefill256": _ds_gmm_check(pre_call, flush),
           "ep_rank_decode": _ds_gmm_check(
               _calls(ops, "moe_ffn", fns["aurora"])[0], flush)}
    del pre_call, flush
    for step, row in gmm.items():
        emit("timing", name="moe_gmm", arch=cfg.arch_id, step=step, **row)
    ok = all(r["max_abs_err"] <= 2e-2 and r["dead_rows_zero"]
             for r in gmm.values())
    require(ok, phase, f"moe_gmm against its plain version: {gmm}")
    _profile("deepseek_decode_step", decode, 10)
    _profile("deepseek_ep_aurora_decode_step", fns["aurora"], 10)
    rounds_ms, medians = _decode_rounds(fns)
    emit(phase, decode_step_ms_rounds=rounds_ms,
         decode_step_ms_median=medians,
         seconds=time.perf_counter() - t_phase)
    phase_dryrun_deepseek(cfg, params)
    return {"name": "moe_gmm", "route": "cuda", "arch": cfg.arch_id,
            "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
            "replaces": "src/repro/kernels/moe_gmm.py:112",
            "launches": total["moe_gmm"], **gmm["decode"]}


# -- training ---------------------------------------------------------------

TRAIN_ARCH = "phi3.5-moe-42b-a6.6b"
TRAIN_LAYERS = 2                 # full width, 2 of 32 layers
TRAIN_SEQ, TRAIN_STEPS = 4096, 10  # one row of the reference's train_4k
TRAIN_PEAK_GB = 45.0             # predicted before the first run (PERF.md)


def _train_parity(phase):
    """(a) one train step of each reduced arch (fp32, B 2, S 16, frames for
    an encoder-decoder) on the card and on the CPU from the same weights
    and batch. Gates: the loss within 1e-5 relative; each grad leaf and
    each updated param leaf within 1e-5 + 1e-4 x the CPU leaf's largest
    magnitude. Returns the worst error over its bound per arch."""
    import torch
    from repro_torch.bridge import map_tree, tree_leaves
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import Model, init_params
    from repro_torch.training import (AdamWConfig, SyntheticLMData,
                                      adamw_init, make_train_step)
    from repro_torch.training.loop import loss_and_grads, make_loss_fn

    def worst(got, want):
        ratio = 0.0
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            w = w.float()
            err = float((g.cpu().float() - w).abs().max())
            ratio = max(ratio, err / (1e-5 + 1e-4 * float(w.abs().max())))
        return ratio

    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        enc = cfg.is_encoder_decoder
        batch = next(SyntheticLMData(cfg.vocab, seq_len=16, batch=2, seed=0,
                                     frames_dim=cfg.frontend_dim if enc else 0,
                                     frames_len=16 if enc else 0))
        weights = init_params(cfg, seed=0, device="cpu")
        runs = {}
        for dev in ("cpu", "cuda"):
            model = Model(cfg, device=dev)
            params = map_tree(lambda t: t.clone().to(dev), weights)
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            loss, _, grads = loss_and_grads(make_loss_fn(model), params, b)
            opt_cfg = AdamWConfig()
            step = make_train_step(model, opt_cfg)
            params, _, metrics = step(params, adamw_init(params, opt_cfg), b)
            runs[dev] = (float(loss), float(metrics["loss"]), grads, params)
        cpu, card = runs["cpu"], runs["cuda"]
        rel = max(abs(card[i] - cpu[i]) / abs(cpu[i]) for i in (0, 1))
        out[arch] = {"loss_rel_err": rel,
                     "grad_err_over_bound": worst(card[2], cpu[2]),
                     "param_err_over_bound": worst(card[3], cpu[3])}
        require(rel <= 1e-5 and out[arch]["grad_err_over_bound"] <= 1.0
                and out[arch]["param_err_over_bound"] <= 1.0, phase,
                f"{arch}: card against CPU {out[arch]}")
    return out


def _train_loop_reduced(phase):
    """(b) the reference's MoE loss check on the card (reduced phi3.5-MoE,
    40 steps, lr 1e-3, warmup 10, batch 8 x 32, data seed 1): the last ce
    below the first, aux finite at every step; then a checkpoint round
    trip of its params and optimizer state, exact."""
    import shutil
    import torch
    from repro_torch.bridge import map_tree, tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.training import (AdamWConfig, SyntheticLMData,
                                      checkpoint_step, restore_checkpoint,
                                      save_checkpoint, train_loop)
    cfg = get_config(TRAIN_ARCH).reduced()
    data = SyntheticLMData(cfg.vocab, seq_len=32, batch=8, seed=1)
    t0 = time.perf_counter()
    state, hist = train_loop(Model(cfg, device="cuda"), data, steps=40,
                             opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=10),
                             log_every=1)
    loop_s = time.perf_counter() - t0
    ce = [h["ce"] for h in hist]
    require(len(hist) == 40 and ce[-1] < ce[0], phase,
            f"reduced loop: ce {ce[0]} -> {ce[-1]} over {len(hist)} steps")
    require(all(math.isfinite(h["aux"]) for h in hist), phase,
            "reduced loop: a non-finite aux")
    path = os.path.join(ROOT, "chiprun_out", "train_checkpoint")
    tree = {"params": state.params, "opt": state.opt}
    try:
        save_checkpoint(path, tree, step=state.step)
        back = restore_checkpoint(path, map_tree(torch.zeros_like, tree))
        same = all(a.dtype == b.dtype and a.device == b.device
                   and torch.equal(a, b) for a, b in
                   zip(tree_leaves(tree), tree_leaves(back)))
        require(same and checkpoint_step(path) == 40, phase,
                "checkpoint round trip not exact")
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return {"ce_first": ce[0], "ce_last": ce[-1], "aux_last": hist[-1]["aux"],
            "loop_s": loop_s, "checkpoint_exact": same}


def _train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one step: 6 x active params x tokens (attention and
    router projections, the top-k experts' FFNs, the LM head) plus causal
    attention, 6 x S^2 x heads x head_dim a layer and sequence (QK and PV,
    2 FLOPs a product, forward and backward, half the square); remat's
    recompute and the capacity buckets' padding not counted."""
    m = cfg.moe
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = 2 * d * h * hd + 2 * d * hkv * hd
    ffn = m.top_k * 3 * d * m.d_ff + d * m.n_experts
    active = cfg.n_layers * (attn + ffn) + d * (-(-cfg.vocab // 256) * 256)
    return (6 * active * batch * seq
            + cfg.n_layers * batch * 6 * seq ** 2 * h * hd)


def _train_full(phase):
    """(c) full-width phi3.5-MoE cut to 2 layers (bf16), remat, AdamW with
    fp32 moments (lr 1e-3, warmup 2), ``SyntheticLMData(seed=0)`` at batch
    1 x 4096, 10 steps through ``make_train_step``. Gates: loss and aux
    finite at every step, every grad leaf finite, every param leaf moved
    by step 1, the peak within 4 GB of ``TRAIN_PEAK_GB``. Printed: step
    ms (first, median), tokens/s, the model FLOPs' share of 989 TF/s, the
    split of a step between forward+backward and the optimizer (CUDA
    events), then a profile of one step."""
    import statistics
    import torch
    from repro_torch.bridge import tree_leaves
    from repro_torch.configs import InputShape, cut_depth, get_config
    from repro_torch.models import Model
    from repro_torch.roofline import model_flops
    from repro_torch.training import (AdamWConfig, SyntheticLMData,
                                      adamw_init, make_train_step)
    from repro_torch.training import loop
    cfg = cut_depth(get_config(TRAIN_ARCH), TRAIN_LAYERS)
    model = Model(cfg, device="cuda")
    data = SyntheticLMData(cfg.vocab, seq_len=TRAIN_SEQ, batch=1, seed=0)
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in next(data).items()} for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    params = model.init(0)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2)
    opt = adamw_init(params, opt_cfg)
    weights_gb = _nbytes(params) / 1e9
    opt_gb = _nbytes(opt) / 1e9
    before = [p.to("cpu", copy=True) for p in tree_leaves(params)]

    # The optimizer is timed and the grads screened where the step calls
    # it: events before and after, and every grad leaf's finiteness.
    marks, finite = [], []
    adamw = loop.adamw_update

    def timed(params, grads, state, cfg):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        finite.append(torch.stack([torch.isfinite(g).all()
                                   for g in tree_leaves(grads)]).all())
        ev[1].record()
        out = adamw(params, grads, state, cfg)
        ev[2].record()
        marks.append(ev)
        return out

    step = make_train_step(model, opt_cfg)
    steps_ms, metrics, starts = [], [], []
    loop.adamw_update = timed
    try:
        for i, batch in enumerate(batches):
            start = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3)
            starts.append(start)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                moved = [not torch.equal(p.cpu(), b) for p, b in
                         zip(tree_leaves(params), before)]
                del before
    finally:
        loop.adamw_update = adamw
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    fwd_bwd = [s.elapsed_time(ev[0]) for s, ev in zip(starts, marks)]
    opt_ms = [ev[1].elapsed_time(ev[2]) for ev in marks]
    require(all(math.isfinite(x) for m in metrics for x in m.values()),
            phase, f"non-finite loss or aux: {metrics}")
    require(all(bool(f) for f in finite), phase, "a non-finite grad leaf")
    require(all(moved), phase, f"{moved.count(False)} param leaves did not "
            "move at step 1")
    require(abs(peak_gb - TRAIN_PEAK_GB) <= 4.0, phase,
            f"peak {peak_gb} GB, predicted {TRAIN_PEAK_GB} +- 4 GB")
    med = statistics.median(steps_ms[1:])
    flops = _train_flops(cfg, 1, TRAIN_SEQ)
    out = {"arch": TRAIN_ARCH, "layers": TRAIN_LAYERS, "batch": 1,
           "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "weights_GB": weights_gb,
           "optimizer_state_GB": opt_gb, "peak_GB": peak_gb,
           "predicted_peak_GB": TRAIN_PEAK_GB, "step_ms": steps_ms,
           "first_step_ms": steps_ms[0], "median_step_ms": med,
           "tokens_per_s": TRAIN_SEQ / med * 1e3,
           "model_TFLOP_per_step": flops / 1e12,
           "bf16_peak_share": flops / (med * 1e-3) / h100().peak_flops,
           "roofline_model_TFLOP_per_step": model_flops(
               cfg, InputShape("train_1x4096", TRAIN_SEQ, 1, "train")) / 1e12,
           "flop_counts": "model_TFLOP_per_step (_train_flops): 6 x (the "
           "attention projections, router and top-k experts of each layer "
           "and the LM head at the padded vocab) x tokens, plus causal "
           "attention scores 6 x S^2 x H x D a layer; "
           "roofline_model_TFLOP_per_step (roofline.model_flops): 6 x "
           "active_param_count x tokens, which counts the embedding and "
           "the LM head at the unpadded vocab and the norms, and no "
           "attention scores",
           "fwd_bwd_ms_median": statistics.median(fwd_bwd[1:]),
           "optimizer_ms_median": statistics.median(opt_ms[1:]),
           "ce": [m["ce"] for m in metrics], "aux": [m["aux"] for m in metrics]}
    state = {"params": params, "opt": opt}

    def one_step():
        state["params"], state["opt"], _ = step(state["params"],
                                                state["opt"], batches[0])
    _profile("train_step", one_step, 1)
    phase_dryrun_train(cfg, state["params"], state["opt"], batches[0])
    return out


def _train_launcher(phase):
    """(d) ``python -m repro_torch.launch.train`` on the card in a
    subprocess (reduced phi3.5-MoE, 3 steps of 2 x 16, a checkpoint):
    exit 0, at most 3 JSON lines, the checkpoint written at step 3."""
    import shutil
    from repro_torch.training import checkpoint_step
    path = os.path.join(ROOT, "chiprun_out", "train_launch_checkpoint")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN_ARCH, "--reduced", "--steps", "3", "--batch", "2", "--seq",
           "16", "--checkpoint", path]
    t0 = time.perf_counter()
    try:
        run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=300, env=dict(os.environ, PYTHONPATH=SRC))
        rows = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
        require(run.returncode == 0, phase,
                f"launcher exit {run.returncode}: {run.stderr[-2000:]}")
        require(1 <= len(rows) <= 3, phase, f"launcher printed {rows}")
        require(checkpoint_step(path) == 3, phase, "launcher checkpoint")
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return {"json_lines": len(rows), "last": json.loads(rows[-1]),
            "seconds": time.perf_counter() - t0}


def phase_train():
    """Training on the card, run last (after DeepSeek-V3 is freed): (a)
    reduced parity of one train step, card against CPU, for the ten
    archs; (b) the reduced MoE loop and a checkpoint round trip; (c) full
    width phi3.5-MoE at 2 layers, batch 1 x 4096, 10 steps; (d) the train
    launcher in a subprocess. Training takes the reference's plain route:
    neither kernel's launch counter may move."""
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.moe_gmm import moe_gmm
    phase = "train"
    t_phase = time.perf_counter()
    moe_gmm.launches = decode_attn.launches = 0
    parity = _train_parity(phase)
    emit(phase, part="parity", archs=parity, tol="loss 1e-5 rel; leaves "
         "1e-5 + 1e-4 max|leaf|")
    emit(phase, part="reduced_loop", **_train_loop_reduced(phase))
    emit(phase, part="full_width", **_train_full(phase))
    emit(phase, part="launcher", **_train_launcher(phase))
    launches = {"moe_gmm": moe_gmm.launches,
                "decode_attn": decode_attn.launches}
    require(launches == {"moe_gmm": 0, "decode_attn": 0}, phase,
            f"training launched a kernel: {launches}")
    emit(phase, ok=True, launches=launches,
         seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# train_mesh: sharded training on the mesh rank program
# ---------------------------------------------------------------------------

TRAIN_MESH = (2, 2)              # (data, model): 4 thread ranks of the card
TRAIN_MESH_BATCH, TRAIN_MESH_SEQ = 2, 2048   # one row a data shard
TRAIN_MESH_STEPS = 5             # (c): bf16 steps, the first a warm-up
TRAIN_MESH_BF16_LAYERS = 2


def _no_drop(cfg):
    """``cfg`` with a capacity factor of E: no token is dropped, so an EP
    rank (capacity sized on its token slice) and the unsharded layer
    (sized on the batch) keep the same tokens."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


@contextlib.contextmanager
def _ep_aux(cfg, n: int):
    """The unsharded reference of an EP rank program: while on, the
    port's ``route`` takes its aux loss as the mean over ``n`` contiguous
    token shards, the EP layer's ``ep_mean`` of its ranks' aux (gates and
    choices stay the whole batch's)."""
    from repro_torch.models import moe
    route = moe.route

    def sharded(router_w, x, m):
        gates, idx, _ = route(router_w, x, m)
        return gates, idx, sum(route(router_w, c, m)[2]
                               for c in x.chunk(n)) / n
    moe.route = sharded if cfg.moe is not None else route
    try:
        yield
    finally:
        moe.route = route


def _worst(got, want) -> float:
    """The worst leaf's error over 1e-5 + 1e-4 x its largest magnitude."""
    from repro_torch.bridge import tree_leaves
    worst = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = g.float(), w.float().to(g.device)
        tol = 1e-5 + 1e-4 * float(w.abs().max())
        worst = max(worst, float((g - w).abs().max()) / tol)
    return worst


def _mesh_ranks(cfg, weights, batch, opt_cfg, impl: str = "ep",
                overlap: bool = False):
    """A ``ThreadMesh`` of ``TRAIN_MESH`` on the card, and each rank's
    state for the sharded step: its model, step, shards of ``weights``
    (a whole params tree on any device), zero AdamW moments, shards of
    ``batch`` (on the card) and their bytes. ``overlap``: the EP layers
    run the round-pipelined body."""
    import torch
    from repro_torch.bridge import map_tree, shard_params, shard_tensor
    from repro_torch.distributed import ThreadMesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.models import Model
    from repro_torch.sharding import input_sharding, make_pc, param_specs
    from repro_torch.training import adamw_init, make_train_step
    tm = ThreadMesh(MeshLayout(TRAIN_MESH, ("data", "model")), "cuda")
    b = batch["tokens"].shape[0]
    states = [None] * tm.layout.size

    def setup(rm):
        model = Model(cfg, device="cuda", pc=dataclasses.replace(make_pc(
            cfg, rm, impl, batch=b, cap=batch["tokens"].shape[1]),
            ep_overlap=overlap))
        params = map_tree(lambda t: t.to("cuda"), shard_params(
            weights, param_specs(cfg, rm), rm, rm.rank))
        spec = input_sharding(cfg, rm, b)
        shard = {k: shard_tensor(v, spec, rm, rm.rank).to("cuda")
                 for k, v in batch.items()}
        opt = adamw_init(params, opt_cfg)
        states[rm.rank] = {"step": make_train_step(model, opt_cfg),
                           "params": params, "opt": opt, "batch": shard,
                           "arg_bytes": dryrun.tree_bytes(
                               (params, opt, shard))}
    tm.run(setup)
    return tm, states


def _mesh_step(tm, states):
    """One sharded step on every rank; each rank's (metrics, collective
    bytes of the step)."""
    def one(rm):
        st = states[rm.rank]
        rm.collective_bytes = 0
        st["params"], st["opt"], m = st["step"](st["params"], st["opt"],
                                                st["batch"])
        return {k: float(v) for k, v in m.items()}, rm.collective_bytes
    return tm.run(one)


def _mesh_parity(cfg, weights, batch, opt_cfg):
    """One step unsharded on the card (``make_train_step``, under
    ``_ep_aux``; its updated params and moments kept on the host) and
    sharded on ``TRAIN_MESH``'s thread ranks, from the same weights (a
    host tree) and batch: (the loss's relative error, the worst ratio of
    the updated params and of each AdamW moment, the number of distinct
    losses the ranks report)."""
    import torch
    from repro_torch.bridge import map_tree, unshard_params
    from repro_torch.models import Model
    from repro_torch.sharding import param_specs
    from repro_torch.training import adamw_init, make_train_step
    model = Model(cfg, device="cuda")
    params = map_tree(lambda t: t.to("cuda", copy=True), weights)
    card = {k: v.to("cuda") for k, v in batch.items()}
    with _ep_aux(cfg, math.prod(TRAIN_MESH)):
        params, opt, m = make_train_step(model, opt_cfg)(
            params, adamw_init(params, opt_cfg), card)
    want = map_tree(lambda t: t.cpu(), (params, opt["m"], opt["v"]))
    want_loss = float(m["loss"])
    del params, opt, m
    gc.collect()
    torch.cuda.empty_cache()
    tm, states = _mesh_ranks(cfg, weights, batch, opt_cfg)
    res = _mesh_step(tm, states)
    losses = {r[0]["loss"] for r in res}
    specs = param_specs(cfg, tm.layout)
    ratios = []
    for i, w in enumerate(want):
        got = unshard_params(
            [(st["params"], st["opt"]["m"], st["opt"]["v"])[i]
             for st in states], specs, tm.layout)
        ratios.append(_worst(got, w))
        del got
    rel = max(abs(lo - want_loss) / abs(want_loss) for lo in losses)
    return rel, ratios, len(losses)


TRAP_TIMEOUT_S = 5.0             # the barrier's wait in the trap below


def _thread_backward_trap(phase):
    """Why thread ranks run one joint backward: two thread ranks of the
    card whose all_reduce has a per-rank backward that waits at the
    thread barrier, each thread calling backward on its own loss (CUDA
    runs every backward's nodes on one autograd thread, which the first
    waiting node blocks: the barrier times out after ``TRAP_TIMEOUT_S``),
    against ``RankMesh.all_reduce`` and ``RankMesh.grad``. Gate: the joint
    grads are right (3 on every element); the per-thread run's outcome is
    printed."""
    import torch
    from repro_torch.distributed import ThreadMesh
    from repro_torch.launch.mesh import MeshLayout
    layout = MeshLayout((1, 2), ("data", "model"))

    class PerRankAllReduce(torch.autograd.Function):
        @staticmethod
        def forward(ctx, rm, x):
            ctx.rm = rm
            return rm._reduce(x, ("model",))

        @staticmethod
        def backward(ctx, g):
            return None, ctx.rm._reduce(g, ("model",))

    def leaf(rm):
        return torch.full((4,), float(rm.rank + 1), device="cuda",
                          requires_grad=True)

    def per_thread(rm):
        x = leaf(rm)
        (PerRankAllReduce.apply(rm, x) * (rm.rank + 1)).sum().backward()
        return x.grad.tolist()

    def joint(rm):
        x = leaf(rm)
        y = rm.all_reduce(x, "model")
        return rm.grad((y * (rm.rank + 1)).sum(), [x])[0].tolist()

    out = {}
    for name, fn in (("per_thread", per_thread), ("joint", joint)):
        t0 = time.perf_counter()
        try:
            res, err = ThreadMesh(layout, "cuda",
                                  timeout=TRAP_TIMEOUT_S).run(fn), None
        except RuntimeError as e:
            res, err = None, repr(e.__cause__ or e)[:120]
        out[name] = {"grads": res, "error": err,
                     "seconds": time.perf_counter() - t0}
    require(out["joint"]["grads"] == [[3.0] * 4] * 2, phase,
            f"joint backward of two thread ranks: {out['joint']}")
    return out


def _train_mesh_reduced(phase):
    """(a) the ten reduced archs (fp32, B 4 x S 16, frames of 8 for an
    encoder-decoder, no token dropped) on ``TRAIN_MESH``'s thread ranks
    of the card against their unsharded card step: the loss within 1e-5
    relative, the updated params and both moments within 1e-5 + 1e-4 x
    each leaf's largest magnitude."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import init_params
    from repro_torch.training import AdamWConfig
    out = {}
    for arch in ARCH_IDS:
        cfg = _no_drop(get_config(arch).reduced())
        rng = np.random.default_rng(3)
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))}
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (4, 8, cfg.frontend_dim)).astype(np.float32))
        rel, ratios, n = _mesh_parity(cfg, init_params(cfg, 0, "cpu"),
                                      batch, AdamWConfig())
        out[arch] = {"loss_rel_err": rel, "params_over_bound": ratios[0],
                     "m_over_bound": ratios[1], "v_over_bound": ratios[2]}
        require(n == 1 and rel <= 1e-5 and max(ratios) <= 1.0, phase,
                f"{arch}: sharded against unsharded {out[arch]}")
    return out


def _train_mesh_full_fp32(phase):
    """(b) full-width phi3.5-MoE at 1 layer in fp32 (experts over data x
    model, 4 a rank), batch 2 x 2048, no token dropped: one sharded step
    against the unsharded one-card step, run first (only its updated
    params and moments are kept)."""
    import numpy as np
    import torch
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.models import init_params
    from repro_torch.training import AdamWConfig
    cfg = _no_drop(dataclasses.replace(cut_depth(get_config(TRAIN_ARCH), 1),
                                       dtype="float32"))
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (TRAIN_MESH_BATCH, TRAIN_MESH_SEQ)).astype(np.int32))}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    weights = init_params(cfg, 0, "cpu")
    rel, ratios, n = _mesh_parity(cfg, weights, batch, AdamWConfig())
    out = {"arch": TRAIN_ARCH, "layers": 1, "dtype": "float32",
           "batch": TRAIN_MESH_BATCH, "seq": TRAIN_MESH_SEQ,
           "mesh": TRAIN_MESH, "loss_rel_err": rel,
           "params_over_bound": ratios[0], "m_over_bound": ratios[1],
           "v_over_bound": ratios[2],
           "peak_GB": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t0}
    require(n == 1 and rel <= 1e-5 and max(ratios) <= 1.0, phase,
            f"full width fp32: sharded against unsharded {out}")
    return out


def _overlap_pair(cfg, weights, batch, opt_cfg):
    """Two sharded steps of ``cfg`` under Aurora's rounds on
    ``TRAIN_MESH``'s thread ranks, first through the synchronous EP body,
    then through the round-pipelined one, from the same ``weights`` (a
    host tree) and ``batch``: (the first steps' loss relative error, the
    worst ratio of the updated params and of each AdamW moment after the
    first step, the losses each run's ranks report, and each run's step
    ms, host clock to a synchronise)."""
    import torch
    from repro_torch.bridge import map_tree, unshard_params
    from repro_torch.sharding import param_specs
    kept, losses, ms = None, {}, {}
    ratios = []
    for overlap in (False, True):
        tm, states = _mesh_ranks(cfg, weights, batch, opt_cfg, "aurora",
                                 overlap=overlap)
        specs = param_specs(cfg, tm.layout)
        ms[overlap] = []
        for i in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = _mesh_step(tm, states)
            torch.cuda.synchronize()
            ms[overlap].append((time.perf_counter() - t1) * 1e3)
            if i:
                continue
            losses[overlap] = sorted({r[0]["loss"] for r in res})
            for j in range(3):
                got = unshard_params(
                    [(st["params"], st["opt"]["m"], st["opt"]["v"])[j]
                     for st in states], specs, tm.layout)
                if not overlap:
                    got = map_tree(lambda t: t.cpu(), got)
                    kept = (kept or []) + [got]
                else:
                    ratios.append(_worst(got, kept[j]))
                del got
        del tm, states
        gc.collect()
        torch.cuda.empty_cache()
    rel = abs(losses[True][0] - losses[False][0]) / abs(losses[False][0])
    return rel, ratios, losses, ms


def _train_mesh_overlap_full(phase):
    """(e) full-width phi3.5-MoE at 1 layer in fp32 (as ``(b)``: experts
    over data x model, batch 2 x 2048, no token dropped) under Aurora's
    rounds: one step through the round-pipelined EP body against the same
    step through the synchronous one. Gates: the loss within 1e-5
    relative, the updated params and both moments within 1e-5 + 1e-4 x
    each leaf's largest magnitude. Printed: both runs' step ms (the
    first step and a second)."""
    import numpy as np
    import torch
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.models import init_params
    from repro_torch.training import AdamWConfig
    cfg = _no_drop(dataclasses.replace(cut_depth(get_config(TRAIN_ARCH), 1),
                                       dtype="float32"))
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (TRAIN_MESH_BATCH, TRAIN_MESH_SEQ)).astype(np.int32))}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rel, ratios, losses, ms = _overlap_pair(
        cfg, init_params(cfg, 0, "cpu"), batch, AdamWConfig())
    out = {"arch": TRAIN_ARCH, "layers": 1, "dtype": "float32",
           "batch": TRAIN_MESH_BATCH, "seq": TRAIN_MESH_SEQ,
           "mesh": TRAIN_MESH, "moe_impl": "aurora",
           "loss_sync": losses[False], "loss_overlap": losses[True],
           "loss_rel_err": rel, "params_over_bound": ratios[0],
           "m_over_bound": ratios[1], "v_over_bound": ratios[2],
           "sync_step_ms": ms[False], "overlap_step_ms": ms[True],
           "peak_GB": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t0}
    require(len(losses[False]) == len(losses[True]) == 1 and rel <= 1e-5
            and max(ratios) <= 1.0, phase,
            f"full width: the pipelined step against the synchronous {out}")
    return out


def _train_mesh_overlap_reduced(phase):
    """(f) the reduced MoE archs (fp32, B 4 x S 16, no token dropped) on
    ``TRAIN_MESH``'s thread ranks: the round-pipelined step against the
    synchronous one under Aurora's rounds, at (e)'s tolerance."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import init_params
    from repro_torch.training import AdamWConfig
    out = {}
    for arch in ARCH_IDS:
        cfg = _no_drop(get_config(arch).reduced())
        if cfg.moe is None:
            continue
        rng = np.random.default_rng(3)
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))}
        rel, ratios, losses, ms = _overlap_pair(
            cfg, init_params(cfg, 0, "cpu"), batch, AdamWConfig())
        out[arch] = {"loss_rel_err": rel, "params_over_bound": ratios[0],
                     "m_over_bound": ratios[1], "v_over_bound": ratios[2],
                     "sync_step_ms": ms[False], "overlap_step_ms": ms[True]}
        require(len(losses[False]) == len(losses[True]) == 1
                and rel <= 1e-5 and max(ratios) <= 1.0, phase,
                f"{arch}: the pipelined step against the synchronous "
                f"{out[arch]}")
    return out


def _train_mesh_full_bf16(phase):
    """(c) full-width phi3.5-MoE at 2 layers in bf16 with remat, batch 2 x
    2048 on ``TRAIN_MESH``'s thread ranks, AdamW with the dry run's
    optimizer config (fp32 moments), ``TRAIN_MESH_STEPS`` steps. Gates:
    finite losses, rank 0's argument bytes and each step's collective
    bytes equal to the dry run's trace of rank 0 (``specs.
    lowering_args`` on ``meta``) to the byte. Printed: step ms (host clock
    to a synchronise), the median over the steps after the first, the
    device kernels a step (a profile of one step), and the card's peak
    beside 4 x the dry run's per-device total."""
    import statistics
    import torch
    from repro_torch.configs import InputShape, cut_depth, get_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.models import init_params
    from repro_torch.training import SyntheticLMData
    cfg = cut_depth(get_config(TRAIN_ARCH), TRAIN_MESH_BF16_LAYERS)
    shape = InputShape("train_2x2048", TRAIN_MESH_SEQ, TRAIN_MESH_BATCH,
                       "train")
    t0 = time.perf_counter()
    step, args, rm0 = specs.lowering_args(
        cfg, shape, MeshLayout(TRAIN_MESH, ("data", "model")))
    tr = dryrun.trace_step(step, args)
    want_args, want_coll = dryrun.tree_bytes(args), rm0.collective_bytes
    del step, args
    meta_s = time.perf_counter() - t0
    data = SyntheticLMData(cfg.vocab, seq_len=TRAIN_MESH_SEQ,
                           batch=TRAIN_MESH_BATCH, seed=0)
    batch = {k: torch.as_tensor(v) for k, v in next(data).items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    weights = init_params(cfg, 0, "cuda")
    tm, states = _mesh_ranks(cfg, weights, batch, specs.opt_config_for(cfg))
    del weights
    torch.cuda.empty_cache()
    held_gb = (torch.cuda.memory_allocated() - base) / 1e9
    steps_ms, metrics, colls = [], [], []
    for _ in range(TRAIN_MESH_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = _mesh_step(tm, states)
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t1) * 1e3)
        metrics.append(res[0][0])
        colls.append(res[0][1])
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    per_device = tr["temp_bytes"] + want_args
    out = {"arch": TRAIN_ARCH, "layers": TRAIN_MESH_BF16_LAYERS,
           "dtype": "bfloat16", "remat": True, "mesh": TRAIN_MESH,
           "batch": TRAIN_MESH_BATCH, "seq": TRAIN_MESH_SEQ,
           "steps": TRAIN_MESH_STEPS, "step_ms": steps_ms,
           "median_step_ms": statistics.median(steps_ms[1:]),
           "tokens_per_s": TRAIN_MESH_BATCH * TRAIN_MESH_SEQ
           / statistics.median(steps_ms[1:]) * 1e3,
           "loss": [m["loss"] for m in metrics],
           "rank0_argument_bytes": states[0]["arg_bytes"],
           "dryrun_argument_bytes": want_args,
           "step_collective_bytes": colls,
           "dryrun_collective_bytes": want_coll,
           "state_held_GB": held_gb, "peak_GB": peak_gb,
           "dryrun_per_device_total_GB": per_device / 1e9,
           "dryrun_4_devices_GB": 4 * per_device / 1e9,
           "dryrun_flops_per_device": tr["flops"], "meta_trace_s": meta_s}
    require(all(math.isfinite(m["loss"]) for m in metrics), phase,
            f"non-finite loss: {out['loss']}")
    require(states[0]["arg_bytes"] == want_args, phase,
            f"rank 0's arguments {states[0]['arg_bytes']} B, the dry run's "
            f"{want_args} B")
    require(all(c == want_coll for c in colls), phase,
            f"collective bytes a step {colls}, the dry run's {want_coll}")
    _profile("train_mesh_step", lambda: _mesh_step(tm, states), 1)
    del tm, states
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_mesh():
    """Sharded training on the mesh rank program, after ``train``: first
    the trap a per-thread backward falls into on the card
    (``_thread_backward_trap``); (a) reduced parity of one step for the
    ten archs, 4 thread ranks of the card against the unsharded card
    step; (b) full width in fp32 against the one-card step; (c) full
    width in bf16 with remat, timed and held against the dry run to the
    byte; (d) neither kernel's launch counter moves (training takes the
    plain route); (e) full width in fp32 and (f) the reduced MoE archs
    through the round-pipelined EP body against the synchronous one."""
    import torch
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.moe_gmm import moe_gmm
    phase = "train_mesh"
    t_phase = time.perf_counter()
    moe_gmm.launches = decode_attn.launches = 0
    emit(phase, part="thread_backward", timeout_s=TRAP_TIMEOUT_S,
         **_thread_backward_trap(phase))
    emit(phase, part="reduced_parity", mesh=TRAIN_MESH,
         archs=_train_mesh_reduced(phase),
         tol="loss 1e-5 rel; leaves 1e-5 + 1e-4 max|leaf|")
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase, part="full_width_fp32", **_train_mesh_full_fp32(phase))
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase, part="full_width_bf16", **_train_mesh_full_bf16(phase))
    t_overlap = time.perf_counter()
    emit(phase, part="overlap_full_width_fp32",
         tol="loss 1e-5 rel; leaves 1e-5 + 1e-4 max|leaf|",
         **_train_mesh_overlap_full(phase))
    emit(phase, part="overlap_reduced", mesh=TRAIN_MESH,
         archs=_train_mesh_overlap_reduced(phase),
         tol="loss 1e-5 rel; leaves 1e-5 + 1e-4 max|leaf|",
         seconds_e_and_f=time.perf_counter() - t_overlap)
    launches = {"moe_gmm": moe_gmm.launches,
                "decode_attn": decode_attn.launches}
    require(launches == {"moe_gmm": 0, "decode_attn": 0}, phase,
            f"sharded training launched a kernel: {launches}")
    emit(phase, ok=True, launches=launches,
         seconds=time.perf_counter() - t_phase)


# -- dry run ----------------------------------------------------------------

DRYRUN_PEAK_TOL = 0.10           # predicted peak against the card's


def _dryrun_args(part, cfg, shape, live):
    """(a) The dry run's argument bytes for ``cfg``'s step at ``shape``,
    traced on ``meta`` (``launch.dryrun.run_one``), against the summed
    bytes of the live trees ``live`` on the card: equal to the byte.
    Returns the dry run's record."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_one(cfg, shape)
    pred = rec["memory"]["argument_size_in_bytes"]
    live_b = dryrun.tree_bytes(live)
    emit("dryrun", part=part, gate="a_argument_bytes", arch=cfg.arch_id,
         n_layers=cfg.n_layers, shape=dataclasses.asdict(shape),
         predicted_bytes=pred, live_bytes=live_b, equal=pred == live_b,
         meta_trace_s=rec["trace_s"])
    require(pred == live_b, "dryrun", f"{part}: predicted argument bytes "
            f"{pred}, the live trees hold {live_b}")
    return rec


def _dryrun_step(part, rec, step, args, calls: int):
    """(b) and (c) for one plain-path call of ``step`` on the live
    ``args``. (b): the predicted arguments plus temp against
    ``max_memory_allocated`` over the call (peak stats reset first),
    less what else the card held before it (allocated bytes that are not
    the arguments): within ``DRYRUN_PEAK_TOL``. (c): ``FlopCounterMode``
    over a second call equals the ``meta`` trace's FLOPs. Printed: the
    tracker's high-water mark over that call on the card, and the median
    ms of ``calls`` more calls (CUDA events) beside the roofline terms."""
    import statistics
    import torch
    from repro_torch.launch import dryrun
    arg_b = dryrun.tree_bytes(args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = step(*args)
    torch.cuda.synchronize()
    del out
    peak = torch.cuda.max_memory_allocated()
    other = base - arg_b
    mem = rec["memory"]
    pred = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    measured = peak - other
    gap = measured / pred - 1.0
    card = dryrun.trace_step(step, args)
    ms = []
    for _ in range(calls):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        step(*args)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    roof = rec["roofline"]
    emit("dryrun", part=part, gate="b_peak_c_flops",
         predicted_peak_GB=pred / 1e9, measured_peak_GB=measured / 1e9,
         max_memory_allocated_GB=peak / 1e9, other_held_GB=other / 1e9,
         peak_gap=gap, tol=DRYRUN_PEAK_TOL,
         predicted_temp_GB=mem["temp_size_in_bytes"] / 1e9,
         measured_temp_GB=(peak - base) / 1e9,
         tracker_temp_on_card_GB=card["temp_bytes"] / 1e9,
         predicted_flops=rec["cost"]["flops"], card_flops=card["flops"],
         flops_equal=card["flops"] == rec["cost"]["flops"],
         step_ms_median=statistics.median(ms), step_ms=ms,
         roofline_ms={k: roof[k] * 1e3 for k in (
             "compute_s", "memory_s", "collective_s", "memory_floor_s")},
         dominant=roof["dominant"], useful_flop_ratio=roof[
             "useful_flop_ratio"], constants="H100 SXM data sheet")
    require(abs(gap) <= DRYRUN_PEAK_TOL, "dryrun", f"{part}: predicted "
            f"peak {pred} B, the card's {measured} B ({gap:+.4f})")
    require(card["flops"] == rec["cost"]["flops"], "dryrun", f"{part}: "
            f"FLOPs on the card {card['flops']}, predicted "
            f"{rec['cost']['flops']}")


def _dryrun_ep(model, params):
    """(d) ``ep_round_bytes`` against ``LocalGroup(4, cuda).copy_bytes``
    over phi3.5's steps on the kernel path (``moe_gmm``, ``block_c`` 128)
    with round-robin aurora rounds, synchronous and pipelined: the decode
    step at the serve phase's 8 slots (a source's capacity 2, 8 rows a
    rank) and a 1000-token prefill (capacity 40, 160 rows a rank: the
    synchronous FFN pads them to 256). Equal, to the byte."""
    import torch
    from repro_torch.distributed import LocalGroup
    from repro_torch.kernels.moe_gmm import align_capacity
    from repro_torch.models import KernelConfig, Model, ParallelContext
    from repro_torch.models import moe as tm
    from repro_torch.models.transformer import moe_layer_count
    from repro_torch.roofline import ep_round_bytes
    cfg, m = model.cfg, model.cfg.moe
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = []
    for overlap in (False, True):
        group = LocalGroup(4, "cuda")
        km = Model(cfg, device="cuda", kernels=KernelConfig(),
                   pc=ParallelContext(group=group, moe_impl="aurora",
                                      ep_overlap=overlap))
        for kind, n_tok in (("decode", SLOTS), ("prefill", 1000)):
            before = group.copy_bytes
            with torch.no_grad():
                if kind == "decode":
                    cache = km.init_cache(SLOTS, CACHE_CAP)
                    tok = torch.randint(0, cfg.vocab, (SLOTS, 1),
                                        device="cuda", generator=gen)
                    km.decode_step(params, tok, cache)
                else:
                    cache = km.init_cache(1, 1024)
                    tok = torch.randint(0, cfg.vocab, (1, n_tok),
                                        device="cuda", generator=gen)
                    km.prefill(params, {"tokens": tok}, cache)
            torch.cuda.synchronize()
            got = group.copy_bytes - before
            want = moe_layer_count(cfg) * ep_round_bytes(cfg, n_tok, 4)
            cap = tm.capacity(-(-n_tok // 4), m.top_k, m.n_experts,
                              m.capacity_factor)
            rows = cap if overlap else 4 * cap
            out.append({"run": "overlap" if overlap else "sync",
                        "step": kind, "tokens": n_tok, "capacity": cap,
                        "ffn_rows": rows, "ffn_pad_rows": align_capacity(
                            rows, KernelConfig().block_c) - rows,
                        "predicted_bytes": want, "copy_bytes": got,
                        "equal": got == want})
    emit("dryrun", part="phi3.5_ep", gate="d_ep_round_bytes", ranks=4,
         moe_impl="aurora (round robin)", runs=out)
    require(all(r["equal"] for r in out), "dryrun",
            f"EP round bytes against the group's copies: {out}")


def phase_dryrun_serve(model, params):
    """The dry run held against the card on phi3.5 as the serve phases
    run it (8 layers, bf16, 8 slots, cache 512), while it is loaded: (a)
    the decode step's argument bytes (params, a fresh cache, the tokens);
    (b) and (c) one plain-path decode step; (d) the EP round bytes on the
    kernel path."""
    import torch
    from repro_torch.configs import InputShape
    from repro_torch.launch import specs
    t0 = time.perf_counter()
    cfg = model.cfg
    shape = InputShape("serve_8x512", CACHE_CAP, SLOTS, "decode")
    _, _, _, serve_step = specs.make_step_fns(cfg, device="cuda")
    cache = model.init_cache(SLOTS, CACHE_CAP)
    tok = torch.randint(0, cfg.vocab, (SLOTS, 1), dtype=torch.int32,
                        device="cuda")
    rec = _dryrun_args("phi3.5", cfg, shape, (params, tok, cache))
    _dryrun_step("phi3.5", rec, serve_step, (params, tok, cache), 10)
    del cache
    _dryrun_ep(model, params)
    emit("dryrun", part="phi3.5", ok=True,
         seconds=time.perf_counter() - t0)


def phase_dryrun_deepseek(cfg, params):
    """(a) for DeepSeek-V3 as ``serve_deepseek`` loads it (3 dense + 2 MoE
    layers, bf16): its decode step's argument bytes at 8 slots and cache
    512 (the params, a fresh MLA cache, the tokens)."""
    import torch
    from repro_torch.configs import InputShape
    from repro_torch.models import init_cache
    t0 = time.perf_counter()
    cache = init_cache(cfg, SLOTS, CACHE_CAP, device="cuda")
    tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device="cuda")
    _dryrun_args("deepseek", cfg, InputShape("serve_8x512", CACHE_CAP,
                                             SLOTS, "decode"),
                 (params, tok, cache))
    emit("dryrun", part="deepseek", ok=True,
         seconds=time.perf_counter() - t0)


def phase_dryrun_train(cfg, params, opt, batch):
    """The dry run held against the ``train`` phase's step (phi3.5 at 2
    layers, bf16, AdamW with fp32 moments, 1 x 4096): (a) the argument
    bytes of the params, the optimizer state and the batch; (b) and (c)
    one call of the dry run's own train step (``specs.make_step_fns`` on
    the card) on those trees."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import specs
    t0 = time.perf_counter()
    shape = InputShape("train_1x4096", TRAIN_SEQ, 1, "train")
    _, train_step, _, _ = specs.make_step_fns(cfg, device="cuda")
    rec = _dryrun_args("train", cfg, shape, (params, opt, batch))
    _dryrun_step("train", rec, train_step, (params, opt, batch), 2)
    emit("dryrun", part="train", ok=True, seconds=time.perf_counter() - t0)



# ---------------------------------------------------------------------------
# serve_mesh: the reference's mesh layout as a rank program on the card
# ---------------------------------------------------------------------------

MESH_SHAPE = (1, 4)              # (data, model): 4 in-process ranks
MESH_LAYERS = 2                  # phi3.5's and qwen3-32b's bf16 depth
# Prompt tokens a row and greedy steps. With 128 cache positions a rank,
# the prefill fills ranks 0 and 1 and 124 of rank 2's positions, and the
# decode's writes (380-395) cross from rank 2's shard into rank 3's at
# step 4: every rank attends live positions, and the merge weighs them.
MESH_PROMPT, MESH_NEW = 380, 16
_MESH_RANK = threading.local()   # the rank a thread of ``ThreadMesh`` runs
MESH_LSE_SHAPES = ((8, 8, 2, 128, 128), (8, 16, 2, 128, 128),
                   (8, 32, 8, 128, 128), (8, 64, 8, 128, 128),
                   (8, 32, 32, 112, 128), (8, 16, 16, 64, 128))
# The SSM, hybrid and encoder-decoder families on the mesh: (arch, bf16
# depth, fp32 depth, the bf16 bound off an fp32 copy or None); an
# encoder-decoder's encoder is cut as its decoder, and it reads MESH_SRC
# seeded frames a row (32 source positions a rank). bf16 rounding alone
# puts zamba2 at 14 layers 0.0406 of its largest logit off an fp32 copy
# of its weights (the rank program 0.0437, H100), past the 2e-2 held
# against the unsharded model, so its rank program is held within 0.06
# of the fp32 copy, with layout faults planted to show the bound
# catches them (``_mesh_model``).
MESH_FAMILIES = (("mamba2-1.3b", 4, 2, None), ("zamba2-7b", 14, 7, 0.06),
                 ("seamless-m4t-large-v2", 4, 2, None))
MESH_SRC = 128


def _attn_lse_timing(q, k, v, valid, flush):
    """``decode_attn`` with its log-sum-exp output on q (B, H, D) over k/v
    (B, S, Hkv, D): its ms beside the plain version's (with the LSE) and
    the memory-efficient SDPA kernel's with ``compute_log_sumexp`` (K/V
    repeated to H heads beforehand, the fill levels as an additive bias),
    and its bound (the live K and V, q, the output and the LSE once
    each, the fill levels)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attn import decode_attn
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    ms = time_ms(lambda: decode_attn(q, k, v, valid, return_lse=True), flush)
    plain = time_ms(lambda: ref.decode_attn_ref(q, k, v, valid,
                                                return_lse=True), flush)
    kt = k.transpose(1, 2).repeat_interleave(h // hkv, 1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(h // hkv, 1).contiguous()
    live = torch.arange(s, device="cuda")[None, :] < valid[:, None]
    bias = torch.where(live, 0.0, -torch.inf).to(q.dtype)[:, None, None, :]
    bias = bias.expand(b, h, 1, s).contiguous()
    qq = q[:, :, None].contiguous()
    lib = time_ms(lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
        qq, kt, vt, bias, True), flush)
    n_valid = int(valid.sum())
    nbytes = ((2 * n_valid * hkv * d + 2 * q.numel()) * q.element_size()
              + b * 4 + b * h * 4)
    b_ms, b_by = bound(nbytes, 4 * h * d * n_valid)
    return {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "shape": [b, h, hkv, d, s],
            "valid_len": valid.tolist(), "bytes": nbytes,
            "bound_share": b_ms / ms}


def _lse_parity():
    """``decode_attn`` with the LSE output against its plain version at the
    per-rank shapes (B, H, Hkv, D, S) of ``MESH_LSE_SHAPES`` (bf16; fill
    levels 0, 1, partial and full: a shard with no live position has LSE
    -inf on both): the output within 2e-2, the LSE within 1e-5; and with
    a null LSE: the same output bit for bit, within 2e-2 of the plain
    version. Returns the errors."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attn import decode_attn
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = []
    for b, h, hkv, d, s in MESH_LSE_SHAPES:
        q = torch.randn((b, h, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((b, s, hkv, d), generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn((b, s, hkv, d), generator=gen,
                        device="cuda").bfloat16()
        valid = torch.tensor([0, 1, 37, s, 64, 0, s - 1, 100][:b],
                             dtype=torch.int32, device="cuda")
        got, lse = decode_attn(q, k, v, valid, return_lse=True)
        want, want_lse = ref.decode_attn_ref(q, k, v, valid, return_lse=True)
        plain_route = decode_attn(q, k, v, valid)
        empty = valid == 0
        inf_ok = bool(torch.isneginf(lse[empty]).all()
                      and torch.isneginf(want_lse[empty]).all())
        lse_err = float((lse[~empty] - want_lse[~empty]).abs().max())
        rec = {"shape": [b, h, hkv, d, s], "valid_len": valid.tolist(),
               "max_abs_err": max_errs(got, want)[0],
               "lse_max_abs_err": lse_err, "empty_rows_neg_inf": inf_ok,
               "null_lse_bitwise_equal": bool(torch.equal(plain_route, got)),
               "null_lse_err_vs_plain": max_errs(plain_route, want)[0]}
        out.append(rec)
        require(rec["max_abs_err"] <= 2e-2 and lse_err <= 1e-5 and inf_ok
                and rec["null_lse_bitwise_equal"]
                and rec["null_lse_err_vs_plain"] <= 2e-2, "serve_mesh",
                f"decode_attn with LSE against its plain version: {rec}")
    return out


def _mesh_rollout(cfg, shards, layout, prompts, forced=None, kernels=True,
                  frames=None):
    """The rank program over ``ThreadMesh(layout, cuda)``: each rank's
    ``Model`` on its ``shards[r]``, a prefill of ``prompts`` (B, P) (and of
    an encoder-decoder's ``frames`` (B, S_src, frontend_dim), each rank
    its rows) into a fresh cache of ``CACHE_CAP`` positions, then
    ``MESH_NEW`` decode steps fed ``forced`` (B, MESH_NEW) tokens, or
    greedy when None. Returns rank 0's logits (prefill, then each step's)
    and tokens, the host ms of the prefill and of each step (every rank
    synchronised), and each rank's collective bytes."""
    import torch
    from repro_torch.bridge import shard_tensor
    from repro_torch.distributed import ThreadMesh
    from repro_torch.models import Model
    from repro_torch.sharding import input_sharding, make_pc
    b = prompts.shape[0]
    src = 0 if frames is None else frames.shape[1]
    inputs = {"tokens": prompts} if frames is None else {
        "tokens": prompts, "frames": frames}
    clock = {}

    def body(rm):
        _MESH_RANK.rank = rm.rank
        with torch.no_grad():
            model = Model(cfg, device="cuda", pc=make_pc(
                cfg, rm, batch=b, cap=CACHE_CAP,
                src_len=src)).with_kernels(kernels)
            cache = model.init_cache(b, CACHE_CAP, src_len=src)
            spec = input_sharding(cfg, rm, b)
            mine = {k: shard_tensor(v, spec, rm, rm.rank)
                    for k, v in inputs.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = model.prefill(shards[rm.rank], mine, cache)
            outs, steps = [logits[:, -1:]], []
            tok = logits[:, -1:, :cfg.vocab].argmax(-1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for i in range(MESH_NEW):
                fed = tok if forced is None else forced[:, i:i + 1]
                logits, _ = model.decode_step(shards[rm.rank], fed, cache)
                outs.append(logits)
                tok = logits[:, :, :cfg.vocab].argmax(-1)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                steps.append((t2 - t1) * 1e3)
                t1 = t2
            if rm.rank == 0:
                clock["prefill_ms"] = (t1 - t0) * 1e3 - sum(steps)
                clock["step_ms"] = steps
            toks = torch.cat([o[:, -1:, :cfg.vocab].argmax(-1)
                              for o in outs], 1)
            return (outs if rm.rank == 0 else None), toks, \
                rm.collective_bytes

    res = ThreadMesh(layout, "cuda").run(body)
    return res[0][0], res[0][1], clock, [r[2] for r in res]


def _unsharded_rollout(model, params, prompts, new, forced=None,
                       frames=None):
    """The unsharded model: a prefill (of ``frames`` too for an
    encoder-decoder) and ``new`` decode steps, fed ``forced`` (B, new)
    tokens or greedy when None. Returns its logits (the prefill's last
    position, then each step's) and tokens."""
    import torch
    inputs = {"tokens": prompts} if frames is None else {
        "tokens": prompts, "frames": frames}
    with torch.no_grad():
        cache = model.init_cache(prompts.shape[0], CACHE_CAP,
                                 src_len=0 if frames is None
                                 else frames.shape[1])
        logits, _ = model.prefill(params, inputs, cache)
        outs = [logits[:, -1:]]
        tok = logits[:, -1:, :model.cfg.vocab].argmax(-1)
        for i in range(new):
            if forced is not None:
                tok = forced[:, i:i + 1]
            logits, _ = model.decode_step(params, tok, cache)
            outs.append(logits)
            tok = logits[:, :, :model.cfg.vocab].argmax(-1)
    toks = torch.cat([o[:, -1:, :model.cfg.vocab].argmax(-1) for o in outs],
                     1)
    return outs, toks


@contextlib.contextmanager
def _captured(module, name: str, out: list):
    """Record the arguments of rank 0's first call of ``module.name`` (the
    mesh's kernel call sites) while the block runs, so a kernel row times
    the same shard in every run."""
    fn = getattr(module, name)

    def capture(*args, **kw):
        if not out and getattr(_MESH_RANK, "rank", None) == 0:
            out.append((args, kw))
        return fn(*args, **kw)
    setattr(module, name, capture)
    try:
        yield out
    finally:
        setattr(module, name, fn)


def _planted_faults():
    """Layout faults planted by swapping a function of the rank program
    for the length of one run: (name, module, attribute, stand-in)."""
    from repro_torch.models import attention as tattn
    from repro_torch.models import ssm as tssm
    merge, gathered = tattn.merge_partials, tssm._gathered

    def merge_alike(out, lse, pc):     # every shard weighed 1/n
        return merge(out, lse.new_zeros(lse.shape), pc)

    def gathered_reversed(pc, local, n):   # the ranks' blocks reversed
        if local.shape[-1] == n:
            return local
        return gathered(pc, local.flip(-1), n).flip(-1)
    return (("LSE merge weighs the shards alike", tattn, "merge_partials",
             merge_alike),
            ("SSM gathers take the ranks reversed", tssm, "_gathered",
             gathered_reversed))


def _mesh_model(phase, label, cfg, model, params, rows, flush, tol,
                median=False, frames=None, vs_fp32=None, greedy=True):
    """One arch through the rank program at ``MESH_SHAPE`` (full width, the
    kernels), held against the unsharded ``model``: the unsharded greedy
    stream is fed to the rank program (teacher forcing), whose logits must
    lie within ``tol`` of the unsharded largest logit; with ``greedy``
    the rank program's own greedy stream is compared too (first
    divergence printed, rounding may part them: not gated). A control
    measures how far the unsharded
    model's own plain path (no kernels) lies from its kernel path on the
    same forced tokens: the spread that rounding alone gives this model.
    With ``median``, ``tol`` holds the median over every (row, step) of
    the logits' error instead of the largest: a near-tied top-2 choice
    that flips under bf16 rounding moves one row at one step by far more
    than the rounding (the control's rows too), while a layout fault
    moves them all. The two
    rank-program runs are the main path: the kernel counters are set to 0
    before them and must read the exact launches after them
    (``decode_attn`` once per attention layer, rank and decode step, over
    its 128-position shard with the LSE; ``moe_gmm`` once per MoE layer,
    rank and call). An encoder-decoder also reads ``frames``. With
    ``vs_fp32`` (a bf16 model that bf16 rounding alone moves further
    than ``tol`` from exact) the gate is instead the rank program's
    distance from an fp32 copy of the same weights, fed the same tokens,
    within that fixed bound; the unsharded model's own distance from the
    copy and the error against it are printed. Each of
    ``_planted_faults`` is then run through the rank program in turn and
    must land past that bound: the gate tells a layout fault from the
    rounding. With
    ``rows`` (a list): (a) rank 0's argument bytes for a decode step at 8
    slots and cache 512 (an encoder-decoder's cross K/V of the dry run's
    ``SRC_LEN`` frames) against the dry run's ``lowering_args`` on the
    same mesh, to the byte, (b) the collective bytes of one plain-path
    decode step on the thread transport against the counting transport's
    trace of it, and the kernel rows at rank 0's shapes, each within 2e-2
    of its plain version, added to ``rows``."""
    import torch
    from repro_torch.bridge import shard_params
    from repro_torch.configs import InputShape
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.models import attention as tattn
    from repro_torch.models import transformer as tt
    from repro_torch.sharding import param_specs
    t_phase = time.perf_counter()
    layout = MeshLayout(MESH_SHAPE, ("data", "model"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shards = [shard_params(params, param_specs(cfg, layout), layout, r)
              for r in range(layout.size)]
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(5)
    prompts = torch.randint(1, cfg.vocab, (SLOTS, MESH_PROMPT),
                            generator=gen, device="cuda")
    want, want_toks = _unsharded_rollout(model.with_kernels(), params,
                                         prompts, MESH_NEW, frames=frames)
    attn_calls, gmm_calls = [], []
    decode_attn.launches = moe_gmm.launches = 0
    with _captured(tattn, "decode_attn_auto", attn_calls), \
            _captured(kops, "moe_ffn", gmm_calls):
        got, _, clock, _ = _mesh_rollout(cfg, shards, layout, prompts,
                                         forced=want_toks[:, :-1],
                                         frames=frames)
        stream = (_mesh_rollout(cfg, shards, layout, prompts,
                                frames=frames)[1] if greedy else None)
    launches = {"decode_attn": decode_attn.launches,
                "moe_gmm": moe_gmm.launches}
    n_moe = tt.moe_layer_count(cfg)
    runs = 2 if greedy else 1
    expect = {"decode_attn": runs * MESH_NEW * _attn_layers(cfg)
              * layout.size,
              "moe_gmm": runs * (MESH_NEW + 1) * n_moe * layout.size}
    require(launches == expect, phase, f"{label}: launches {launches} != "
            f"{expect}")
    def rel(a, b):
        """Each step's (B,) row errors over its largest logit."""
        return [(g.float() - w.float()).abs().amax((1, 2))
                / w.float().abs().max() for g, w in zip(a, b)]
    row_errs = rel(got, want)
    errs = [float(e.max()) for e in row_errs]
    control_rows = rel(_unsharded_rollout(model, params, prompts, MESH_NEW,
                                          forced=want_toks[:, :-1],
                                          frames=frames)[0], want)
    control = [float(e.max()) for e in control_rows]
    err_median = float(torch.cat(row_errs).median())
    control_median = float(torch.cat(control_rows).median())
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    same = diverge = None
    if greedy:
        same = torch.equal(stream, want_toks)
        if not same:
            col = (stream != want_toks).any(0).nonzero()
            diverge = int(col[0]) if col.numel() else None
    out = dict(arch=cfg.arch_id, label=label, mesh=list(MESH_SHAPE),
               n_layers=cfg.n_layers, encoder_layers=cfg.n_encoder_layers,
               src_len=0 if frames is None else frames.shape[1],
               dtype=cfg.dtype, slots=SLOTS,
               prompt=MESH_PROMPT, new=MESH_NEW, cache_cap=CACHE_CAP,
               cache_per_rank=CACHE_CAP // layout.shape["model"],
               shard_s=shard_s, launches=launches,
               teacher_forced_err_of_max_logit=max(errs),
               err_by_step=errs, tol=tol,
               control_plain_vs_kernel_unsharded=max(control),
               control_by_step=control, err_median=err_median,
               control_median=control_median, greedy_identical=same,
               first_divergence_step=diverge,
               mesh_prefill_ms=clock["prefill_ms"],
               mesh_step_ms_median=sorted(clock["step_ms"])[
                   len(clock["step_ms"]) // 2])
    gated = err_median if median else max(errs)
    out["gated"] = "median" if median else "max"
    ok = gated <= tol
    exact = None
    if vs_fp32 is not None:
        from repro_torch.bridge import map_tree
        from repro_torch.models import Model
        exact = _unsharded_rollout(
            Model(dataclasses.replace(cfg, dtype="float32"), device="cuda"),
            map_tree(lambda t: t.float(), params), prompts, MESH_NEW,
            forced=want_toks[:, :-1], frames=frames)[0]
        out["unsharded_vs_fp32"] = max(float(e.max())
                                       for e in rel(want, exact))
        gated = out["rank_program_vs_fp32"] = max(float(e.max())
                                                  for e in rel(got, exact))
        out["gated"] = "rank program vs fp32 copy"
        out["tol"] = tol = vs_fp32
        ok = gated <= tol
    emit(phase, **out)
    require(finite and ok, phase,
            f"{label}: teacher-forced logits off by {gated} of the largest "
            f"logit ({out['gated']}; {tol} allowed), finite={finite}")
    if exact is not None:
        held = decode_attn.launches, moe_gmm.launches
        for name, module, attr, stand_in in _planted_faults():
            real = getattr(module, attr)
            setattr(module, attr, stand_in)
            try:
                bad = _mesh_rollout(cfg, shards, layout, prompts,
                                    forced=want_toks[:, :-1],
                                    frames=frames)[0]
            finally:
                setattr(module, attr, real)
            err = max(float(e.max()) for e in rel(bad, exact))
            emit(phase, label=label, planted_fault=name,
                 rank_program_vs_fp32=err, bound=tol)
            require(not err <= tol, phase, f"{label}: the planted fault "
                    f"{name!r} reads {err}, within the bound {tol}")
        decode_attn.launches, moe_gmm.launches = held
        del exact, bad
    if rows is None:
        return

    # (a) argument bytes; (b) collective bytes of one plain decode step.
    shape = InputShape("serve_8x512", CACHE_CAP, SLOTS, "decode")
    src = specs.SRC_LEN if cfg.is_encoder_decoder else 0
    step, args, rm = specs.lowering_args(model.cfg, shape, layout)
    pred_args = dryrun.tree_bytes(args)
    dryrun.trace_step(step, args)
    pred_coll = rm.collective_bytes
    live = {}

    def one_step(rmesh):
        from repro_torch.bridge import shard_tensor
        from repro_torch.models import Model
        from repro_torch.sharding import input_sharding, make_pc
        with torch.no_grad():
            m = Model(model.cfg, device="cuda", pc=make_pc(
                model.cfg, rmesh, batch=SLOTS, cap=CACHE_CAP, src_len=src))
            cache = m.init_cache(SLOTS, CACHE_CAP, src_len=src)
            tok = shard_tensor(prompts[:, :1].to(torch.int32),
                               input_sharding(model.cfg, rmesh, SLOTS),
                               rmesh, rmesh.rank)
            if rmesh.rank == 0:
                live["args"] = dryrun.tree_bytes(
                    (shards[0], tok, cache))
            before = rmesh.collective_bytes
            m.decode_step(shards[rmesh.rank], tok, cache)
            if rmesh.rank == 0:
                live["coll"] = rmesh.collective_bytes - before
    from repro_torch.distributed import ThreadMesh
    ThreadMesh(layout, "cuda").run(one_step)
    require(live["args"] == pred_args, phase, f"{label}: rank 0's argument "
            f"bytes {live['args']}, the dry run's {pred_args}")
    require(live["coll"] == pred_coll, phase, f"{label}: thread transport "
            f"collective bytes {live['coll']}, counting transport's "
            f"{pred_coll}")

    # The kernel rows at the rank's shapes, on captured calls.
    if attn_calls:
        (q, k, v, valid), _ = attn_calls[0]
        valid = valid.to(torch.int32).reshape(-1)
        err = max_errs(decode_attn(q, k, v, valid, return_lse=True)[0],
                       tattn.decode_attn_ref(q, k, v, valid))[0]
        require(err <= 2e-2, phase, f"{label}: decode_attn at rank 0's "
                f"shard off its plain version by {err}")
        rows.append({"name": "decode_attn", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
                     "replaces": "src/repro/kernels/decode_attn.py:91",
                     "arch": f"{cfg.arch_id} (mesh 1x4, rank 0's shard, "
                             "LSE)",
                     "launches": launches["decode_attn"], "max_abs_err": err,
                     **_attn_lse_timing(q, k, v, valid, flush)})
    if gmm_calls:
        (x, wg, wu, wd), kw = gmm_calls[0]
        gs = kw["group_sizes"]
        from repro_torch.kernels import ref
        err = max_errs(moe_gmm(x, wg, wu, wd, act=kw["act"], group_sizes=gs),
                       ref.moe_ffn_ref(x, wg, wu, wd, kw["act"], gs))[0]
        require(err <= 2e-2, phase, f"{label}: moe_gmm at rank 0's experts "
                f"off its plain version by {err}")
        ms = time_ms(lambda: moe_gmm(x, wg, wu, wd, act=kw["act"],
                                     group_sizes=gs), flush)
        plain = time_ms(lambda: ref.moe_ffn_ref(x, wg, wu, wd, kw["act"],
                                                gs), flush, 5)
        e, c, d = x.shape
        f = wg.shape[-1]
        live_e = int((gs > 0).sum())
        nbytes = ((live_e * 3 * d * f + 2 * x.numel()) * x.element_size()
                  + e * 4)
        b_ms, b_by = bound(nbytes, 2 * 3 * d * f * int(gs.sum()))
        rows.append({"name": "moe_gmm", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
                     "replaces": "src/repro/kernels/moe_gmm.py:112",
                     "arch": f"{cfg.arch_id} (mesh 1x4, rank 0's experts)",
                     "launches": launches["moe_gmm"], "max_abs_err": err,
                     "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None,
                     "shape": [e, c, d, f], "group_sizes": gs.tolist()})
    emit(phase, arch=cfg.arch_id, label=label, argument_bytes=live["args"],
         argument_bytes_dry_run=pred_args,
         collective_bytes_decode_step=live["coll"],
         collective_bytes_counting=pred_coll,
         seconds=time.perf_counter() - t_phase)


def _cut_params(cfg, params, n: int):
    """``params`` of ``cfg`` as those of ``cut_depth(cfg, n)``: each
    segment's stacked leaves cut to the cut config's count (views; the
    rank shards are made from them)."""
    from repro_torch.bridge import map_tree
    from repro_torch.configs import cut_depth
    from repro_torch.models import transformer as tt
    segs = tt.segments_of(cut_depth(cfg, n))
    require([s.kinds for s in segs] == [s.kinds for s in tt.segments_of(
        cfg)[:len(segs)]], "serve_mesh", "the cut changes the segments")
    return {**params, "segments": tuple(
        map_tree(lambda t, c=s.count: t[:c], seg)
        for s, seg in zip(segs, params["segments"]))}


def phase_serve_mesh(model, params):
    """``serve_mesh``: the reference's mesh layout as the rank program on
    4 in-process ranks of one card (a (1, 4) mesh: tensor parallelism,
    the experts over (data, model), the cache's sequence over ``model``)
    at full width: phi3.5-MoE in bf16 at ``MESH_LAYERS`` layers (its
    params are the loaded model's first layers, cut into 4 rank shards;
    the capacity factor raised
    to 8.0 on both sides, so neither the unsharded dispatch nor the
    ranks' drop a token and the two are comparable), then in fp32 at 2
    layers, then qwen3-32b in bf16 at ``MESH_LAYERS`` of 64 layers
    (head-parallel
    dense), then each of ``MESH_FAMILIES`` in bf16 and in fp32 at its
    depths (mamba2: every leaf and cache shard of its Mamba2 blocks;
    zamba2: two uses of the shared attention block among them;
    SeamlessM4T: the encoder over ``MESH_SRC`` seeded frames a row and
    the cross K/V over the source sequence); each made, held and freed
    here but the loaded model. Prompts
    of ``MESH_PROMPT`` tokens put live positions on every rank's shard.
    First ``decode_attn``'s LSE output against its plain version at the
    per-rank shapes. phi3.5's bf16 logits are gated at 2e-2 on the median
    of their (row, step) errors, not the largest: bf16 rounds the sharded
    sums differently from the unsharded products, and a token whose top-2
    experts are near-tied can then take another expert, which moves its
    logits by far more than the rounding, as the control's own kernel and
    plain paths part. The fp32 runs hold the same layout within the repo's
    fp32 logit tolerance of 1e-4, and qwen3 and the families (no routing)
    within the bf16 tolerance of 2e-2; where bf16 rounding alone puts the
    unsharded family model further than that from an fp32 copy of its
    weights (zamba2 at 14 layers), the rank program is held within a
    fixed bound of the fp32 copy that planted layout faults must exceed
    (``MESH_FAMILIES``, ``_mesh_model``). Returns the kernel rows."""
    import torch
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.models import Model
    phase = "serve_mesh"
    t0 = time.perf_counter()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    emit(phase, part="lse_parity", checks=_lse_parity())
    rows = []
    cfg = model.cfg
    cfg8 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    cut = cut_depth(cfg8, MESH_LAYERS)
    _mesh_model(phase, f"phi3.5 bf16, {MESH_LAYERS} layers (cf 8.0)", cut,
                Model(cut, device="cuda"), _cut_params(cfg8, params,
                                                       MESH_LAYERS),
                rows, flush, tol=2e-2, median=True)
    gc.collect()
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(cfg8, n_layers=2, dtype="float32")
    fmodel = Model(f32, device="cuda")
    fparams = fmodel.init(0)
    _mesh_model(phase, "phi3.5 fp32, 2 layers (cf 8.0)", f32, fmodel,
                fparams, None, flush, tol=1e-4)
    del fparams, fmodel
    gc.collect()
    torch.cuda.empty_cache()
    qcfg = cut_depth(get_config("qwen3-32b"), MESH_LAYERS)
    qmodel = Model(qcfg, device="cuda")
    qparams = qmodel.init(0)
    _mesh_model(phase, "qwen3-32b bf16", qcfg, qmodel, qparams, rows, flush,
                tol=2e-2)
    del qparams, qmodel
    gc.collect()
    torch.cuda.empty_cache()
    _mesh_families(phase, rows, flush)
    emit(phase, ok=True, seconds=time.perf_counter() - t0)
    return rows


def _mesh_families(phase, rows, flush):
    """``MESH_FAMILIES`` through ``_mesh_model``, each in bf16 (its kernel
    rows added to ``rows``, held against an fp32 copy where its entry
    gives a bound; its greedy stream, which bf16 rounding may part, left
    out) and in fp32 (its greedy stream compared), each model made and
    freed here."""
    import torch
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.models import Model
    gen = torch.Generator(device="cuda").manual_seed(9)
    for arch, depth, f32_depth, bound in MESH_FAMILIES:
        for n, dtype, tol in ((depth, "bfloat16", 2e-2),
                              (f32_depth, "float32", 1e-4)):
            full = get_config(arch)
            cfg = dataclasses.replace(
                cut_depth(full, n), dtype=dtype,
                n_encoder_layers=min(n, full.n_encoder_layers))
            model = Model(cfg, device="cuda")
            params = model.init(0)
            frames = (torch.randn((SLOTS, MESH_SRC, cfg.frontend_dim),
                                  generator=gen, device="cuda")
                      if cfg.is_encoder_decoder else None)
            bf16 = dtype == "bfloat16"
            label = (f"{arch} {'bf16' if bf16 else 'fp32'}, {n} layers"
                     + (f" + {n} encoder" if frames is not None else ""))
            _mesh_model(phase, label, cfg, model, params,
                        rows if bf16 else None, flush, tol=tol,
                        frames=frames, vs_fp32=bound if bf16 else None,
                        greedy=not bf16)
            del params, model, frames
            gc.collect()
            torch.cuda.empty_cache()


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py runs from the root of a checkout of the repo "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    smi = phase_device()
    phase_build()
    errs = phase_parity()
    phase_reference()
    model, params, eng, launches, solo, streams = phase_serve()
    chunked = phase_serve_chunked(model, params)
    launches = {k: launches[k] + chunked[k] for k in launches}
    rows = phase_timing(model, params, eng, launches, errs)
    phase_profile(eng)
    import torch
    del eng                           # the one-shot engine's cache
    torch.cuda.empty_cache()
    colocated, engines = phase_serve_colocated(model, params, solo)
    phase_profile_lockstep(engines)
    del engines                       # tenants B and C
    gc.collect()                      # instrumented engines hold cycles
    torch.cuda.empty_cache()
    replicated, spec, monitor = phase_serve_replicated(
        model, params, streams, solo)
    chaos = phase_chaos(model, params, streams, spec, monitor)
    gc.collect()                      # the chaos engine's injector cycle
    torch.cuda.empty_cache()
    traced = phase_telemetry(model, params, streams)
    ep = phase_serve_ep(model, params, streams, solo, monitor,
                        solo["max_memory_allocated_GB"])
    legacy = phase_legacy_and_examples(model, params)
    for r in rows:
        r["launches"] += sum(part[r["name"]] for part in (
            colocated, replicated, chaos, traced, ep, legacy))
        r["arch"] = model.cfg.arch_id
    dense_rows, colocated_moe = phase_serve_dense(model, params, streams)
    family_rows, family_moe = phase_serve_families(model, params, streams,
                                                   solo)
    for r in rows:
        r["launches"] += colocated_moe[r["name"]] + family_moe[r["name"]]
    rows += dense_rows + family_rows
    phase_dryrun_serve(model, params)
    rows += phase_serve_mesh(model, params)
    # The phi3.5 model, its params and engines go before DeepSeek-V3's
    # ~53 GB of weights are made.
    del model, params, monitor, spec
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    require(held < 1.0, "serve_deepseek", f"{held} GB still allocated "
            "after the phi3.5 phases")
    rows.append(phase_serve_deepseek())
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    require(held < 1.0, "train", f"{held} GB still allocated after "
            "serve_deepseek")
    phase_train()
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_mesh()
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "arch",
                           "shape", "launches", "max_abs_err", "ms",
                           "plain_ms", "bound_ms", "bound_by",
                           "library_ms")} for r in rows]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
