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
   0, 1 and S), at ragged edges, and at small fp32 shapes.
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
14. serve_deepseek, run last, after the phi3.5 model, params and engines
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

Phase 4 also serves reduced DeepSeek-V3 (fp32, D + E, 4 experts top-2,
sigmoid, shared expert) through the kernels and the plain path (streams
identical), and at capacity factor 8.0 unsharded and through
``DistributedEngine`` over ``LocalGroup(4, cuda)`` as "ep" and "aurora"
(streams equal the unsharded one). It also serves reduced phi3.5-MoE
widened to 8 experts (cf 8.0) through ``DistributedEngine`` over
``LocalGroup(4, cuda)``: "ep", "aurora" (round robin, and rounds adopted
from a trace), the overlap, and a ``ChaosHarness`` loss of rank 3 that
rebuilds the group over 2 ranks; kernel streams equal plain ones and all
equal the unsharded stream. The
parity phase holds ``moe_gmm`` at one EP rank's shapes too: (4, 8, 4096)
and (4, 2, 4096) in bf16.

The parity phase also holds ``moe_gmm`` at replicated group sizes and with
NaN-poisoned experts (NaN exactly in a live poisoned group's live rows,
zeros elsewhere in it and in a dead poisoned group). Then a ``{"kernels":
[...]}`` line (``moe_gmm`` at phi3.5's decode bucket and at DeepSeek-V3's,
``decode_attn``) and, last, the ``{"ok": true, ...}`` line. Nothing of JAX
is imported.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12         # dense tensor-core bf16
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


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the bf16 tensor-core rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
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
    return results


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


def phase_timing(model, params, eng, launches, errs):
    """Each kernel at the serve phase's decode shapes, on layer 0's tensors;
    then ``moe_gmm`` at the batch-1 prefill buckets, on timing lines of
    their own (the ``kernels`` line keeps the decode shapes)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attn import decode_attn
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
    ms = time_ms(lambda: decode_attn(q, k, v, valid), flush)
    plain = time_ms(lambda: ref.decode_attn_ref(q, k, v, valid), flush)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)             # (B, Hkv, S, D)
    mask = (torch.arange(CACHE_CAP, device="cuda")[None, :]
            < valid[:, None])[:, None, None, :]
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True), flush)
    n_valid = int(valid.sum())
    nbytes = ((2 * n_valid * cfg.n_kv_heads * cfg.head_dim + 2 * q.numel())
              * q.element_size() + SLOTS * 4)
    b_ms, b_by = bound(nbytes, 4 * cfg.n_heads * cfg.head_dim * n_valid)
    rows.append({"name": "decode_attn", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
                 "replaces": "src/repro/kernels/decode_attn.py:91",
                 "launches": launches["decode_attn"],
                 "max_abs_err": errs["decode_attn"], "ms": ms,
                 "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": lib,
                 "shape": [SLOTS, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                           CACHE_CAP],
                 "valid_len": valid.tolist(), "bytes": nbytes})
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

DS_LAYERS, DS_MOE_LAYERS = 5, 2  # DeepSeek-V3 cut: 3 dense + 2 MoE layers
DS_SLICE = 32                    # experts per plain-version comparison


def _first_call(module, name: str, run):
    """(args, kwargs) of the first call of ``module.name`` while ``run()``
    runs; the kernels' launch counters are left as they were."""
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.moe_gmm import moe_gmm
    counts = (moe_gmm.launches, decode_attn.launches)
    fn, seen = getattr(module, name), []

    def keep(*args, **kw):
        if not seen:
            seen.append((args, kw))
        return fn(*args, **kw)
    setattr(module, name, keep)
    try:
        run()
    finally:
        setattr(module, name, fn)
    moe_gmm.launches, decode_attn.launches = counts
    return seen[0]


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
    moe_args = _first_call(tt, "moe_apply", decode)[0]
    dec_call = _first_call(ops, "moe_ffn", decode)
    prompt = max((r.prompt for r in reqs), key=len)
    toks = torch.tensor([[0] * (256 - len(prompt)) + [int(t) for t in prompt]],
                        device="cuda")
    kmodel = model.with_kernels()
    pre_call = _first_call(ops, "moe_ffn", lambda: kmodel.prefill(
        params, {"tokens": toks}, kmodel.init_cache(1, CACHE_CAP)))

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
               _first_call(ops, "moe_ffn", fns["aurora"]), flush)}
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
    return {"name": "moe_gmm", "route": "cuda", "arch": cfg.arch_id,
            "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
            "replaces": "src/repro/kernels/moe_gmm.py:112",
            "launches": total["moe_gmm"], **gmm["decode"]}


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
    for r in rows:
        r["launches"] += sum(part[r["name"]] for part in (
            colocated, replicated, chaos, traced, ep))
        r["arch"] = model.cfg.arch_id
    # The phi3.5 model, its params and engines go before DeepSeek-V3's
    # ~53 GB of weights are made.
    del model, params, monitor, spec
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    require(held < 1.0, "serve_deepseek", f"{held} GB still allocated "
            "after the phi3.5 phases")
    rows.append(phase_serve_deepseek())
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
