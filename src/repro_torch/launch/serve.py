"""Serving driver of the port: single-model or colocated dual-model, static
batch or continuous batching over a Poisson stream.

  python -m repro_torch.launch.serve --arch phi4-mini-3.8b --kernels \
      --batch 8 --prompt-len 128 --max-new-tokens 32 --cache-cap 512
  python -m repro_torch.launch.serve --arch gemma3-27b --reduced \
      --device cpu --kernels --batch 3 --cache-cap 32
  python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --kernels \
      --n-layers 8 --batch 8 --prompt-len 128 --max-new-tokens 32 \
      --cache-cap 512 --arrival-rate 0.5 --num-requests 8
  python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --reduced \
      --device cpu --arrival-rate 0.5 --num-requests 6 --batch 3 \
      --cache-cap 32 --kernels
  python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --reduced \
      --device cpu --colocate-with phi4-mini-3.8b --kernels
  python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --reduced \
      --device cpu --colocate-with mamba2-1.3b --kernels --batch 2 \
      --cache-cap 32 --arrival-rate 0.5 --prefill-chunk 4

  python -m repro_torch.launch.serve --arch deepseek-v3-671b --reduced \
      --device cpu --kernels --batch 3 --cache-cap 32 --num-requests 4 \
      --arrival-rate 0.5
  python -m repro_torch.launch.serve --arch zamba2-7b --reduced \
      --device cpu --kernels --batch 3 --cache-cap 32 --num-requests 4 \
      --arrival-rate 0.5 --prefill-chunk 4
  python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 \
      --reduced --device cpu --kernels --batch 2 --cache-cap 32

  python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --reduced \
      --device cpu --arrival-rate 0.5 --prefill-chunk 4 --prefill-pool 2 \
      --step-budget 9 --ttft-slo 12
  python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --reduced \
      --device cpu --colocate-with phi3.5-moe-42b-a6.6b --kernels \
      --arrival-rate 0.5 --prefill-chunk 4 --replan-interval 8
  python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --reduced \
      --device cpu --experts 8 --mesh 4 --overlap --kernels --batch 2 \
      --cache-cap 32 --num-requests 4 --arrival-rate 0.5
  torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch phi3.5-moe-42b-a6.6b --reduced --device cpu --experts 8 \
      --mesh 4 --kernels --batch 2 --cache-cap 32 --num-requests 4 \
      --arrival-rate 0.5

The counterpart of ``python -m repro.launch.serve``. Without
``--arrival-rate`` it serves one static batch of ``--batch`` requests
through ``ServingEngine`` (with ``--colocate-with``, two batches in
lockstep through ``ColocatedEngine``); the flags that only the continuous
engines read (chunked admission, SLOs, re-planning, telemetry, ``--mesh``)
then refuse. ``--arrival-rate λ`` switches to the continuous engines, with
Exp(λ) inter-arrival gaps in decode-step units. ``--colocate-with ARCH``
serves a second model (weights from seed 1) beside the first: when both
are MoE models with one expert count, with the expert pairing that
``AuroraPlanner.plan_colocated`` picks from synthetic traces of both
models, and ``--replan-interval N`` re-plans it from the live routing
counts every N lockstep decode steps, adopting a plan that is predicted
faster by more than ``--replan-threshold``; beside a dense model there is
no pairing to plan, and ``--replan-interval`` refuses. ``--prefill-chunk``,
``--step-budget``, ``--prefill-pool`` and ``--bucket-policy`` configure
chunked admission;
``--ttft-slo``/``--tpot-slo`` declare a ``TenantSpec`` (p95 targets in
engine steps) and switch admission to ``EdfAdmission`` over the same chunk
and budget. ``--kernels`` serves through the hand-written CUDA
kernels (their plain PyTorch versions on ``--device cpu``). ``--n-layers``
cuts the depth of a full-width config so its weights fit one card; it
takes MoE layers first, so DeepSeek-V3's 3 leading dense layers stay
(``configs.cut_depth``). DeepSeek-V3 (MLA) refuses ``--prefill-chunk``,
as the reference does, and so does an encoder-decoder (SeamlessM4T),
which serves the static batch only, on seeded frames of ``--prompt-len``
positions (the reference's convention). ``--colocate-with`` takes any
arch but SeamlessM4T, static or continuous: mamba2, zamba2 and qwen2-vl
serve beside the first model with their own caches (an SSM conv window
and state, a hybrid's shared-block KV, qwen2-vl's M-RoPE over token
positions) and, having no experts, with no pairing, so
``--replan-interval`` refuses beside them. SeamlessM4T raises ValueError
there: the colocated engines pass no frames to its encoder (the reference
fails with KeyError: 'frames'). ``--mesh`` refuses every model without
experts.
``--trace-out BASE`` records telemetry and writes BASE.jsonl (spans and
events) and BASE.trace.json (Chrome trace-event JSON, for Perfetto) on
exit; ``--metrics-out PATH`` writes the final metrics snapshot as JSON.
Both are written on every exit path, Ctrl-C included.
``--mesh N`` serves expert-parallel over N ranks (``DistributedEngine``,
or ``DistributedColocatedEngine`` with ``--colocate-with``): under
``torchrun`` each process is one rank of a ``torch.distributed`` group
(N must be the world size; NCCL on the card, gloo on the CPU), otherwise
N in-process ranks on ``--device``; the launcher prints which.
``--moe-impl`` picks the monolithic all-to-all (``ep``) or Aurora's
permutation rounds (``aurora``, the default, planned from a synthetic
trace), ``--overlap`` the round-pipelined dispatch, ``--experts E``
overrides the expert count (reduced configs have 4).
Weights are random, from seed 0.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--colocate-with", default=None,
                    help="serve a second model beside --arch (any arch "
                         "but an encoder-decoder; planner-chosen pairing "
                         "when both are MoE)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the layer count (full widths are kept)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--cache-cap", type=int, default=64)
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="requests per decode step (Poisson); enables "
                         "continuous batching (default: one static batch)")
    ap.add_argument("--num-requests", type=int, default=12,
                    help="stream length for --arrival-rate mode")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: absorb at most N prompt tokens "
                         "per engine step")
    ap.add_argument("--step-budget", type=int, default=None,
                    help="per-step token budget: decode always runs, "
                         "leftover feeds the FIFO prefix of due prefill "
                         "chunks")
    ap.add_argument("--prefill-pool", type=int, default=1,
                    help="keep up to K chunked prefills in flight "
                         "(requires --prefill-chunk)")
    ap.add_argument("--bucket-policy", default="pow2",
                    help="prefill pad-length policy: pow2 | exact | step:K")
    ap.add_argument("--replan-interval", type=int, default=None,
                    help="colocated mode: re-plan the expert pairing from "
                         "live routing stats every N decode steps")
    ap.add_argument("--replan-threshold", type=float, default=0.02,
                    help="min relative predicted-time improvement before a "
                         "re-plan is applied")
    ap.add_argument("--ttft-slo", type=float, default=None,
                    help="p95 TTFT target in engine steps: declares a "
                         "TenantSpec (stamps per-request deadlines) and "
                         "switches admission to EDF")
    ap.add_argument("--tpot-slo", type=float, default=None,
                    help="p95 TPOT target in engine steps (declared on the "
                         "TenantSpec next to --ttft-slo)")
    ap.add_argument("--kernels", action="store_true",
                    help="serve through the CUDA kernel path (sort-based "
                         "MoE dispatch + moe_gmm, decode_attn)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", type=int, default=None,
                    help="serve expert-parallel over N ranks: the torchrun "
                         "world (N must equal it) or N in-process ranks "
                         "on --device")
    ap.add_argument("--moe-impl", default=None, choices=["ep", "aurora"],
                    help="--mesh dispatch: monolithic all-to-all (ep) or "
                         "scheduled permutation rounds (aurora, default)")
    ap.add_argument("--overlap", action="store_true",
                    help="--mesh: round-pipelined dispatch (expert FFN "
                         "chunks overlap in-flight rounds)")
    ap.add_argument("--experts", type=int, default=None,
                    help="override the MoE expert count (reduced configs "
                         "have 4, which rarely divides a mesh)")
    ap.add_argument("--trace-out", default=None, metavar="BASE",
                    help="record telemetry and write BASE.jsonl (structured "
                         "spans + events) and BASE.trace.json (Chrome "
                         "trace-event JSON: open in Perfetto) on exit")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the final metrics snapshot as JSON on exit "
                         "(also on Ctrl-C)")
    args = ap.parse_args(argv)
    if args.mesh is None and (args.overlap or args.moe_impl is not None):
        # Without a mesh these flags would silently serve the one-device
        # path while the user believes they measured EP dispatch.
        raise SystemExit("--overlap/--moe-impl configure the distributed "
                         "EP dispatch; add --mesh N (or drop them)")
    if args.arrival_rate is None:
        continuous_only = [
            flag for flag, on in (
                ("--prefill-chunk", args.prefill_chunk is not None),
                ("--step-budget", args.step_budget is not None),
                ("--prefill-pool", args.prefill_pool != 1),
                ("--ttft-slo", args.ttft_slo is not None),
                ("--tpot-slo", args.tpot_slo is not None),
                ("--replan-interval", args.replan_interval is not None),
                ("--mesh", args.mesh is not None),
                ("--trace-out", args.trace_out is not None),
                ("--metrics-out", args.metrics_out is not None)) if on]
        if continuous_only:
            # The static engines read none of these: serving without them
            # would measure something else than the user asked for.
            raise SystemExit(f"{'/'.join(continuous_only)} configure the "
                             "continuous engines; add --arrival-rate")

    telemetry = None
    if args.trace_out or args.metrics_out:
        from repro_torch.serving import Telemetry
        telemetry = Telemetry()
    # The flush runs on every exit path (clean return, SystemExit, Ctrl-C),
    # so a run killed mid-stream still leaves its trace and metrics.
    try:
        return _serve(args, telemetry)
    except KeyboardInterrupt:
        print("\ninterrupted")
        return 130
    finally:
        _flush_telemetry(telemetry, args)


def _flush_telemetry(telemetry, args) -> None:
    if telemetry is None:
        return
    if args.trace_out:
        telemetry.write_jsonl(args.trace_out + ".jsonl")
        telemetry.write_chrome_trace(args.trace_out + ".trace.json")
        print(f"trace: {args.trace_out}.jsonl + {args.trace_out}.trace.json"
              f" (open the .trace.json in Perfetto / chrome://tracing)")
    if args.metrics_out:
        import json
        with open(args.metrics_out, "w") as f:
            json.dump(telemetry.snapshot(), f, indent=2, sort_keys=True)
        print(f"metrics snapshot: {args.metrics_out}")


def _serve(args, telemetry) -> int:

    from repro_torch.configs import cut_depth, get_config
    from repro_torch.models import Model
    from repro_torch import serving as tserving
    from repro_torch.serving import (ContinuousEngine, EdfAdmission,
                                     EngineConfig, TenantSpec,
                                     poisson_requests)

    if args.ttft_slo is not None or args.tpot_slo is not None:
        tenant = TenantSpec(name=args.arch, ttft_p95=args.ttft_slo,
                            tpot_p95=args.tpot_slo)
        config = EngineConfig(
            prefill_len=args.prompt_len,
            admission=EdfAdmission(
                chunk=args.prefill_chunk or args.prompt_len,
                budget=args.step_budget, bucket_policy=args.bucket_policy),
            prefill_pool=args.prefill_pool, kernels=args.kernels,
            tenants=(tenant,), telemetry=telemetry)
        print(f"SLO targets (engine steps): ttft_p95<="
              f"{args.ttft_slo if args.ttft_slo is not None else 'none'} "
              f"tpot_p95<="
              f"{args.tpot_slo if args.tpot_slo is not None else 'none'} "
              "-> EDF admission")
    else:
        config = EngineConfig(prefill_len=args.prompt_len,
                              prefill_chunk=args.prefill_chunk,
                              step_token_budget=args.step_budget,
                              bucket_policy=args.bucket_policy,
                              prefill_pool=args.prefill_pool,
                              kernels=args.kernels, telemetry=telemetry)

    device = args.device
    group = None
    if args.mesh is not None:
        from repro_torch.launch.mesh import local_device, make_ep_group
        device = local_device(args.device)
        group = make_ep_group(args.mesh, device)

    def load(arch: str):
        cfg = get_config(arch)
        if args.reduced:
            cfg = cfg.reduced()
        if args.n_layers is not None:
            cfg = cut_depth(cfg, args.n_layers)
        if args.experts is not None:
            if cfg.moe is None:
                raise SystemExit(f"{arch} has no MoE layers to widen")
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, n_experts=args.experts))
        return cfg, Model(cfg, device=device)

    cfg, model = load(args.arch)
    params = model.init(0)
    rng = np.random.default_rng(0)
    if args.colocate_with is not None:
        return _serve_colocated(args, config, cfg, model, params, load, rng,
                                group)
    if args.arrival_rate is None:
        return _serve_static(args, cfg, model, params, rng)
    if args.replan_interval is not None:
        raise SystemExit("--replan-interval needs --colocate-with")
    kw = dict(batch_slots=args.batch, cache_cap=args.cache_cap,
              config=config)
    if group is not None:
        eng = _distributed(args, cfg, group, tserving.DistributedEngine,
                           model, params, **kw)
    else:
        eng = ContinuousEngine(model, params, **kw)
    reqs = poisson_requests(rng, args.num_requests, args.arrival_rate,
                            cfg.vocab, args.prompt_len,
                            max(1, args.max_new_tokens // 2),
                            args.max_new_tokens)
    for i, r in enumerate(eng.serve(reqs)):
        print(f"req {i} (t={r.arrival:.1f}): {r.out_tokens}")
    total = sum(len(r.out_tokens) for r in reqs)
    print(f"{total} tokens in {eng.decode_steps} decode steps "
          f"({total / max(eng.decode_steps, 1):.2f} tok/step, "
          f"{args.batch} slots)")
    return 0


def _serve_static(args, cfg, model, params, rng) -> int:
    """One static batch of ``--batch`` random prompts through
    ``ServingEngine``, as the reference's default path; an encoder-decoder
    gets seeded (batch, prompt_len, frontend_dim) frames beside them."""
    from repro_torch.serving import Request, ServingEngine
    eng = ServingEngine(model, params, batch_slots=args.batch,
                        cache_cap=args.cache_cap, kernels=args.kernels)
    reqs = [Request(prompt=list(rng.integers(1, cfg.vocab, args.prompt_len)),
                    max_new_tokens=args.max_new_tokens)
            for _ in range(args.batch)]
    frames = None
    if cfg.is_encoder_decoder:
        frames = rng.standard_normal(
            (args.batch, args.prompt_len, cfg.frontend_dim),
            dtype=np.float32)
    for i, r in enumerate(eng.serve(reqs, frames=frames)):
        print(f"req {i}: {r.out_tokens}")
    total = sum(len(r.out_tokens) for r in reqs)
    print(f"{total} tokens in {eng.decode_steps} decode steps (static "
          f"batch of {args.batch})")
    return 0


def _distributed(args, cfg, group, engine_cls, *models_params, **kw):
    """An expert-parallel engine over ``group``: "aurora" rounds planned
    from a synthetic trace, printed with the transport."""
    from repro_torch.core import synthetic_trace
    from repro_torch.serving import rounds_from_trace
    if cfg.moe is None:
        raise SystemExit(f"{cfg.arch_id} has no MoE layers — --mesh serves "
                         "expert-parallel (nothing to shard); drop --mesh "
                         "or pick an MoE arch")
    impl = args.moe_impl or "aurora"
    if impl == "aurora" and "plan" not in kw:
        hist = synthetic_trace("hist", n_experts=cfg.moe.n_experts,
                               n_layers=2, seed=0)
        kw["rounds"] = rounds_from_trace(hist, group.n)
    eng = engine_cls(*models_params, group=group, moe_impl=impl,
                     overlap=args.overlap, **kw)
    print(f"distributed EP serving: {group.transport}, impl={impl}, "
          f"overlap={args.overlap}, {len(eng.rounds or ())} scheduled "
          "rounds")
    return eng


def _serve_colocated(args, config, cfg, model, params, load, rng,
                     group=None) -> int:
    """Two models in ``ColocatedContinuousEngine`` (its distributed
    counterpart over ``group``), or without ``--arrival-rate`` in the
    static ``ColocatedEngine``. When both are MoE models with one expert
    count, the pairing is planned from synthetic traces and re-seated into
    model B's params in place. Two Poisson streams (static: two batches of
    ``--batch`` prompts), one per model."""
    from repro_torch.core import (AuroraPlanner, homogeneous_cluster,
                                  synthetic_trace)
    from repro_torch.serving import (ColocatedContinuousEngine,
                                     ColocatedEngine, OnlineReplanner,
                                     poisson_requests, reseat_pairing)

    cfg_b, model_b = load(args.colocate_with)
    params_b = model_b.init(1)
    plan = planner = None
    if (cfg.moe is not None and cfg_b.moe is not None
            and cfg.moe.n_experts == cfg_b.moe.n_experts):
        n = cfg.moe.n_experts
        tr_a = synthetic_trace("a", n_experts=n, n_layers=2, seed=0)
        tr_b = synthetic_trace("b", n_experts=n, n_layers=2, seed=1)
        planner = AuroraPlanner(homogeneous_cluster(n))
        plan = planner.plan_colocated(tr_a, tr_b)
        params_b = reseat_pairing(params_b, list(range(n)), plan.pair, cfg_b)
        print(f"aurora colocation pairing: {plan.pair}")
    replan = None
    if args.replan_interval is not None:
        if plan is None:
            raise SystemExit("--replan-interval needs two MoE models with "
                             "equal expert counts")
        replan = OnlineReplanner(planner, interval=args.replan_interval,
                                 threshold=args.replan_threshold)
    if args.arrival_rate is None:
        eng = ColocatedEngine(model.with_kernels(args.kernels),
                              model_b.with_kernels(args.kernels), params,
                              params_b)
        pa = rng.integers(1, cfg.vocab, (args.batch, args.prompt_len))
        pb = rng.integers(1, cfg_b.vocab, (args.batch, args.prompt_len))
        out_a, out_b = eng.serve(pa, pb, max_new_tokens=args.max_new_tokens,
                                 cache_cap=args.cache_cap)
        print("model A:", out_a.tolist())
        print("model B:", out_b.tolist())
        return 0
    kw = dict(batch_slots=args.batch, cache_cap=args.cache_cap,
              config=config, pair=list(plan.pair) if plan else None,
              replan=replan)
    if group is not None:
        from repro_torch.serving import DistributedColocatedEngine
        if plan is not None:
            kw["plan"] = plan
        eng = _distributed(args, cfg, group, DistributedColocatedEngine,
                           model, model_b, params, params_b, **kw)
    else:
        eng = ColocatedContinuousEngine(model, model_b, params, params_b,
                                        **kw)
    lo = max(1, args.max_new_tokens // 2)
    reqs_a = poisson_requests(rng, args.num_requests, args.arrival_rate,
                              cfg.vocab, args.prompt_len, lo,
                              args.max_new_tokens)
    reqs_b = poisson_requests(rng, args.num_requests, args.arrival_rate,
                              cfg_b.vocab, args.prompt_len, lo,
                              args.max_new_tokens)
    eng.serve(reqs_a, reqs_b)
    for tag, reqs in (("A", reqs_a), ("B", reqs_b)):
        total = sum(len(r.out_tokens) for r in reqs)
        print(f"model {tag}: {total} tokens over {len(reqs)} requests")
    print(f"{eng.decode_steps} lockstep decode steps")
    for e in eng.replan_events:
        tag = "APPLIED" if e.applied else "kept"
        print(f"replan @ step {e.step}: current {e.stale_time:.3f} vs "
              f"candidate {e.candidate_time:.3f} -> {tag}")
    if eng.replan_events:
        print(f"final pairing: {eng.pair}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
