"""Serving driver of the port: continuous batching over a Poisson stream.

  python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --kernels \
      --n-layers 8 --batch 8 --prompt-len 128 --max-new-tokens 32 \
      --cache-cap 512 --arrival-rate 0.5 --num-requests 8
  python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --reduced \
      --device cpu --arrival-rate 0.5 --num-requests 6 --batch 3 \
      --cache-cap 32 --kernels

  python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --reduced \
      --device cpu --prefill-chunk 4 --prefill-pool 2 --step-budget 9 \
      --ttft-slo 12

The counterpart of ``python -m repro.launch.serve`` for the continuous,
single-model path. Inter-arrival gaps are Exp(``--arrival-rate``) in
decode-step units. ``--prefill-chunk``, ``--step-budget``,
``--prefill-pool`` and ``--bucket-policy`` configure chunked admission;
``--ttft-slo``/``--tpot-slo`` declare a ``TenantSpec`` (p95 targets in
engine steps) and switch admission to ``EdfAdmission`` over the same chunk
and budget. ``--kernels`` serves through the hand-written CUDA
kernels (their plain PyTorch versions on ``--device cpu``). ``--n-layers``
cuts the depth of a full-width config so its weights fit one card.
Weights are random, from seed 0.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the layer count (full widths are kept)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--cache-cap", type=int, default=64)
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="requests per decode step (Poisson)")
    ap.add_argument("--num-requests", type=int, default=12)
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
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models import Model
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
            tenants=(tenant,))
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
                              kernels=args.kernels)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    model = Model(cfg, device=args.device)
    params = model.init(0)
    eng = ContinuousEngine(
        model, params, batch_slots=args.batch, cache_cap=args.cache_cap,
        config=config)
    rng = np.random.default_rng(0)
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


if __name__ == "__main__":
    raise SystemExit(main())
