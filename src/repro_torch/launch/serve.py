"""Serving driver of the port: continuous batching over a Poisson stream.

  python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --kernels \
      --n-layers 8 --batch 8 --prompt-len 128 --max-new-tokens 32 \
      --cache-cap 512 --arrival-rate 0.5 --num-requests 8
  python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --reduced \
      --device cpu --arrival-rate 0.5 --num-requests 6 --batch 3 \
      --cache-cap 32 --kernels

The counterpart of ``python -m repro.launch.serve`` for the continuous,
single-model path. Inter-arrival gaps are Exp(``--arrival-rate``) in
decode-step units. ``--kernels`` serves through the hand-written CUDA
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
    ap.add_argument("--kernels", action="store_true",
                    help="serve through the CUDA kernel path (sort-based "
                         "MoE dispatch + moe_gmm, decode_attn)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import (ContinuousEngine, EngineConfig,
                                     poisson_requests)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    model = Model(cfg, device=args.device)
    params = model.init(0)
    eng = ContinuousEngine(
        model, params, batch_slots=args.batch, cache_cap=args.cache_cap,
        config=EngineConfig(prefill_len=args.prompt_len, kernels=args.kernels))
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
