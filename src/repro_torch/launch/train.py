"""Training driver of the port (the counterpart of
``python -m repro.launch.train``):

  python -m repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b \\
      --reduced --device cpu --steps 100 --batch 8 --seq 128
  python -m repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b \\
      --n-layers 2 --steps 10 --batch 1 --seq 4096

It trains on ``SyntheticLMData`` (seed 0; seeded frames of ``--seq``
positions for an encoder-decoder) from ``Model.init(0)`` with AdamW (lr
``--lr``, warmup a tenth of the steps), prints one JSON line per logged
step (``ce``, ``aux``, ``loss``, ``step``, ``wall``) and, with
``--checkpoint DIR``, writes the params there in the reference's format.
It runs on the card unless ``--device cpu`` is given. ``--n-layers`` cuts
the depth of a full-width config so it fits one card
(``configs.cut_depth``: MoE layers first). Training takes the reference's
plain route and runs no hand-written kernel.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import cut_depth, get_config
    from repro_torch.models import Model
    from repro_torch.training import (AdamWConfig, SyntheticLMData,
                                      save_checkpoint, train_loop)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.n_layers is not None:
        cfg = cut_depth(cfg, args.n_layers)
    model = Model(cfg, device=args.device)
    data = SyntheticLMData(
        cfg.vocab, seq_len=args.seq, batch=args.batch,
        frames_dim=cfg.frontend_dim if cfg.is_encoder_decoder else 0,
        frames_len=args.seq if cfg.is_encoder_decoder else 0)
    state, hist = train_loop(
        model, data, steps=args.steps,
        opt_cfg=AdamWConfig(lr=args.lr,
                            warmup_steps=max(args.steps // 10, 1)),
        log_every=args.log_every)
    for h in hist:
        print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                          for k, v in h.items()}))
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state.params, step=state.step)
        print(f"saved checkpoint to {args.checkpoint}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
