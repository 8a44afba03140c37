"""End-to-end driver: train a ~100M-parameter MoE on synthetic data and
report the loss curve (the PyTorch port of ``examples/train_moe.py``).

The model is a scaled phi3.5-MoE family member (8 experts, top-2) — the
same code path the production config runs, including router aux loss and
capacity dispatch — trained by ``repro_torch.training.train_loop`` on the
card (``--device cpu`` for the host). Pass --steps 50 for a quick look.

Usage: PYTHONPATH=src python examples/torch/train_moe.py [--steps N]
       [--batch B] [--seq S] [--device cpu]
"""

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.models import Model
from repro_torch.training import AdamWConfig, SyntheticLMData, train_loop


def make_100m_config():
    base = get_config("phi3.5-moe-42b-a6.6b")
    return dataclasses.replace(
        base,
        arch_id="phi-moe-100m",
        n_layers=4,
        d_model=512,
        n_heads=8,
        n_kv_heads=4,
        head_dim=64,
        vocab=8192,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=1024,
                      capacity_factor=1.25),
        dtype="float32",
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = make_100m_config()
    model = Model(cfg, device=args.device)
    n_params = cfg.param_count()
    print(f"arch {cfg.arch_id}: {n_params/1e6:.1f}M params "
          f"({cfg.active_param_count()/1e6:.1f}M active/token)")

    data = SyntheticLMData(cfg.vocab, seq_len=args.seq, batch=args.batch,
                           seed=0)
    state, hist = train_loop(
        model, data, steps=args.steps,
        opt_cfg=AdamWConfig(lr=6e-4, warmup_steps=args.steps // 10),
        log_every=max(args.steps // 20, 1))
    for h in hist:
        print(f"step {h['step']:4d}  ce {h['ce']:.4f}  aux {h['aux']:.4f}  "
              f"wall {h['wall']:.0f}s")
    first, last = hist[0]["ce"], hist[-1]["ce"]
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'OK: decreased' if last < first else 'WARNING: did not decrease'})")
    return hist


if __name__ == "__main__":
    main()
