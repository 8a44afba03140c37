"""Aurora colocated serving (the paper's §6 in action; the PyTorch port of
``examples/serve_colocated.py``).

Serves TWO reduced models on one device in lockstep — model A (MoE,
comm-heavy) and model B (dense, compute-heavy) — after planning the expert
colocation with AuroraPlanner on historical routing statistics. Also
prints what the plan predicts vs the baselines.

Usage: PYTHONPATH=src python examples/torch/serve_colocated.py
       [--device cpu]   (the card by default)
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import (AuroraPlanner, homogeneous_cluster,
                              lina_inference_time, paper_eval_traces)
from repro_torch.models import Model
from repro_torch.serving import ColocatedEngine
from repro_torch.serving.colocated import apply_pairing


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # --- plan (host-side, from historical statistics) --------------------
    trace_a, trace_b = paper_eval_traces(seed=0)
    n = trace_a.n
    cluster = homogeneous_cluster(n)
    plan = AuroraPlanner(cluster).plan_colocated(trace_a, trace_b)
    t_aurora = plan.predicted.inference_time
    t_lina = max(
        np.mean([lina_inference_time(t, layer, cluster,
                                     policy="rcs").inference_time
                 for layer in range(len(t.layers))])
        for t in (trace_a, trace_b))
    print(f"planned pairing {plan.pair}")
    print(f"predicted inference: aurora {t_aurora:.1f} vs lina {t_lina:.1f} "
          f"({t_lina / t_aurora:.2f}x)")

    # --- serve (reduced models) -------------------------------------------
    cfg_a = get_config("phi3.5-moe-42b-a6.6b").reduced()
    cfg_b = get_config("phi4-mini-3.8b").reduced()
    model_a = Model(cfg_a, device=args.device)
    model_b = Model(cfg_b, device=args.device)
    params_a = model_a.init(0)
    params_b = model_b.init(1)
    # Apply the planner's pairing to model A's expert placement (reduced
    # config has 4 experts; re-plan at that size).
    from repro_torch.core import synthetic_trace
    e = cfg_a.moe.n_experts
    pl = AuroraPlanner(homogeneous_cluster(e)).plan_colocated(
        synthetic_trace("a", n_experts=e, n_layers=2, seed=0),
        synthetic_trace("b", n_experts=e, n_layers=2, seed=1))
    params_a = apply_pairing(params_a, pl.pair, cfg_a)
    print(f"reduced-model pairing applied: {pl.pair}")

    eng = ColocatedEngine(model_a, model_b, params_a, params_b)
    rng = np.random.default_rng(0)
    prompts_a = rng.integers(1, cfg_a.vocab, (2, 8))
    prompts_b = rng.integers(1, cfg_b.vocab, (2, 8))
    out_a, out_b = eng.serve(prompts_a, prompts_b, max_new_tokens=8,
                             cache_cap=32)
    assert tuple(out_a.shape) == tuple(out_b.shape) == (2, 8)
    print("model A generated:", out_a.tolist())
    print("model B generated:", out_b.tolist())
    return out_a, out_b


if __name__ == "__main__":
    main()
