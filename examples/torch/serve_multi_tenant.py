"""Multi-tenant Aurora colocation: N models interleaved on one device (the
PyTorch port of ``examples/serve_multi_tenant.py``).

The paper colocates TWO models so one computes while the other communicates
(§6); nothing in the theory stops N-way interleaving. This example plans a
3-tenant expert grouping with ``AuroraPlanner.plan_multi`` (greedy repeated
bottleneck matching — §7.2's decoupling applied tenant-by-tenant), compares
its predicted inference time against random grouping, then serves three
reduced MoE models through one ``MultiTenantContinuousEngine`` — every
tenant's decode in one lockstep step, with the planner's grouping
physically realized by permuting each tenant's expert weights.

The pool membership is LIVE: after the first stream drains, a fourth tenant
joins mid-flight (``admit_tenant`` — its slot pool and colocation column are
created online) and is later evicted (``evict_tenant``), with the incumbent
tenants' serving state untouched throughout.

Usage: PYTHONPATH=src python examples/torch/serve_multi_tenant.py
       [--device cpu]   (the card by default)
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import (AuroraPlanner, group_pairs, homogeneous_cluster,
                              random_grouping, synthetic_trace)
from repro_torch.models import Model
from repro_torch.serving import (MultiTenantContinuousEngine, Request,
                                 apply_pairing)

N_TENANTS = 3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # --- plan (host-side, from historical statistics) ---------------------
    traces = [synthetic_trace(f"tenant{t}", n_experts=8, n_layers=2,
                              skew=0.3 + 0.5 * t, seed=17 * t)
              for t in range(N_TENANTS)]
    planner = AuroraPlanner(homogeneous_cluster(8))
    plan = planner.plan_multi(traces)
    t_rand = np.mean([planner.evaluate_multi(
        traces, random_grouping(8, N_TENANTS, seed=s)).inference_time
        for s in range(6)])
    print(f"scenario {plan.scenario}: groups (slot -> one expert per tenant)")
    for g, grp in enumerate(plan.groups):
        print(f"  slot {g}: {grp}")
    print(f"predicted inference: aurora {plan.predicted.inference_time:.2f} "
          f"vs random grouping {t_rand:.2f} "
          f"({t_rand / plan.predicted.inference_time:.2f}x)")

    # --- serve (reduced models) -------------------------------------------
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    models = [Model(cfg, device=args.device) for _ in range(N_TENANTS)]
    params = [m.init(t) for t, m in enumerate(models)]
    # Realize a grouping at the reduced expert count (4): re-plan small.
    small = [synthetic_trace(f"s{t}", n_experts=cfg.moe.n_experts,
                             n_layers=2, seed=t) for t in range(N_TENANTS)]
    sp = AuroraPlanner(homogeneous_cluster(cfg.moe.n_experts)).plan_multi(
        small)
    perms = group_pairs(list(sp.groups))
    params = [params[0]] + [apply_pairing(params[t], perms[t], cfg)
                            for t in range(1, N_TENANTS)]
    print(f"\nreduced-model grouping applied: {list(sp.groups)}")

    eng = MultiTenantContinuousEngine(models, params, batch_slots=2,
                                      cache_cap=32,
                                      groups=list(sp.groups))
    rng = np.random.default_rng(0)
    streams = [[Request(prompt=[int(x) for x in rng.integers(1, cfg.vocab, 8)],
                        max_new_tokens=6, arrival=float(i))
                for i in range(3)]
               for _ in range(N_TENANTS)]
    out = eng.serve(streams)
    for t, reqs in enumerate(out):
        print(f"tenant {t} generated: {[r.out_tokens for r in reqs]}")
    total = sum(len(r.out_tokens) for s in out for r in s)
    assert total == N_TENANTS * 3 * 6
    print(f"\n{total} tokens across {N_TENANTS} tenants in "
          f"{eng.decode_steps} fused decode steps "
          f"({total / eng.decode_steps:.2f} tok/step)")

    # --- live tenant churn ------------------------------------------------
    joiner = Model(cfg, device=args.device)
    t_new = eng.admit_tenant(joiner, joiner.init(99))
    print(f"\ntenant {t_new} joined the live pool "
          f"(groups now {eng.n_tenants}-wide: {eng.groups})")
    late = [Request(prompt=[int(x) for x in rng.integers(1, cfg.vocab, 8)],
                    max_new_tokens=4, arrival=0.0) for _ in range(2)]
    eng.serve([[], [], [], late])
    assert all(len(r.out_tokens) == 4 for r in late)
    print(f"joiner generated: {[r.out_tokens for r in late]}")
    eng.evict_tenant(t_new)
    assert eng.n_tenants == N_TENANTS
    print(f"tenant {t_new} evicted — back to {eng.n_tenants} tenants, "
          "incumbent pools untouched")
    return out


if __name__ == "__main__":
    main()
