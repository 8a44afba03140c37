"""Quickstart: plan an Aurora deployment, inspect it, and serve with it
(the PyTorch port of ``examples/quickstart.py``).

  1. Build routing statistics for two MoE models (the paper's §2.4 input).
  2. Plan all four scenarios with AuroraPlanner and print predicted
     inference times + the contention-free transmission schedule.
  3. Lower that schedule to the permutation rounds the expert-parallel
     runtime (``repro_torch.distributed``) executes.

The planner is host-side numpy, so ``--device`` only names where the
runtime would run; it defaults to the card.

Usage: PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""

import argparse

from repro_torch.core import (AuroraPlanner, heterogeneous_cluster,
                              homogeneous_cluster, paper_eval_traces)
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    trace_a, trace_b = paper_eval_traces(seed=0)
    n = trace_a.n
    print(f"two models, {n} experts each, {len(trace_a.layers)} MoE layers")

    # --- scenario 1/2: exclusive deployments -----------------------------
    for cluster, name in ((homogeneous_cluster(n), "homogeneous"),
                          (heterogeneous_cluster(n), "heterogeneous")):
        plan = AuroraPlanner(cluster).plan_exclusive(trace_a)
        print(f"\n[exclusive + {name}] predicted inference time "
              f"{plan.predicted.inference_time:.2f} "
              f"(util {plan.predicted.utilization:.2%})")
        print(f"  expert→device map: {plan.expert_to_device.tolist()}")
        sched = plan.schedules[0]
        print(f"  layer-0 schedule: {sched.n_slots} permutation rounds, "
              f"total {sched.total_time:.2f} = b_max {sched.b_max:.2f}")

    # --- scenario 3/4: colocated deployments ------------------------------
    for cluster, name in ((homogeneous_cluster(n), "homogeneous"),
                          (heterogeneous_cluster(n), "heterogeneous")):
        plan = AuroraPlanner(cluster).plan_colocated(trace_a, trace_b)
        print(f"\n[colocating + {name}] predicted inference time "
              f"{plan.predicted.inference_time:.2f} "
              f"(util {plan.predicted.utilization:.2%})")
        print(f"  b-expert colocated with a-expert k: {plan.pair}")

    # --- the schedule as permutation rounds (what the runtime executes) ---
    from repro_torch.distributed import aurora_rounds_from_schedule
    plan = AuroraPlanner(homogeneous_cluster(n)).plan_exclusive(trace_a)
    rounds = aurora_rounds_from_schedule(plan.schedules[0], n)
    print(f"\nlayer-0 dispatch lowered to {len(rounds)} permutation rounds; "
          f"first 3:")
    for r in rounds[:3]:
        print("  ", r)
    return rounds


if __name__ == "__main__":
    main()
