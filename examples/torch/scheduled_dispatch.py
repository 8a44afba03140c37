"""Aurora-scheduled MoE dispatch over expert-parallel ranks (Thm 4.2
runtime; the PyTorch port of ``examples/scheduled_dispatch.py``).

Runs the SAME expert-parallel MoE layer three ways over 8 in-process ranks
(``LocalGroup(8, device)``, the counterpart of the reference's 8-device
host mesh):
  1. one monolithic all-to-all             (production baseline),
  2. round-robin permutation rounds        (traffic-blind, contention-free),
  3. Aurora BvN rounds from a planned schedule (traffic-aware ordering),
and verifies all three produce identical outputs — the schedule changes
WHEN bytes move, never WHAT arrives.

Usage: PYTHONPATH=src python examples/torch/scheduled_dispatch.py
       [--device cpu]   (the card by default)
"""

import argparse

import numpy as np
import torch


def main(argv=None):
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import aurora_schedule, synthetic_trace
    from repro_torch.distributed import (LocalGroup,
                                         aurora_rounds_from_schedule,
                                         round_robin_rounds)
    from repro_torch.models import ParallelContext
    from repro_torch.models.moe import moe_apply_ep

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n, d = 8, 64
    group = LocalGroup(n, args.device)
    moe = MoEConfig(n_experts=n, top_k=2, d_ff=128, capacity_factor=4.0)
    rng = np.random.default_rng(0)

    def leaf(*shape, fan_in):
        return torch.from_numpy(
            (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)
        ).to(group.device)

    params = {"router": leaf(d, n, fan_in=d),
              "experts": {"w_gate": leaf(n, d, moe.d_ff, fan_in=d),
                          "w_up": leaf(n, d, moe.d_ff, fan_in=d),
                          "w_down": leaf(n, moe.d_ff, d, fan_in=moe.d_ff)}}
    x = torch.from_numpy(rng.standard_normal((4, 32, d)).astype(
        np.float32)).to(group.device)

    # Plan from historical routing statistics (paper §2.4).
    trace = synthetic_trace("hist", n_experts=n, n_layers=1, seed=42)
    sched = aurora_schedule(trace.layer(0))
    rounds = aurora_rounds_from_schedule(sched, n)
    print(f"planned schedule: {sched.n_slots} BvN slots, "
          f"b_max {sched.b_max:.1f} -> {len(rounds)} static permutation "
          "rounds")

    def run(impl, aurora_rounds=None):
        pc = ParallelContext(group=group, moe_impl=impl,
                             aurora_rounds=aurora_rounds)
        y, aux = moe_apply_ep(params, x, moe, "swiglu", pc)
        return y.cpu().numpy()

    y_base = run("ep")
    y_rr = run("aurora", round_robin_rounds(n))
    y_aurora = run("aurora", rounds)
    np.testing.assert_allclose(y_rr, y_base, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_aurora, y_base, rtol=1e-5, atol=1e-5)
    err = float(np.abs(y_aurora - y_base).max())
    print("all three dispatch implementations agree "
          f"(max |Δ| = {err:.2e})")
    print(f"the rounds ran over {group.transport}; they avoid receiver "
          "contention for the planned traffic")
    return err


if __name__ == "__main__":
    main()
