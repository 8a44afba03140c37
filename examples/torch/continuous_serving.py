"""Continuous batching in action: watch the slot state machine (the
PyTorch port of ``examples/continuous_serving.py``).

Drives a ``ContinuousEngine`` step by step on a staggered request stream and
prints the per-step slot occupancy — requests flow through free slots as
they arrive and finish, instead of waiting for a whole batch to drain.

Usage: PYTHONPATH=src python examples/torch/continuous_serving.py
       [--device cpu]   (the card by default)
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.serving import ContinuousEngine, EngineConfig, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("qwen3-32b").reduced()
    model = Model(cfg, device=args.device)
    params = model.init(0)
    eng = ContinuousEngine(model, params, batch_slots=3, cache_cap=32,
                           config=EngineConfig(prefill_len=8))

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in rng.integers(1, cfg.vocab, 8)],
                    max_new_tokens=int(m), arrival=float(a))
            for a, m in [(0, 6), (0, 3), (1, 8), (2, 4), (5, 5), (6, 3)]]

    print(f"{len(reqs)} requests, {eng.batch_slots} slots "
          f"(arrival, max_new): "
          f"{[(r.arrival, r.max_new_tokens) for r in reqs]}\n")
    pending = sorted(reqs, key=lambda r: r.arrival)
    t, i = 0, 0
    while i < len(pending) or eng.queue or eng.num_active:
        while i < len(pending) and pending[i].arrival <= t:
            eng.submit(pending[i])
            i += 1
        busy = eng.step()
        occ = "".join("." if s is None else str(reqs.index(s))
                      for s in eng.slots)
        print(f"step {t:>2}  slots [{occ}]  queued {len(eng.queue)}"
              + ("" if busy else "  (idle)"))
        t += 1

    print()
    for k, r in enumerate(reqs):
        print(f"req {k} (t={r.arrival:.0f}): {r.out_tokens}")
    total = sum(len(r.out_tokens) for r in reqs)
    assert all(len(r.out_tokens) == r.max_new_tokens for r in reqs)
    print(f"\n{total} tokens in {eng.decode_steps} decode steps "
          f"({total / eng.decode_steps:.2f} tok/step); a static batch-3 "
          f"engine would have needed two full batches of max-length decodes.")
    return reqs


if __name__ == "__main__":
    main()
