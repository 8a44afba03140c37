"""The knee of an open-loop cell: the same engine and weights under a set of
fixed rates, one window each, in one process on the card.

    python3 perfbench/sweep.py --workload <cell> --seconds 30 \\
        --rates 8 10 12 14 [--schedule-seeds 0 1]

Per rate (and arrival schedule), one JSON line: the TTFT and ITL tails, the mean queue length in
the first and the last third of the window (a backlog that grows through
the window means the rate is not sustained), the requests served in full
and how long the window's last request took to drain.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--schedule-seeds", type=int, nargs="+",
                    help="arrival schedules to sweep (default: the mix's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import bench, readers
    bench.setup_env(ROOT)
    cell = bench.load_cell(args.workload, ROOT)
    h = bench.Harness(cell, dict(cell.mix), args.seed, args.device,
                      trace=False)
    runs = [(rate, sched) for sched in (args.schedule_seeds or [None])
            for rate in args.rates]
    for rate, sched in runs:
        h.mix["rate_rps"] = rate
        if sched is not None:
            h.mix["schedule_seed"] = sched
        h.settle()
        t0, records, steps, t_end = h.window(args.seed, args.seconds)
        finished, failed = h.finished(records, t_end)
        run = bench.Run(seconds=args.seconds,
                        setup_s=0.0, t0=t0, records=records, steps=steps,
                        spans=[], kernel_calls={}, profile=None,
                        flops=None, cap=h.cap)
        third = args.seconds / 3

        def queue(lo, hi):
            qs = [q for _, e, q in steps if t0 + lo <= e < t0 + hi]
            return sum(qs) / len(qs) if qs else 0.0
        ttft = readers.ttft_s(run)
        line = {"rate_rps": rate,
                "schedule_seed": h.mix.get("schedule_seed"),
                "attempted": len(run.window),
                "served": len(finished), "failed": failed,
                "ttft_p50_ms": readers.tail_ms(ttft, 50),
                "ttft_p95_ms": readers.tail_ms(ttft),
                "itl_p50_ms": readers.tail_ms(readers.itl_s(run), 50),
                "itl_p95_ms": readers.tail_ms(readers.itl_s(run)),
                "itl_p99_ms": readers.tail_ms(readers.itl_s(run), 99),
                "itl_tail_ms": readers.tail_mean_ms(readers.itl_s(run), 95),
                "queue_first_third": queue(0, third),
                "queue_last_third": queue(2 * third, args.seconds),
                "drain_s": t_end - (t0 + args.seconds),
                "steps": len(steps)}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
