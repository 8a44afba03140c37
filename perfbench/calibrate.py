"""Readings the comparison's limits are set from, on the card, in one
process: for each seed, the benchmark's weights of that seed, a window of
the cell's own traffic, and the program's readings judged as a run judges
them (``Harness.compare``); for the first ``--control`` seeds also the
control's (the reference computed in float8 put in the program's place,
at the same positions of the same requests), judged by the same limits,
and with ``--witness`` those of the reference computed with bf16
activations, an independent bf16 computation to hold a program's outlier
against.

    python3 perfbench/calibrate.py --workload <cell> --seconds 10 \\
        --seeds 11 12 13 ... --control 3 [--out <dir>]

One JSON line per seed on standard output: each side's readings, its
compared numbers beside their limits and whether it passed. With
``--out``, each side's gap at every compared position goes to
``<dir>/<cell>_<seed>.npz``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import bench, check
    bench.setup_env(ROOT)
    cell = bench.load_cell(args.workload, ROOT)
    h = bench.Harness(cell, dict(cell.mix), args.seeds[0], args.device,
                      trace=False)
    for i, seed in enumerate(args.seeds):
        h.weights.fill(seed)
        h.settle()
        t0, records, _, t_end = h.window(seed, args.seconds)
        finished, failed = h.finished(records, t_end)
        controls = (("fp8",) if i < args.control else ()) + (
            ("bf16",) if args.witness else ())
        positions = {} if args.out else None
        t = time.perf_counter()
        sides = h.compare(finished, failed, seed, controls, positions)
        line = {"seed": seed, "failed": failed,
                "reference_s": time.perf_counter() - t}
        for side, (compared, got) in sides.items():
            line[side] = dict(got, compared=compared,
                              correct=check.passed(compared))
        if positions:
            args.out.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(args.out / f"{args.workload}_{seed}.npz",
                                **positions)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
