"""Run one cell of the benchmark once on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints one JSON line last on standard output
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``compared``: each number the
comparison checked, beside its limit, which also close standard error).
Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), without the program's sources beside this
folder, or when ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro`` was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program at {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from perfbench import bench
    bench.setup_env(ROOT)
    import torch
    cell = bench.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    result = bench.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), device="cuda", root=ROOT,
                       t_start=T_START)
    loaded = bench.banned_modules()
    if loaded:
        print(f"loaded {', '.join(loaded)}: the benchmark runs without "
              "JAX and the JAX package", file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
