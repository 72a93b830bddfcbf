"""Run one cell of the benchmark once.

    python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout (where `BENCHMARK.json` is), on a machine
with the cell's CUDA cards.  Prints the numbers that decide `correct`, each
beside its limit, as the last lines of standard error, and the result as
one JSON object on the last line of standard output.  Exits 0 only with a
result; without CUDA, with too few cards, or when a forbidden module (JAX
or the JAX package) was loaded, it prints no result and exits 3 or 4.

The process runs PyTorch's host work on one thread: the port's host time
is one Python thread launching kernels, and idle OpenMP workers spinning
beside it on a shared host would only widen the spread of its rate.
"""

from __future__ import annotations

import os
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
    import torch
    torch.set_num_threads(1)

    from slambench.manifest import Cell
    cell = Cell(root, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"slambench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from slambench import harness
    out = harness.run_cell(root, args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T0)
    bad = harness.import_guard()
    ref_bad = harness.reference_imports()
    if bad or ref_bad:
        print(f"slambench: forbidden modules loaded: {bad}; the reference imports "
              f"{ref_bad}", file=sys.stderr)
        return 4
    res = out["result"]
    lim = res["device"].get("power_limit")
    print(f"slambench: {args.workload} seed {args.seed} on {res['device']['kind']} "
          f"(power limit {lim}): {out['e2e']}", file=sys.stderr)
    for k, v in out["readings"].items():
        print(f"reading {k} {v!r}", file=sys.stderr)
    print(f"correct {res['correct']} failed {res['failed']} of {res['attempted']}",
          file=sys.stderr)
    for k, row in out["checks"].items():
        good = row["value"] is not None and row["value"] <= row["limit"]
        print(f"check {k} {row['value']!r} limit {row['limit']!r} "
              f"{'ok' if good else 'FAIL'}", file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
