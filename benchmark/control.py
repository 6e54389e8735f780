"""The readings that a cell's limits are set from: for each seed, a run of
the cell with a short window, its check's numbers for the program (the
lower readings) and the same numbers for the control (the plain reference
computed with every float32 matrix product in TF32, the step below the
configuration's float32 with TF32 off, in the program's place: the upper
readings).  The benchmark's own runs never run the control.

    python benchmark/control.py --workload <cell> --seeds 11 12 13 --seconds 4 [--out readings.jsonl]

Runs on the card, the seeds one after another in one process.  Prints one
JSON line a seed, then the largest program reading and the smallest
control reading of each number over the seeds.  The benchmark's tests run
the control on the CPU at a test's size (``tests/test_bench_faults.py``).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import run
    from benchmark.harness import runner

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload)
    lower, upper = {}, {}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            res, _ = runner.run_cell(cell, seed, args.seconds, False, "cuda", lambda: time.perf_counter() - t0,
                                     control=True)
            prog = dict(res["readings"], **{k: v[0] for k, v in res["checks"].items()})
            line = {"workload": args.workload, "seed": seed, "correct": res["correct"], "program": prog,
                    "control": res["control_readings"], "metrics": res["metrics"],
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            for k, v in prog.items():
                lower[k] = max(lower.get(k, 0.0), v)
            for k, v in res["control_readings"].items():
                upper[k] = min(upper.get(k, float("inf")), v)
            del res
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    for k in sorted(set(lower) | set(upper)):
        lo, up = lower.get(k), upper.get(k)
        ratio = up / lo if lo and up is not None else float("inf")
        print(f"reading {k}: program max {lo!r}, control min {up!r}, ratio {ratio:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
