"""The sweep that fixed a traffic mix's B: a cell's window at several B in
one process, on the card.

    python benchmark/sweep.py --workload office.replay-b8192 --sequences 1024 2048 4096 --seconds 8 --seed 7

The mix's set-up runs once at the largest B; each smaller B takes the
first B sequences (sequence b replays track b mod S, so they are a fleet
of their own).  For each B it prints one JSON line: frames/s, the
window's steps, and from one profiled chunk the device's busy and idle
share, launches a step and the peak memory of the window.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sequences", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from torch.utils._pytree import tree_map

    from benchmark import run
    from benchmark.harness import check, runner, trace, windows

    if not torch.cuda.is_available():
        print("sweep.py: no CUDA device", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload)
    mix = dict(cell["mix"], sequences=max(args.sequences))
    t0 = time.perf_counter()
    prog, _, _, states_all, inputs_all = runner.setup(cell["cfg"], mix, args.seed, "cuda")
    print(f"sweep: set-up at B={mix['sequences']} {time.perf_counter() - t0:.1f}s", flush=True)
    for B in sorted(args.sequences):
        states0 = tree_map(lambda x: x[:B], states_all)
        inputs = {k: v[:B] for k, v in inputs_all.items()}
        plan = check.Plan(seqs=[0], tracks=[], chunk=0)
        tracer = trace.Tracer()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prog.run(states0, prog.frame_input(inputs, slice(0, mix["chunk"])))
        res = windows.replay(prog, states0, inputs, mix["chunk"], args.seconds, plan, tracer)
        line = {"frames_per_s": res.frames / res.seconds, "ms_a_step": 1e3 * res.seconds / res.steps}
        tr = tracer.read()
        line.update(
            workload=args.workload, B=B, steps=res.steps, window_s=res.seconds,
            busy_ms_a_step=1e3 * tr.busy_s / tr.steps, traced_ms_a_step=1e3 * tr.window_s / tr.steps,
            idle_share=1 - tr.busy_s / tr.window_s,
            launches_a_step=sum(1 for n, _, _ in tr.host if n in trace.LAUNCHES) / tr.steps,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30, nonfinite=res.nonfinite,
            top_ops=trace.breakdown(tr, 6)["device_ops"],
        )
        print(json.dumps(line), flush=True)
        del states0, inputs, res, tr, tracer
    return 0


if __name__ == "__main__":
    sys.exit(main())
