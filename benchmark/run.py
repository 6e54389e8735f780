"""Run one cell of the benchmark of ``liwslam_torch`` (the PyTorch and CUDA
port) once, on this machine's card, and print its result as the last line
of standard output.

    python benchmark/run.py --workload <config>.<mix> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration
(``benchmark/configs/<config>.json``) and its traffic mix
(``benchmark/traffic/<mix>.json``); its limits are
``benchmark/limits/<cell>.json``.  With ``--trace 0`` the result carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(read by ``benchmark/metrics/<metric>.py`` from a profiled part of the
window), the device's busy and traced seconds and a breakdown.

Exit codes: 0 with a result; 2 without the card(s) the cell needs; 3
without the port beside this folder; 4 when JAX or the JAX package is
loaded in this process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "liwslam")


def process_age_s() -> float:
    """Seconds since this process started (its start time from /proc), or
    since this module was loaded where /proc cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_LOADED


_T_LOADED = time.perf_counter()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole (``liwslam_torch`` is not ``liwslam``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_cell(name: str) -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"run.py: no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json")) as f:
        mix = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "limits", name + ".json")) as f:
        limits = json.load(f)
    return dict(bench=bench, workload=w, cfg=cfg, mix=mix, limits=limits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = load_cell(args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: the cell needs {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import liwslam_torch  # noqa: F401
    except ImportError as e:
        print(f"run.py: the port (liwslam_torch) is not beside the benchmark: {e}", file=sys.stderr)
        return 3
    from benchmark.harness import runner

    result, checks = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", process_age_s)
    found = forbidden_modules()
    if found:
        print(f"run.py: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 4
    for name, (val, lim) in checks.items():
        print(f"check {name}: {val!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
