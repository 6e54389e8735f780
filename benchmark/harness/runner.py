"""One run of one cell: set-up, the measured window, the check and the
result line's fields.

Set-up (timed from the process's start to the window's first step):
simulate the mix's S tracks from the seed, solve each track's init window
with the program on its noisy frames, replicate the S states to B
sequences, draw the B sequences' inputs with noise of their own on the
card, and warm the window's own call (one chunk).  Then the window
(``windows.replay``), the device's peak memory, and, with the program's
state freed, the check against the plain reference on the CPU.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from benchmark.harness import check, fleet, trace, windows
from benchmark.harness.program import Program


def _metric_reader(name: str):
    import importlib.util
    import os

    here = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "metrics")
    for stem in (name, name.split(".")[0]):
        path = os.path.join(here, stem + ".py")
        if os.path.isfile(path):
            spec = importlib.util.spec_from_file_location(f"benchmark_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name} in {here}")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def setup(cfg: dict, mix: dict, seed: int, device):
    """The program, its B initial states and the B sequences' resident
    inputs, and what the check needs of the init windows."""
    t0 = time.perf_counter()
    prog = Program(cfg, device)
    B, S = mix["sequences"], mix["tracks"]
    if mix["kind"] != "replay":
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    n_frames = mix["frames"]
    if n_frames % mix["chunk"]:
        raise ValueError("replay: frames must be a multiple of the chunk")
    packed = fleet.simulate_tracks(cfg, mix, seed, n_frames)
    t_sim = time.perf_counter()
    tracks, inits = [], []
    for s, clean in enumerate(packed):
        noisy = fleet.noisy_init_frames(clean, cfg, seed, s, device)
        noisy["stamps"] = clean["stamps"]
        state, first, wp, wq = prog.initialize(noisy)
        tracks.append(fleet.Track(clean=clean, init_frames=noisy, first=first, state=state))
        inits.append((first, wp.detach().cpu(), wq.detach().cpu()))
    t_init = time.perf_counter()
    states0 = prog.stack_states([t.state for t in tracks], B)
    inputs = fleet.replica_inputs(tracks, B, n_frames, 0, cfg, seed, device)
    _sync(device)
    t_in = time.perf_counter()
    print(f"set-up: program {t_sim - t0:.2f}s with {S} simulations, {S} init windows {t_init - t_sim:.2f}s "
          f"(first tracked frames {[t.first for t in tracks]}), {B} sequences' inputs {t_in - t_init:.2f}s",
          file=sys.stderr, flush=True)
    return prog, tracks, inits, states0, inputs


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device, age_s, control: bool = False):
    """Set-up, window and check of one cell.  Returns (result line fields,
    checks).  ``age_s()`` gives the process's age in seconds.  With
    ``control`` the result also carries ``control_readings``: the same
    numbers with the control (the reference in TF32 products) in the
    program's place."""
    cfg, mix, w = cell["cfg"], cell["mix"], cell["workload"]
    bench = cell["bench"]
    dev = torch.device(device)
    rng = np.random.default_rng(fleet.sub_seed(seed, 4))
    B, S = mix["sequences"], mix["tracks"]
    plan = check.make_plan(rng, B, S, mix["check"])

    prog, tracks, inits, states0, inputs = setup(cfg, mix, seed, device)
    tracer = trace.Tracer(record_b1=True) if traced else None
    chunk = mix["chunk"]
    # warm-up: the window's own call, once, from the same states
    prog.run(states0, prog.frame_input(inputs, slice(0, chunk)))
    _sync(dev)
    print(f"set-up: warm-up done at {age_s():.2f}s of the process", file=sys.stderr, flush=True)
    setup_peak = 0
    if dev.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = age_s()
    res = windows.replay(prog, states0, inputs, chunk, seconds, plan, tracer)
    window_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    peak = max(setup_peak, window_peak)

    metrics = {}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": False, "attempted": int(res.attempted), "failed": int(res.failed)}
    breakdown = None
    if traced:
        tr = tracer.read()
        tr.cell.update(
            B=B, N=cfg["params"]["max_points"], L=cfg["params"]["max_lines"],
            window_peak_gib=window_peak / 2**30 if dev.type == "cuda" else None,
        )
        for m in bench["per_layer"]:
            if "workloads" in m and w["name"] not in m["workloads"]:
                continue
            if "workloads" not in m and not _reports(bench, w["name"], m["moves"]):
                continue
            val = _metric_reader(m["name"])(tr)
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        breakdown = trace.breakdown(tr)
    else:
        e2e = {
            "setup_s": setup_s,
            "frames_per_s": res.frames / res.seconds if res.seconds > 0 else 0.0,
        }
        for m in bench["end_to_end"]:
            if "workloads" in m and w["name"] not in m["workloads"]:
                continue
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    # the check: the program's state freed, the reference on the CPU
    samples = [s for s in res.samples if s is not None]
    keep_inputs = {k: v.index_select(0, torch.as_tensor(plan.seqs, device=dev)).cpu() for k, v in inputs.items()}
    init_frames = {s: tracks[s].init_frames for s in plan.tracks}
    del prog, tracks, states0, inputs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = check.Reference(cfg)
    jobs = [check.InitJob(init_frames[s], *inits[s]) for s in plan.tracks]
    local = {b: i for i, b in enumerate(plan.seqs)}
    for smp in samples:
        jobs += check.chain_jobs(ref, _localize(smp, local), keep_inputs)
    t_check = time.perf_counter()
    nums, ctrl = check.run_jobs(cfg, jobs, control, mix["check"].get("workers", 1))
    print(f"check: {len(jobs)} reference jobs {time.perf_counter() - t_check:.1f}s", file=sys.stderr, flush=True)
    readings = nums.summary()
    correct, checks = check.verdict(readings, cell["limits"], res.nonfinite, 1 - len(samples))
    result["correct"] = bool(correct)
    result["metrics"] = metrics
    result["device"] = device_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    if res.chunk_s:
        result["chunk_seconds"] = res.chunk_s
    result["readings"] = {k: v for k, v in readings.items() if k not in checks}
    if control:
        result["control_readings"] = ctrl.summary()
    result["checks"] = checks
    return result, checks


def _reports(bench: dict, cell: str, e2e_name: str) -> bool:
    for m in bench["end_to_end"]:
        if m["name"] == e2e_name:
            return "workloads" not in m or cell in m["workloads"]
    return False


def _localize(smp: check.Sample, local: dict) -> check.Sample:
    """A sample whose sequence indices point into the kept inputs' rows."""
    return check.Sample([local[b] for b in smp.seqs], smp.frames, smp.before, smp.outs, smp.after)
