"""Where the port's front end spends a tracked frame on the GPU.

    python3 tools/profile_torch_frontend.py [--camera] [--frames 32] [--trace trace.json]

Runs ``liwslam_torch.frontend.driver.Frontend`` at bench.py's full size
(chip_smoke.py's ``bench_params`` / ``bench_streams``; with ``--camera``
the camera path of chip_smoke.py's ``cam_params`` at 848x480 and 30 Hz)
through its init window and one warm-up chunk, then times one chunk of
tracked frames three ways:

- wall: host clock around ``run_chunk`` ending in ``torch.cuda.synchronize``;
- device busy: the union of the CUDA kernel and memcpy intervals that
  ``torch.profiler`` records over the same chunk, and so the device's idle
  share of the wall time;
- by operator: the profiler's self device time and self host time per
  PyTorch operator and per kernel, and per frame the kernel launches, the
  stream synchronisations and the memcpy calls;
- sync sites: the source lines of one tracking step at which the host
  waits for the device (``torch.cuda.set_sync_debug_mode("warn")``).

Needs a CUDA device; exits non-zero without one.  With ``--trace`` the
profiled chunk's Chrome trace is written there (tens of MB).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import warnings
from collections import Counter

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _dev_time(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)


def _busy_us(events):
    """Length of the union of the device intervals (kernels and copies)."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, t in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, len(spans)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=32, help="tracked frames in the profiled chunk")
    ap.add_argument("--trace", default=None, help="write the Chrome trace of the profiled chunk here")
    ap.add_argument("--camera", action="store_true", help="profile the camera path (848x480, 30 Hz)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_frontend: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke
    from liwslam_torch.frontend.driver import Frontend
    from liwslam_torch.ops import _build

    _build.load()
    dev = torch.device("cuda:0")
    prm = chip_smoke.bench_params()
    if args.camera:
        prm = chip_smoke.cam_params(prm)
    streams = chip_smoke.bench_streams(prm, camera=args.camera)
    images = streams.cam_images if args.camera else None
    fe = Frontend(prm, device=dev)
    frames, lt = fe.pack_frames(streams)
    track, k0, _, _, cam = fe.initialize(frames, lt, images)
    n = args.frames
    if k0 + 2 * n > len(frames):
        raise SystemExit(f"need {2 * n} tracked frames, the track has {len(frames) - k0}")
    if args.camera:
        chunk = lambda st, b: fe.run_chunk_cam(st[0], st[1], b)[0]
        stage = lambda fr: fe.stage(fr, images)
        state = (track, cam)
    else:
        chunk = lambda st, b: fe.run_chunk(st, b)[0]
        stage = fe.stack_frames
        state = track
    state = chunk(state, stage(frames[k0 : k0 + n]))
    batch = stage(frames[k0 + n : k0 + 2 * n])
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    chunk(state, batch)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        chunk(state, batch)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    busy_us, n_dev = _busy_us(prof.events())
    avg = prof.key_averages()
    count = lambda keys: sum(e.count for e in avg if e.key in keys)
    syncs = count(("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"))
    copies = count(("cudaMemcpy", "cudaMemcpyAsync"))
    launches = count(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    by_dev = sorted(avg, key=_dev_time, reverse=True)[:15]
    by_cpu = sorted(avg, key=lambda e: e.self_cpu_time_total, reverse=True)[:15]
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)

    from liwslam_torch.frontend import camera_pipeline as cpl
    from liwslam_torch.frontend import pipeline as pl

    if args.camera:
        # a frame with an accepted camera message, so the sub-step runs
        one = next(b for b in batch if b.cam_valid)
        step = lambda: cpl.tracking_step_cam(state[0], state[1], one, fe.consts, fe.dcfg, fe.scfg, fe.ccfg, fe.cdyn)
    else:
        one = pl.FrameInput(*[t[0] for t in batch])
        step = lambda: pl.tracking_step(state, one, fe.consts, fe.dcfg, fe.scfg)
    sites = Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        # the innermost frame of the package at the synchronising call
        pkg = os.path.join(ROOT, "liwslam_torch")
        ours = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(pkg)]
        if "synchroniz" in str(message) and ours:
            sites[f"{os.path.relpath(ours[-1].filename, ROOT)}:{ours[-1].lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    per = lambda v: v / n
    summary = dict(
        device=torch.cuda.get_device_name(0),
        nvidia_smi=smi,
        path="camera" if args.camera else "laser",
        frames=n,
        wall_ms_per_frame=per(wall_plain * 1e3),
        wall_ms_per_frame_profiled=per(wall_prof * 1e3),
        device_busy_ms_per_frame=per(busy_us / 1e3),
        device_idle_share=1.0 - busy_us / 1e6 / wall_prof,
        device_intervals_per_frame=per(n_dev),
        kernel_launches_per_frame=per(launches),
        stream_syncs_per_frame=per(syncs),
        memcpy_calls_per_frame=per(copies),
        sync_sites_per_step=dict(sites),
        top_device=[(e.key, e.count // n, per(_dev_time(e) / 1e3)) for e in by_dev],
        top_host=[(e.key, e.count // n, per(e.self_cpu_time_total / 1e3)) for e in by_cpu],
    )
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
