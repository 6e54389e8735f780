"""Chip smoke test of the PyTorch/CUDA port (``liwslam_torch``) on one GPU.

    python3 chip_smoke.py [--parent _archive/<tree>]

Phases, one line each (any failed check raises and the exit code is not 0):

1. device: the CUDA device and ``nvidia-smi``'s name and power limit;
2. build: builds (or loads) the hand-written kernels from ``liwslam_torch/
   csrc`` and prints the build seconds and ptxas's register/spill report;
3. kernels against their plain PyTorch versions on the card, on the same
   inputs: B2 (line extraction) on 20 scans of the bench track and at the
   edges of its thread mapping (:func:`check_extract_edges`), B1 (the
   tracking solve) on a two-frame problem with 64 line matches in both
   tracking modes (``fast_mode`` freezes more dims), on a batch of three
   different systems and at M = 1 and M = M_MAX; each kernel is timed by
   its device duration (profiler, median of 60 launches) and by CUDA
   events around each call (median of 60 calls after warm-up), its plain
   version by CUDA events (median of ``PLAIN_CALLS`` calls); B1's device time is also split into a fixed and a
   per-iteration part (:func:`iteration_split`);
4. main path: ``liwslam_torch.frontend.driver.Frontend(device="cuda").run``
   on the synthetic office loop track at bench.py's full size (1080-beam
   scans at 10 Hz, IMU 200 Hz, wheel 20 Hz, noise on, seed 1), with the
   kernels' launch counts set to 0 just before and read just after; checks
   that both kernels ran, and the ATE against ground truth; then the
   whole track with B1's plain version in the loop
   (:func:`check_b1_along_path`) and with B2's plain
   version in the loop on the card, in float32 and in float64
   (:func:`check_b2_along_path`);
4a. B sequences in one batched step (``parallel/multiseq``,
   :func:`run_multiseq`): the bench track with seeds 1..32, simulated and
   initialized in 8 worker processes on the card, each sequence's init
   window timed, then at B = 1, 2, 4, 8, 16, 32 a warm-up
   chunk and a timed chunk of 32 frames and a profiled chunk of 2:
   frames/s in all and a sequence, device busy and idle share, launches a
   step with B1's and B2's (each exactly once a step, counts set to 0
   before and read after), peak memory, and each sequence's poses over its
   first 32 frames against its own single-stream run on the card (within
   1e-3 m; launches at B = 32 within 1.1x B = 1's); at B = 32 every
   sequence's ATE over its common prefix (< 0.02 m);
4b. back end (no TPU kernel of its own; plain PyTorch on the card): the
   main path's result fed to ``KeyframeManager(device="cuda")`` after the
   run (:func:`run_backend_posthoc`: loops, the ATE gate of
   tests/test_loop_e2e.py, ms a keyframe and a solve, launches and syncs,
   peak memory); ``OnlineRunner`` on the same streams with
   B1's and B2's counts set to 0 before and read after (:func:`run_online`:
   the same loops, keyframe poses and checkpoint as a post-hoc feed,
   overlap > 0); ``solve_pcg`` timed at K = 1024, 4096 and 10240, and on
   a graph where it settles held against a float64 CPU solve
   (:func:`check_pcg`); ``score_pairs``' peak memory at P = 256, and at
   P = 128 its tables, counts and bins against the CPU's
   (:func:`check_score_memory`); and the CLI, ``python -m
   liwslam_torch.run``, as a subprocess on a ROS1 bag of the bench
   streams written by the port's own writer under chiprun_out/, with
   ``--debug-viz`` (:func:`run_cli_bag`);
4c. distributed modes (``parallel/posegraph_dist``,
   ``parallel/dist_runner``): the edge-sharded PCG at world size 1 over
   NCCL on :func:`settled_graph`, in float64 within 1e-9 m of the
   unsharded solve and in float32 timed beside it at K = 1024 and 10240
   (:func:`check_pcg_dist`); the two-robot pipeline, 2 ranks over gloo on
   the card at bench.py's widths and rates (:func:`run_two_robots`);
   the composed flow (``dist_runner``'s ``composed`` mode, the port's
   ``dryrun_multichip``): B = 8 W sequences split over W = ``device_count``
   NCCL ranks and, on one card, B = 4 over 2 gloo ranks, one 32-frame
   chunk, the gathered poses against one process's batched run, the
   K = 1024 graph they seed solved edge-sharded; with a second card B1 and
   B2 launched on cuda:1 from a thread on cuda:0 (:func:`run_multicard`);
4d. the moving-obstacle scene: ``Frontend.run`` at bench.py's widths on
   the L track among three moving boxes (:func:`run_dynamic`);
5. camera path: the same ``Frontend.run`` with ``enable_camera`` on the
   same track with bench.py's camera arm at 848x480 and 30 Hz (its pixel
   sigma scaled to the image, ``CAM_SIGMA_PX``), counts set to 0 just
   before and read just after; checks that B1-B4 ran as often as
   the stream asks, the camera gates of tests/test_camera_e2e.py and the
   ATE (< 0.02 m and within 1.5x the laser-only path's);
6. B3 (pyramidal LK) against its plain version on 20 bench image pairs,
   a shifted textured image and the edges of its thread mapping
   (:func:`check_lk_edges`), and B4 (the camera joint solve) on a
   captured camera sub-step, a synthetic problem, a batch of three and the
   (F, Wc) edges of its thread mapping and shared memory, timed like B1,
   and the single-view case (:func:`single_view_spread`);
7. with ``--parent`` (a parent tree unpacked under ``_archive/``), B2
   and B3 built by hand from that tree's sources and timed in turns with
   this tree's (:func:`time_in_turns`: parent, change, change, parent);
8. one JSON object ``{"kernels": [...]}`` with each kernel's launches on its
   main path, error against its plain version, times and bound, registers
   and local memory a thread, and ptxas's spill bytes
   (:func:`kernel_resources`); B1's and B4's rows also carry their fixed
   and per-iteration ms, B1's and B2's their launches in the
   multi-sequence step at B = 32 (``launches_multiseq_b32``), the device
   ms of one launch on 32 systems or scans captured there (``ms_b32``)
   and of its slowest system alone (``ms_b1_slowest``), and the same
   launch and each of its systems alone queued back to back
   (:func:`batch_against_one`); B1's and B2's launches in the composed
   flow's chunk over all ranks (``launches_multicard``).

The last line is ``{"ok": true, "device": {...}}``.  No CPU fallback: the
script exits non-zero when CUDA is not available.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12


# calls the plain PyTorch versions of B1 and B2 are timed over (median)
PLAIN_CALLS = 15


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bench_params():
    """bench.py's single-stream capacities over the office preset
    (``config.BENCH_WIDTHS``)."""
    from liwslam_torch import config

    return config.bench_params()


# bench.py's camera arm (bench.py:108-131) at the office preset's own image
# size (OpenLORIS RealSense colour, 848x480) and camera rate 30 Hz
CAM_WH = (848, 480)
CAM_HZ = 30.0
# bench.py's 6 px sigma was calibrated at 160x120 (BASELINE.md's sweep on
# this track); the synthetic camera's focal length grows with the width, so
# the same angular noise is 6 * 848 / 160 = 31.8 px here.  At 6 px the rows
# are ~5x overconfident and the ATE is ~3x the laser-only path's, as the
# reference's own sweep shows for 1.5 px at 160x120
# (tools/sweep_torch_camera_sigma.py measures both sizes).
CAM_SIGMA_PX = 6.0 * CAM_WH[0] / 160


def cam_params(prm):
    from liwslam_torch.sim import world as sim

    return prm.replace(
        enable_camera=True,
        camera_K=sim.synthetic_camera_K(*CAM_WH),
        T_imu_to_camera=(
            0.0, 0.0, 1.0, 0.05,
            -1.0, 0.0, 0.0, 0.0,
            0.0, -1.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 1.0,
        ),
        camera_sigma=(CAM_SIGMA_PX, CAM_SIGMA_PX),
        max_camera_reproject_error=4.0,
        max_camera_feature_dis=30.0,
        max_feature_num=40,
        feature_min_dis=10.0,
        cam_feature_capacity=48,
        cam_obs_window=8,
        cam_min_obs=4,
        cam_min_parallax=0.01,
    )


def bench_streams(prm, camera=False, seed=1):
    """bench.py's track (seed 1; the multi-sequence phase's sequence b is
    seed 1 + b); with ``camera`` also 848x480 images at 30 Hz (``prm``
    then carries the camera's intrinsics and extrinsic).  The camera draws
    its noise last, so the laser, IMU and wheel streams are the same
    either way (``dist_runner.composed_streams``, which the composed flow's
    ranks simulate)."""
    from liwslam_torch.parallel import dist_runner as dr

    cam = dict(camera_hz=CAM_HZ, camera_wh=CAM_WH) if camera else {}
    return dr.composed_streams(seed, prm, "bench", **cam)


def time_ms(fn, n=60, warm=5):
    """Median device time of one call (CUDA events around each call)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(n):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def kernel_ms(fn, kernel, n=60):
    """Median device duration of the kernel named ``kernel`` over ``n``
    calls of ``fn``, from the profiler's CUDA activity records.  For a
    kernel shorter than the host's enqueue of one call, the CUDA events of
    :func:`time_ms` also measure the host's gap before the launch.

    The profiler may drop activity records of a run (seen for B3's 16 us
    launches, and once three quarters of B4's in a run of 20): it profiles
    up to 12 runs of ``n`` calls until ``n`` records are pooled, and prints
    how many each run kept whenever one kept fewer than ``n``."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    durs, kept, runs = [], [], 12
    for _ in range(runs):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        run = [
            (e.time_range.end - e.time_range.start) / 1e3
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name
        ]
        durs += run
        kept.append(len(run))
        if len(durs) >= n:
            break
    if min(kept) < n:
        print(f"kernel_ms {kernel}: {len(kept)} profiled runs of {n} calls kept {kept} records", flush=True)
    check(len(durs) >= n, f"profiler saw {len(durs)} launches of {kernel} in {runs} profiled runs of {n}")
    return statistics.median(durs[:n])


def queued_ms(fn, n=20, reps=5):
    """Device ms of one call of ``fn`` with the calls back to back on the
    device: ``n`` calls enqueued behind a spin kernel
    (``torch.cuda._sleep``, three times the host's enqueue of the ``n``
    calls), so a kernel shorter than the host's enqueue of its call still
    runs without gaps; CUDA events around the ``n`` calls, the median over
    ``reps``.  Unlike :func:`kernel_ms` it drops no record, and it counts
    the device's own gap between launches."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        # ~2e6 cycles a ms at the H100's clocks (1.6-2.0 GHz)
        torch.cuda._sleep(min(int(3 * n * host_ms * 2e6), 10**9))
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        per.append(s.elapsed_time(e) / n)
    return statistics.median(per)


def one_system(name, args, b):
    """Captured inputs of one launch of kernel ``name`` cut to its system
    (B1) or scan (B2) ``b``."""
    if name == "track_solve":
        return (type(args[0])(*[t[b : b + 1].contiguous() for t in args[0]]), *args[1:])
    return (args[0][b : b + 1].contiguous(), args[1][b : b + 1].contiguous(), *args[2:])


def batch_against_one(name, launch, args):
    """One launch on the B systems or scans captured from the
    multi-sequence step against launches of the same inputs one system at
    a time: queued device ms (:func:`queued_ms`) of the batch and of each
    system alone, then the profiler's device ms (:func:`kernel_ms`) of
    the batch and of its slowest system alone (medians of 20 launches).""" 
    B = (args[0].x0 if name == "track_solve" else args[0]).shape[0]
    call = lambda a: (lambda: launch(*a))
    each = [queued_ms(call(one_system(name, args, b)), reps=2) for b in range(B)]
    slow = int(np.argmax(each))
    out = dict(
        ms_b32=kernel_ms(call(args), f"{name}_kernel", n=20),
        ms_b1_slowest=kernel_ms(call(one_system(name, args, slow)), f"{name}_kernel", n=20),
        queued_ms_b32=queued_ms(call(args)),
        queued_ms_b1_median=float(np.median(each)),
        queued_ms_b1_max=float(max(each)),
    )
    print(
        f"{name} at B={B} (inputs of one launch of the multi-sequence step): one launch {out['ms_b32']:.4f} ms "
        f"on the device, its slowest system ({slow}) alone {out['ms_b1_slowest']:.4f}; queued: the batch "
        f"{out['queued_ms_b32']:.4f} ms, each system alone median {out['queued_ms_b1_median']:.4f} max "
        f"{out['queued_ms_b1_max']:.4f}",
        flush=True,
    )
    return out


def iteration_split(run, kernel, iters=(0, 1, 2, 4, 8), n=20):
    """Fixed and per-iteration device ms of an LM kernel.  ``run(k)``
    launches it with ``max_iters = k`` and returns its outputs, the last of
    which is the iterations it ran.  The device ms of each ``k`` (median of
    ``n`` launches) is fitted by least squares as ``fixed + per_iter *
    iterations``: ``fixed`` is the first linearization and the Schur
    reduction, ``per_iter`` one LM step (factorization, solve, trial
    linearization, bookkeeping)."""
    pts = []
    for k in iters:
        it = int(run(k)[-1][0])
        pts.append((it, kernel_ms(lambda: run(k), kernel, n=n)))
    its = np.array([p[0] for p in pts], float)
    ms = np.array([p[1] for p in pts], float)
    per_iter, fixed = np.polyfit(its, ms, 1) if len(set(its)) > 1 else (float("nan"), ms[0])
    return dict(fixed_ms=float(fixed), per_iter_ms=float(per_iter), points=pts)


def greedy_align(pa, pb, atol):
    """Align two scan-ordered row sets; returns (#matched, #unmatched,
    max |diff| over matched rows).  Tolerates single-row insertions and
    deletions (knife-edge gate flips)."""
    ia = ib = matched = 0
    err = 0.0
    while ia < len(pa) and ib < len(pb):
        if np.allclose(pa[ia], pb[ib], atol=atol):
            err = max(err, float(np.abs(pa[ia] - pb[ib]).max()))
            matched += 1
            ia += 1
            ib += 1
        elif len(pb) - ib > len(pa) - ia:
            ib += 1
        else:
            ia += 1
    return matched, (len(pa) - matched) + (len(pb) - matched), err


# ---------------------------------------------------------------- B2 ----


def check_extract(prm, frames, dev):
    """Kernel B2 against extract_lines_plain on 20 bench scans (1080 noisy
    beams): the CPU test's alignment tolerances (atol 1 cm, line misses <=
    3%, corner misses <= 5%, counts within 1 / 2 per scan).  As a witness of
    the endpoints' rounding, the kernel's lines and the plain version's are
    also aligned with the plain version's in float64."""
    from liwslam_torch.frontend import scan
    from liwslam_torch.ops import extract as ext

    kw = dict(
        continuous_threshold=prm.line_continuous_threshold,
        min_len=prm.line_min_len,
        max_dis=prm.line_max_dis,
        tolerance_angle_rad=prm.line_max_tolerance_angle_rad,
        max_lines=prm.max_lines,
    )
    sel = np.linspace(0, len(frames) - 1, 20).astype(int)
    n_lines = line_miss = n_corners = corner_miss = 0
    err = err64 = err_plain64 = 0.0
    for k in sel:
        pts = torch.as_tensor(frames[k].points, device=dev)
        valid = torch.as_tensor(frames[k].point_valid, device=dev)
        e1, e2, lv, _ = ext.extract_lines_plain(pts.double(), valid, **kw)
        l64 = torch.cat([e1, e2], 1).cpu().numpy()[lv.cpu().numpy()]
        outs = []
        for fn in (ext.extract_lines, ext.extract_lines_plain):
            e1, e2, lv, gap = fn(pts, valid, **kw)
            c, cv = scan._find_corners(e1, e2, lv, prm.laser_resolution, prm.max_corners, end_gap=gap)
            lv, cv = lv.cpu().numpy(), cv.cpu().numpy()
            outs.append((torch.cat([e1, e2], 1).cpu().numpy()[lv], c.cpu().numpy()[cv]))
        (la, ca), (lb, cb) = outs
        check(abs(len(la) - len(lb)) <= 1, f"B2 scan {k}: {len(la)} vs {len(lb)} lines")
        check(abs(len(ca) - len(cb)) <= 2, f"B2 scan {k}: {len(ca)} vs {len(cb)} corners")
        _, miss, e = greedy_align(la, lb, 1e-2)
        _, cmiss, _ = greedy_align(ca, cb, 1e-2)
        n_lines += max(len(la), len(lb))
        line_miss += miss
        n_corners += max(len(ca), len(cb))
        corner_miss += cmiss
        err = max(err, e)
        err64 = max(err64, greedy_align(la, l64, 1e-2)[2])
        err_plain64 = max(err_plain64, greedy_align(lb, l64, 1e-2)[2])
    check(n_lines > 0, "B2: no lines extracted")
    check(line_miss <= max(2, 0.03 * n_lines), f"B2: {line_miss} of {n_lines} lines unmatched")
    check(corner_miss <= max(2, 0.05 * n_corners), f"B2: {corner_miss} of {n_corners} corners unmatched")
    edge_err = check_extract_edges(prm, frames, dev)

    pts = torch.as_tensor(frames[sel[0]].points, device=dev)
    valid = torch.as_tensor(frames[sel[0]].point_valid, device=dev)
    call_ms = time_ms(lambda: ext.extract_lines(pts, valid, **kw))
    ms = kernel_ms(lambda: ext.extract_lines(pts, valid, **kw), "extract_lines_kernel")
    plain_ms = time_ms(lambda: ext.extract_lines_plain(pts, valid, **kw), n=PLAIN_CALLS, warm=2)
    N, L = pts.shape[0], prm.max_lines
    # bytes: points + valid in, e1 + e2 + line_valid + end_gap out
    nbytes = N * 3 * 4 + N + L * (2 * 2 * 4 + 1 + 4)
    # operations: ~230 f32 ops a point (7 prefix-sum columns, gaps and
    # centroid ~20, corner response ~25, NMS ~15, joint test ~30 with acos,
    # TLS fit and projections ~80, span distance ~6, gates ~10), counted
    # from the source
    nops = 230 * N
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, nops / F32_FLOP_S * 1e3
    rsc = kernel_resources("extract_lines")
    print(
        f"B2 extract_lines: {len(sel)} scans, {n_lines} lines ({line_miss} unmatched), "
        f"{n_corners} corners ({corner_miss} unmatched), max endpoint err {err:.3e} m (edges {edge_err:.3e}; "
        f"against the float64 plain version: kernel {err64:.3e}, float32 plain {err_plain64:.3e}); "
        f"kernel {ms:.4f} ms on the device ({call_ms:.4f} ms a call), plain {plain_ms:.4f} ms a call; {rsc}",
        flush=True,
    )
    return dict(
        name="extract_lines",
        route="cuda",
        source="liwslam_torch/csrc/extract_lines.cu",
        replaces="liwslam/ops/extract.py:377",
        max_abs_err=max(err, edge_err),
        max_err_vs_float64=err64,
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,
        call_ms=call_ms,
        **rsc,
    )


def _lines_and_corners(prm, e1, e2, lv, gap):
    """One scan's valid line rows [e1 e2] and corners, on the host."""
    from liwslam_torch.frontend import scan

    c, cv = scan._find_corners(e1, e2, lv, prm.laser_resolution, prm.max_corners, end_gap=gap)
    lv, cv = lv.cpu().numpy(), cv.cpu().numpy()
    return torch.cat([e1, e2], 1).cpu().numpy()[lv], c.cpu().numpy()[cv]


def _polyline(corners, n):
    """n points evenly along the polyline through ``corners`` (one unbroken
    segment while the spacing is below the continuity gap), (n,3) float32
    with a zero third column."""
    corners = np.asarray(corners, np.float64)
    seg = np.diff(corners, axis=0)
    lens = np.linalg.norm(seg, axis=1)
    s = np.arange(n) * (lens.sum() / n)
    k = np.minimum(np.searchsorted(np.cumsum(lens), s, side="right"), len(lens) - 1)
    t = (s - np.concatenate([[0.0], np.cumsum(lens)])[k]) / lens[k]
    xy = corners[k] + t[:, None] * seg[k]
    return np.concatenate([xy, np.zeros((n, 1))], 1).astype(np.float32)


def check_extract_edges(prm, frames, dev):
    """Kernel B2 at the edges of its thread mapping, against
    extract_lines_plain, with check_extract's tolerances per case (counts
    within 1 line / 2 corners, atol 1 cm, <= 3% of lines and 5% of corners
    unmatched over the cases): N not a multiple of the points a thread owns
    (a bench scan cut to 1151 and 1000 points), an all-invalid scan, one
    unbroken segment (a room outline, 1.6 cm between points), more winners
    than L (a bench scan with L = 4, and a 1152-point zigzag of 119 lines
    at L = 64: the first L rows), and a batch of B = 3 bench scans in one
    launch against three plain calls."""
    from liwslam_torch.ops import extract as ext

    kw = dict(
        continuous_threshold=prm.line_continuous_threshold,
        min_len=prm.line_min_len,
        max_dis=prm.line_max_dis,
        tolerance_angle_rad=prm.line_max_tolerance_angle_rad,
        max_lines=prm.max_lines,
    )
    k0, k1, k2 = (len(frames) * q // 4 for q in (1, 2, 3))
    scan = lambda k: (torch.as_tensor(frames[k].points, device=dev), torch.as_tensor(frames[k].point_valid, device=dev))
    pts, val = scan(k0)
    room = _polyline([(0, 0), (4, 0), (4, 3), (1, 3), (1, 5), (-2, 5), (-2, 1)], 1152)
    zig = _polyline([(0.25 * j, 0.4 * (j % 2)) for j in range(120)], 1152)
    cases = [
        ("N=1151", pts[:1151].contiguous(), val[:1151].contiguous(), kw),
        ("N=1000", pts[:1000].contiguous(), val[:1000].contiguous(), kw),
        ("all invalid", pts, torch.zeros_like(val), kw),
        ("one segment", torch.as_tensor(room, device=dev), torch.ones(1152, dtype=torch.bool, device=dev), kw),
        ("L=4", pts, val, dict(kw, max_lines=4)),
        ("zigzag", torch.as_tensor(zig, device=dev), torch.ones(1152, dtype=torch.bool, device=dev), kw),
    ]
    outs = [(name, ext.extract_lines(p, v, **k), ext.extract_lines_plain(p, v, **k), k) for name, p, v, k in cases]
    bp, bv = zip(*(scan(k) for k in (k0, k1, k2)))
    batch = ext.extract_lines_batched(torch.stack(bp), torch.stack(bv), **kw)
    for b in range(3):
        outs.append((f"batch {b}", tuple(t[b] for t in batch), ext.extract_lines_plain(bp[b], bv[b], **kw), kw))
    n_lines = line_miss = n_corners = corner_miss = 0
    err = 0.0
    counts = {}
    for name, ok_k, ok_p, k in outs:
        (la, ca), (lb, cb) = _lines_and_corners(prm, *ok_k), _lines_and_corners(prm, *ok_p)
        check(abs(len(la) - len(lb)) <= 1, f"B2 {name}: {len(la)} vs {len(lb)} lines")
        check(abs(len(ca) - len(cb)) <= 2, f"B2 {name}: {len(ca)} vs {len(cb)} corners")
        check(len(la) <= k["max_lines"], f"B2 {name}: {len(la)} lines > L")
        _, miss, e = greedy_align(la, lb, 1e-2)
        _, cmiss, _ = greedy_align(ca, cb, 1e-2)
        n_lines += max(len(la), len(lb))
        line_miss += miss
        n_corners += max(len(ca), len(cb))
        corner_miss += cmiss
        err = max(err, e)
        counts[name] = len(la)
        # rows past the winners are zero in both
        lv = ok_k[2].cpu().numpy()
        check(not np.any(ok_k[0].cpu().numpy()[~lv]) and not np.any(ok_k[3].cpu().numpy()[~lv]), f"B2 {name}: rows past the winners not zeroed")
    check(counts["all invalid"] == 0, f"B2 all invalid: {counts['all invalid']} lines")
    check(counts["one segment"] >= 4, f"B2 one segment: {counts['one segment']} lines")
    check(counts["L=4"] == 4 and counts["zigzag"] == prm.max_lines, f"B2 truncation: {counts}")
    check(line_miss <= max(2, 0.03 * n_lines), f"B2 edges: {line_miss} of {n_lines} lines unmatched")
    check(corner_miss <= max(2, 0.05 * n_corners), f"B2 edges: {corner_miss} of {n_corners} corners unmatched")
    print(
        f"B2 edges: lines {json.dumps(counts)}, {line_miss} of {n_lines} lines and {corner_miss} of "
        f"{n_corners} corners unmatched, max endpoint err {err:.3e} m",
        flush=True,
    )
    return err


# ---------------------------------------------------------------- B1 ----


def b1_problem(prm, dev, M=64, fast_mode=False, seed=3, perturb=1.0):
    """A two-frame tracking solve in the tracking layout (see
    :func:`two_frame_problem`); the prior is left out in ``fast_mode``, as
    on the tracking path."""
    from liwslam_torch.ops import track_solve

    x0, data, consts, _ = two_frame_problem(prm, dev, M, with_prior=not fast_mode, seed=seed, perturb=perturb)
    free, frozen = track_solve.tracking_free_mask(fast_mode)
    return track_solve.pack_inputs(x0, torch.as_tensor(free, device=dev), data, consts), frozen


_L_TRACK_STREAMS = {}


def _l_track_streams(prm):
    """The simulator's L track in the square room (IMU 200 Hz, laser 10
    Hz), simulated once for each parameter set."""
    from liwslam_torch.sim import world as sim

    key = repr(prm)
    if key not in _L_TRACK_STREAMS:
        track = sim.default_track("L")
        _L_TRACK_STREAMS[key] = track, sim.simulate(track, sim.square_room(), prm, imu_hz=200, laser_hz=10)
    return _L_TRACK_STREAMS[key]


def two_frame_problem(prm, dev, M=64, with_prior=True, seed=3, perturb=1.0):
    """Ground-truth states at scans 40, 41 of the simulator's L track, the
    IMU and wheel preintegration between them, M synthetic wall lines seen
    from both frames with 5 mm noise (30% of the rows masked; lines and
    noise drawn from ``seed``), an SPD prior on frame 0 (``with_prior``),
    and frame 1 perturbed (``perturb`` scales the perturbation).  Returns
    (x0, FactorData, SolveConsts, x_true)."""
    from liwslam_torch.core import geometry as geo
    from liwslam_torch.frontend import preintegration as pre
    from liwslam_torch.solve import factors as fac

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    track, streams = _l_track_streams(prm)
    t0, t1 = int(streams.laser_t_us[40]), int(streams.laser_t_us[41])
    Tiw_inv = np.linalg.inv(prm.mat_T_imu_to_wheel())

    def state_at(t_us):
        t, h = t_us * 1e-6, 1e-4
        p, q = geo.log_SE3(f32(track.pose(t) @ Tiw_inv))
        v = ((track.pose(t + h) @ Tiw_inv)[:3, 3] - (track.pose(max(t - h, 0)) @ Tiw_inv)[:3, 3]) / (2 * h)
        return p, q, f32(v)

    (p0, q0, v0), (p1, q1, v1) = state_at(t0), state_at(t1)
    z6 = torch.zeros(6, dtype=torch.float32, device=dev)
    x_true = torch.cat([p0, q0, v0, z6, p1, q1, v1, z6])

    sel = (streams.imu_t_us > t0) & (streams.imu_t_us <= t1)
    prev = np.where(streams.imu_t_us <= t0)[0][-1]
    ic = pre.imu_reset(0, z6[:3], z6[3:])._replace(
        last_acc=f32(streams.imu_acc[prev]),
        last_gyro=f32(streams.imu_gyro[prev]),
        has_sample=torch.ones((), dtype=torch.bool, device=dev),
    )
    ic = pre.imu_interval_parallel(
        ic, f32(streams.imu_acc[sel]), f32(streams.imu_gyro[sel]),
        torch.as_tensor((streams.imu_t_us[sel] - t0).astype(np.int32), device=dev),
        torch.ones(int(sel.sum()), dtype=torch.bool, device=dev),
        torch.tensor(t1 - t0, dtype=torch.int32, device=dev), pre.imu_noise_Q(prm, dev),
    )
    imu = pre.imu_result(ic)
    selw = (streams.wheel_t_us > t0) & (streams.wheel_t_us <= t1)
    prevw = np.where(streams.wheel_t_us <= t0)[0][-1]
    wc = pre.wheel_reset(0, dev)._replace(
        last_pose=f32(streams.wheel_pose[prevw]),
        last_pose_t_us=torch.tensor(int(streams.wheel_t_us[prevw] - t0), dtype=torch.int32, device=dev),
        has_sample=torch.ones((), dtype=torch.bool, device=dev),
    )
    wc = pre.wheel_add_samples(
        wc, f32(streams.wheel_pose[selw]),
        torch.as_tensor((streams.wheel_t_us[selw] - t0).astype(np.int32), device=dev),
        torch.ones(int(selw.sum()), dtype=torch.bool, device=dev),
    )
    wc = pre.wheel_update_only_t(wc, torch.tensor(t1 - t0, dtype=torch.int32, device=dev))
    wheel = pre.wheel_result(wc, f32(prm.wheel_sigma))

    consts = fac.make_consts(prm, dev)
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, np.pi, M)
    c0 = rng.uniform(-3, 3, (M, 2))
    u = np.stack([np.cos(ang), np.sin(ang)], -1)
    w1 = np.concatenate([c0 - u, np.zeros((M, 1))], -1)
    w2 = np.concatenate([c0 + u, np.zeros((M, 1))], -1)
    Til = prm.mat_T_imu_to_laser()
    T0 = geo.make_tf(p0, q0).cpu().double().numpy() @ Til
    T1 = geo.make_tf(p1, q1).cpu().double().numpy() @ Til
    to = lambda T, w: (np.linalg.inv(T) @ np.concatenate([w, np.ones((M, 1))], -1).T).T[:, :3]
    valid = rng.random(M) > 0.3
    n1 = rng.normal(0, 5e-3, (M, 3)) * [1, 1, 0]
    n2 = rng.normal(0, 5e-3, (M, 3)) * [1, 1, 0]
    A = rng.normal(size=(15, 15)).astype(np.float32) * 0.3
    eye = lambda n: torch.eye(n, dtype=torch.float32, device=dev)
    two = lambda a, b: torch.stack([a, b])
    data = fac.FactorData(
        imu_X=two(torch.zeros(15, device=dev), imu.X),
        imu_J=two(eye(15), imu.J),
        imu_sqrtP=two(eye(15), imu.sqrt_inverse_P),
        imu_Dt=two(torch.zeros((), device=dev), imu.Dt),
        imu_valid=torch.tensor([False, True], device=dev),
        wheel_dT=two(eye(4), wheel.delta_T),
        wheel_sqrt=two(eye(3), wheel.sqrt_inverse_P),
        wheel_valid=torch.tensor([False, True], device=dev),
        laser_l1p1=f32(to(T0, w1)),
        laser_l1p2=f32(to(T0, w2)),
        laser_l2p1=f32(to(T1, w1) + n1),
        laser_l2p2=f32(to(T1, w2) + n2),
        laser_i_idx=torch.full((M,), -1, dtype=torch.int32, device=dev),
        laser_j_idx=torch.ones(M, dtype=torch.int32, device=dev),
        laser_ref_p=p0[None].expand(M, 3),
        laser_ref_q=q0[None].expand(M, 3),
        laser_valid=torch.as_tensor(valid, device=dev),
        ground_weight=torch.tensor(np.sqrt(2.0), dtype=torch.float32, device=dev),
        frame_valid=torch.ones(2, dtype=torch.bool, device=dev),
        prior_J=f32(A + 5.0 * np.eye(15)) if with_prior else eye(15),
        prior_X=x_true[:15] + 0.01 if with_prior else torch.zeros(15, device=dev),
        prior_res=torch.zeros(15, device=dev),
        prior_idx=torch.zeros((), dtype=torch.int32, device=dev),
        prior_valid=torch.tensor(with_prior, device=dev),
    )
    x0 = x_true.clone()
    x0[15:18] += f32([0.04, -0.03, 0.01]) * perturb
    x0[18:21] += f32([0.01, -0.01, 0.02]) * perturb
    x0[21:24] += f32([0.03, 0.0, -0.02]) * perturb
    return x0, data, consts, x_true


def schur_gap(dH, dH_ref):
    """Largest |v^T dH v - v^T dH_ref v| over 16 random unit vectors v, as
    a share of max(|v^T dH_ref v|, 1e-4 of dH_ref's largest entry): how far
    a Schur-reduced information matrix lies from a reference."""
    rng = np.random.default_rng(5)
    scale = np.abs(dH_ref).max()
    gap = 0.0
    for _ in range(16):
        v = rng.normal(size=15)
        v /= np.linalg.norm(v)
        q, q_ref = v @ dH @ v, v @ dH_ref @ v
        gap = max(gap, abs(q - q_ref) / max(abs(q_ref), 1e-4 * scale))
    return gap


def schur_float64(inp, x):
    """(dH (B,15,15), dg (B,15)): each system's Schur reduction of frame 0
    from a float64 linearization at its solution x (B,30).  At one line
    match the reduction cancels frame 0's prior against the IMU's
    information, and a float32 Jacobian loses the reduced form there (the
    kernel and the plain version each by its own rounding): the M = 1
    check holds the kernel to this reference."""
    from liwslam_torch.ops import track_solve as ts

    out = []
    for b in range(x.shape[0]):
        inp64 = ts.TrackSolveInputs(*[t[b : b + 1].double() for t in inp])
        r, J = ts.linearize(lambda y: ts.residual(y, inp64), x[b].double())
        out.append(ts.schur_frame0(J, r))
    return tuple(torch.stack(o) for o in zip(*out))


def _check_b1(inp, frozen, max_iters, name="", schur64=False):
    """Kernel B1 against lm_solve_track_plain on the same inputs, each of
    the B systems against its own plain run: poses atol 5e-4, whole x atol
    2e-3, cost <= 1.02x the plain cost, Schur quadratic forms within 10%
    (:func:`schur_gap`), dg within 1e-4 of the dH scale; with ``schur64``
    the Schur forms against :func:`schur_float64` at the plain solution.
    Returns (max |x err|, kernel iterations, plain iterations, kernel
    cost, plain cost) of system 0, the error over all systems."""
    from liwslam_torch.ops import track_solve as ts

    outk = ts.lm_solve_track_batched(inp, max_iters=max_iters, frozen_dims=frozen)
    outp = ts.lm_solve_track_plain(inp, max_iters=max_iters)
    if schur64:
        outp = (outp[0], outp[1], *schur_float64(inp, outp[0]), outp[4])
    torch.cuda.synchronize()
    err = 0.0
    for b in range(inp.x0.shape[0]):
        tag = f"B1 {name} system {b}"
        n = lambda t: t[b].cpu().double().numpy()
        xk, ck, dHk, dgk, _ = map(n, outk)
        xp, cp, dHp, dgp, _ = map(n, outp)
        ck, cp = float(ck), float(cp)
        check(np.all(np.isfinite(xk)) and np.isfinite(ck), f"{tag}: non-finite output")
        check(np.abs(xk[15:21] - xp[15:21]).max() < 5e-4, f"{tag}: pose err {np.abs(xk[15:21] - xp[15:21]).max()}")
        e = float(np.abs(xk - xp).max())
        check(e < 2e-3, f"{tag}: x err {e}")
        check(ck <= cp * 1.02, f"{tag}: cost {ck} vs plain {cp}")
        gap = schur_gap(dHk, dHp)
        check(gap < 0.10, f"{tag}: Schur forms {100 * gap:.1f}% from the reference's")
        check(np.abs(dgk - dgp).max() < 1e-4 * np.abs(dHp).max(), f"{tag}: dg err {np.abs(dgk - dgp).max()}")
        err = max(err, e)
    return err, int(outk[4][0]), int(outp[4][0]), float(outk[1][0]), float(outp[1][0])


def stack_inputs(inps):
    """B = len(inps) systems in one kernel input (a NamedTuple of tensors,
    nested NamedTuples concatenated field by field)."""
    first = inps[0]
    return type(first)(*[
        stack_inputs(list(parts)) if isinstance(parts[0], tuple) else torch.cat(parts).contiguous()
        for parts in zip(*inps)
    ])


def kernel_resources(name):
    """Registers and local memory (stack frame, spills included) a thread
    of source ``name``'s kernel, as the loaded module reports them
    (``liwslam_<name>_attributes``: cudaFuncGetAttributes), and the bytes
    of spill stores in the ptxas report of the source's build in this
    process, the functions the kernel calls included (None when this
    process loaded an earlier build and so saw no report)."""
    import ctypes
    import re

    from liwslam_torch.ops import _build

    fn = getattr(_build.load()[name], f"liwslam_{name}_attributes")
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = fn(ctypes.byref(regs), ctypes.byref(local))
    check(err == 0, f"{name}: cudaFuncGetAttributes failed, cudaError_t {err}")
    log = _build.build_info[name]["log"]
    spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log)) if log else None
    return dict(regs=regs.value, local_bytes=local.value, spill_bytes=spill)


def m1_schur_by_seed(prm, dev, frozen, max_iters, seeds=range(3, 11)):
    """A known tolerance shared with the reference, printed and not
    checked: at one line match (M = 1) the kernel's and the plain
    version's (float32, on the CPU) Schur forms, each against
    :func:`schur_float64` at the plain solution, over eight seeds of the
    two-frame problem (seed 3 is the one checked).  The reference's
    kernel loses as much there (tests/test_torch_solve.py::
    test_m1_schur_loss_is_shared_with_the_reference)."""
    from liwslam_torch.ops import track_solve as ts

    rows = []
    for seed in seeds:
        inp = b1_problem(prm, dev, M=1, fast_mode=prm.fast_mode, seed=seed)[0]
        outk = ts.lm_solve_track_batched(inp, max_iters=max_iters, frozen_dims=frozen)
        cpu = type(inp)(*[t.cpu() for t in inp])
        outp = ts.lm_solve_track_plain(cpu, max_iters=max_iters)
        dH64 = schur_float64(cpu, outp[0])[0][0].numpy()
        n = lambda o: o[2][0].cpu().double().numpy()
        rows.append((seed, schur_gap(n(outk), dH64), schur_gap(n(outp), dH64)))
    print(
        "B1 at M=1, Schur forms from the float64 reduction (kernel / plain float32 on the CPU), by seed: "
        + ", ".join(f"{s}: {100 * k:.1f}% / {100 * p:.1f}%" for s, k, p in rows),
        flush=True,
    )


def check_track_solve(prm, dev):
    """Kernel B1 against its plain version in both tracking modes (the
    frozen-dim skip differs), on a batch of three different systems (the
    per-block indexing) and at the edges of its thread mapping (M = 1 and
    M = M_MAX line matches); timed in the main path's mode, with the fixed
    and per-iteration split of its device time."""
    from liwslam_torch.ops import track_solve as ts

    mi = prm.solver_max_iterations
    err = 0.0
    for fast in (True, False):
        inp_f, frozen_f = b1_problem(prm, dev, fast_mode=fast)
        e, it_k, it_p, ck, cp = _check_b1(inp_f, frozen_f, mi, "fast_mode" if fast else "full")
        err = max(err, e)
        if fast == prm.fast_mode:
            inp, frozen, itk, itp, costs = inp_f, frozen_f, it_k, it_p, (ck, cp)
    batch = [
        b1_problem(prm, dev, fast_mode=prm.fast_mode, seed=seed, perturb=pt)[0]
        for seed, pt in ((4, 0.5), (5, 1.5), (6, -1.0))
    ]
    err = max(err, _check_b1(stack_inputs(batch), frozen, mi, "batch of 3")[0])
    for M in (1, ts.M_MAX):
        inp_m = b1_problem(prm, dev, M=M, fast_mode=prm.fast_mode)[0]
        err = max(err, _check_b1(inp_m, frozen, mi, f"M={M}", schur64=M == 1)[0])
    m1_schur_by_seed(prm, dev, frozen, mi)
    kw = dict(max_iters=mi, frozen_dims=frozen)
    call_ms = time_ms(lambda: ts.lm_solve_track_batched(inp, **kw))
    ms = kernel_ms(lambda: ts.lm_solve_track_batched(inp, **kw), "track_solve_kernel")
    plain_ms = time_ms(lambda: ts.lm_solve_track_plain(inp, max_iters=mi), n=PLAIN_CALLS, warm=2)
    split = iteration_split(
        lambda k: ts.lm_solve_track_batched(inp, max_iters=k, early_exit=False, frozen_dims=frozen),
        "track_solve_kernel",
    )
    rsc = kernel_resources("track_solve")
    M = inp.laser.shape[1]
    n_lin = itk + 1
    nbytes = sum(t.numel() * 4 for t in inp) + (30 + 1 + 225 + 15 + 1) * 4
    # operations per linearization, counted from the source: dual-number
    # residuals with 6 tangents (~7 ops per scalar op): 64 laser matches x
    # ~450 scalar ops, IMU 5 passes x ~1500, wheel 2 x ~1200, ground 2 x
    # ~400, whitening 5 x 1260; H (900 entries x 37 rows + the 6x6 laser
    # block x 2M rows), g and the cost, 2 ops per multiply-add
    lin_ops = 7 * (M * 450 + 5 * 1500 + 2 * 1200 + 2 * 400) + 5 * 1260 + 2 * (
        900 * 37 + 36 * 2 * M + 30 * 37 + 6 * 2 * M + 37 + 2 * M
    )
    # per LM step: 30x30 Cholesky (~9000 ops) + two triangular solves (~1800)
    # + scaling (~2000); Schur: 15x15 Cholesky, 16 solves, 15x15x15 product
    nops = n_lin * lin_ops + (n_lin - 1) * 12800 + (2300 + 16 * 450 + 2 * 3375)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, nops / F32_FLOP_S * 1e3
    print(
        f"B1 track_solve: M={M}, kernel {itk} / plain {itp} LM iterations, max |x err| {err:.3e} "
        f"(both modes, a batch of 3, M=1 and M={ts.M_MAX}), cost {costs[0]:.6g} vs {costs[1]:.6g}; "
        f"kernel {ms:.4f} ms on the device ({call_ms:.4f} ms a call; fixed {split['fixed_ms']:.4f} + "
        f"{split['per_iter_ms']:.4f} an iteration), plain {plain_ms:.4f} ms a call; {rsc}",
        flush=True,
    )
    return dict(
        name="track_solve",
        route="cuda",
        source="liwslam_torch/csrc/track_solve.cu",
        replaces="liwslam/ops/track_solve.py:829",
        max_abs_err=err,
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,
        call_ms=call_ms,
        fixed_ms=split["fixed_ms"],
        per_iter_ms=split["per_iter_ms"],
        **rsc,
    )


# --------------------------------------------------------- main path ----


def tracked_ate(res, streams, tracked, where):
    """ATE (m, aligned) of the last ``tracked`` frames of a Frontend.run
    result against the simulator's ground truth."""
    from liwslam_torch.eval import metrics

    pairs = metrics.associate_by_time(res.t_us[-tracked:], streams.gt_t_us)
    check(len(pairs) == tracked, f"{where}: frames without ground truth")
    est = res.T_w_imu()[-tracked:][pairs[:, 0]]
    return metrics.ate_rmse(est, streams.gt_T_w_imu[pairs[:, 1]], align=True)


def run_main_path(prm, streams, dev):
    """Frontend.run at bench size; returns (launches, ATE, the result,
    tracked frames/s)."""
    from liwslam_torch.frontend.driver import Frontend
    from liwslam_torch.ops import extract as ext
    from liwslam_torch.ops import track_solve as ts

    fe = Frontend(prm, device=dev)
    stamps = []

    def on_chunk(info):
        stamps.append((time.perf_counter(), info["n"]))

    ext.extract_lines_batched.launches = 0
    ts.lm_solve_track_batched.launches = 0
    t0 = time.perf_counter()
    res = fe.run(streams, chunk_size=64, chunk_callback=on_chunk)
    wall = time.perf_counter() - t0
    launches = dict(
        extract_lines=ext.extract_lines_batched.launches,
        track_solve=ts.lm_solve_track_batched.launches,
    )
    n_init = int(len(res.t_us) - sum(n for _, n in stamps))
    tracked = len(res.t_us) - n_init
    check(len(stamps) >= 2, "main path: need at least two chunks (one is warm-up)")
    fps = sum(n for _, n in stamps[1:]) / (stamps[-1][0] - stamps[0][0])
    check(np.all(np.isfinite(res.p)) and res.p.shape == (len(res.t_us), 3), "main path: bad poses")
    ate = tracked_ate(res, streams, tracked, "main path")
    check(launches["extract_lines"] >= n_init + tracked, f"B2 launches {launches} < {n_init} + {tracked}")
    check(launches["track_solve"] == tracked, f"B1 launches {launches} != {tracked} tracked frames")
    check(ate < 0.02, f"main path ATE {ate} m >= 0.02 m")
    print(
        f"main path: frames={len(res.t_us)} init_window={n_init} tracked={tracked} "
        f"tracked_fps={fps:.1f} (after a {stamps[0][1]}-frame warm-up chunk) "
        f"ATE={ate:.4f}m wall={wall:.1f}s launches={json.dumps(launches)}",
        flush=True,
    )
    return launches, ate, res, fps


def check_b1_along_path(prm, streams, dev, laser_ate):
    """The laser-only main path again with B1's plain version in the loop
    (on the CPU, float32: ~0.1 s a call there against ~0.7 s on the card)
    and the kernel launched beside it on each of the same inputs.  Prints
    the plain loop's ATE beside the kernel loop's and, per tracked frame,
    how far the kernel's solution lies from the plain version's (poses
    x[15:21] and whole x) and whether their LM iterations agree; then, for
    the four frames where the two lie farthest apart, where the plain
    version run in float64 on the same inputs lands.  Checks the plain
    loop's ATE < 0.02 m."""
    from liwslam_torch.frontend.driver import Frontend
    from liwslam_torch.ops import track_solve as ts

    kernel = ts.lm_solve_track_batched
    # per tracked frame: (pose err, x err, kernel iterations, plain
    # iterations, the inputs on the CPU, the solve's options, kernel x,
    # plain x)
    per_frame = []
    pose_err = lambda a, b: float((a[:, 15:21] - b[:, 15:21]).abs().max())

    def plain_beside_kernel(inp, *, max_iters, ftol, xtol, early_exit, frozen_dims):
        outk = kernel(inp, max_iters=max_iters, ftol=ftol, xtol=xtol, early_exit=early_exit, frozen_dims=frozen_dims)
        cpu = type(inp)(*[t.cpu() for t in inp])
        kw = dict(max_iters=max_iters, ftol=ftol, xtol=xtol, early_exit=early_exit)
        outp = ts.lm_solve_track_plain(cpu, **kw)
        xk, xp = outk[0].cpu().double(), outp[0].double()
        per_frame.append((
            pose_err(xk, xp), float((xk - xp).abs().max()), int(outk[4][0]), int(outp[4][0]), cpu, kw, xk, xp,
        ))
        return tuple(t.to(dev) for t in outp)

    # the kernel's wrapper counts its launches on the module's name, which
    # names this function while it runs
    plain_beside_kernel.launches = 0
    ts.lm_solve_track_batched = plain_beside_kernel
    try:
        t0 = time.perf_counter()
        res = Frontend(prm, device=dev).run(streams, chunk_size=64)
        wall = time.perf_counter() - t0
    finally:
        ts.lm_solve_track_batched = kernel
    tracked = len(per_frame)
    check(tracked > 0 and np.all(np.isfinite(res.p)), "B1 plain loop: no tracked frames or bad poses")
    ate = tracked_ate(res, streams, tracked, "B1 plain loop")
    check(ate < 0.02, f"B1 plain loop: ATE {ate} m >= 0.02 m")
    pe, xe, itk, itp = (np.array(c) for c in list(zip(*per_frame))[:4])
    same = itk == itp
    print(
        f"B1 along the main path: with the plain version in the loop ATE={ate:.4f}m (kernel loop "
        f"{laser_ate:.4f}m, wall {wall:.1f}s); kernel vs plain on each of its {tracked} tracked frames' "
        f"inputs: pose err median {np.median(pe):.3e} p99 {np.quantile(pe, 0.99):.3e} max {pe.max():.3e}, "
        f"x err median {np.median(xe):.3e} max {xe.max():.3e}, LM iterations equal on {int(same.sum())}",
        flush=True,
    )
    for k in np.argsort(-pe)[:4]:
        _, _, ik, ip, cpu, kw, xk, xp = per_frame[k]
        o64 = ts.lm_solve_track_plain(type(cpu)(*[t.double() for t in cpu]), **kw)
        x64 = o64[0]
        print(
            f"  frame {k}: poses apart by kernel-plain {pe[k]:.3e}, kernel-plain64 {pose_err(xk, x64):.3e}, "
            f"plain-plain64 {pose_err(xp, x64):.3e}; LM iterations kernel {ik}, plain {ip}, plain64 "
            f"{int(o64[4][0])}",
            flush=True,
        )


def check_b2_along_path(prm, streams, dev, laser_ate):
    """The laser-only main path again with B2's plain version in the loop
    on the card, once in float32 and once in float64 (the scan cast up,
    the lines cast back), each beside the kernel loop's ATE: a witness of
    how far the trajectory moves with the extraction's rounding.  Checks
    each loop's ATE < 0.02 m."""
    from liwslam_torch.frontend.driver import Frontend
    from liwslam_torch.ops import extract as ext

    kernel = ext.extract_lines_batched
    out = {}
    for dtype in (torch.float32, torch.float64):

        def plain(points, valid, **kw):
            rows = [ext.extract_lines_plain(p.to(dtype), v, **kw) for p, v in zip(points, valid)]
            return tuple(
                torch.stack(c).to(torch.float32) if c[0].is_floating_point() else torch.stack(c) for c in zip(*rows)
            )

        # the wrapper counts its launches on the module's name
        plain.launches = 0
        ext.extract_lines_batched = plain
        try:
            t0 = time.perf_counter()
            res = Frontend(prm, device=dev).run(streams, chunk_size=64)
            wall = time.perf_counter() - t0
        finally:
            ext.extract_lines_batched = kernel
        tracked = len(res.t_us) - prm.slide_window_size
        ate = tracked_ate(res, streams, tracked, f"B2 plain {dtype} loop")
        check(ate < 0.02, f"B2 plain {dtype} loop: ATE {ate} m >= 0.02 m")
        out[str(dtype).removeprefix("torch.")] = (ate, wall)
    print(
        "B2 along the main path: with the plain version in the loop on the card "
        + ", ".join(f"{k} ATE={a:.4f}m (wall {w:.1f}s)" for k, (a, w) in out.items())
        + f"; kernel loop ATE={laser_ate:.4f}m",
        flush=True,
    )


# ----------------------------------------------------------- multiseq ----

MULTISEQ_B = (1, 2, 4, 8, 16, 32)
MULTISEQ_CHUNK = 32
MULTISEQ_TIMED = 1  # timed chunks at each B, after the warm-up chunk
MULTISEQ_PROFILED = 2  # frames of the profiled chunk (the profiler's events cost host seconds)


def _simulate_and_init(seed):
    """The bench track with noise seed ``seed``, packed and its init window
    solved on the card (a worker process's task, one torch thread): its
    streams, its one-sequence ``Sequences`` with the state on the host, and
    the init's seconds (a worker's first pays the process's warm-up)."""
    from torch.utils._pytree import tree_map

    from liwslam_torch.frontend.driver import Frontend

    torch.set_num_threads(1)
    streams = bench_streams(bench_params(), seed=seed)
    t0 = time.perf_counter()
    seqs = Frontend(bench_params(), device="cuda").init_sequences([streams])
    torch.cuda.synchronize()
    return streams, seqs._replace(states=tree_map(lambda t: t.cpu(), seqs.states)), time.perf_counter() - t0


def _busy_s(events):
    """Length of the union of the device intervals (kernels and copies)."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start
    )
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6


def run_multiseq(prm, dev):
    """B sequences in one batched step (``parallel/multiseq``) at full
    width: sequence b is the bench track simulated with seed 1 + b
    (simulated and initialized once in worker processes on the card,
    reused for every B).  Each sequence's own init window is a host solve,
    timed.
    At each B: one warm-up chunk of 32 frames, ``MULTISEQ_TIMED`` timed
    chunks (host clock, each ending with its outputs on the host), a
    profiled chunk of ``MULTISEQ_PROFILED`` frames (device busy, kernel
    launches); B1's and B2's counts set to 0 before the timed chunks and
    read after.  Every sequence's batched
    poses are held against its own single-stream run on the card over the
    warm-up chunk's 32 frames, and at B = 32 every sequence runs its whole
    common prefix for its ATE.  Returns B1's and B2's launches a step at
    B = 32, their inputs of one launch there, and the simulated streams."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from torch.utils._pytree import tree_map

    from liwslam_torch.core import geometry as geo
    from liwslam_torch.eval import metrics
    from liwslam_torch.frontend import pipeline as pl
    from liwslam_torch.frontend.driver import Frontend, concat_sequences
    from liwslam_torch.ops import extract as ext
    from liwslam_torch.ops import track_solve as ts
    from liwslam_torch.parallel import multiseq

    t_phase = time.perf_counter()
    Bmax, C = max(MULTISEQ_B), MULTISEQ_CHUNK
    # each sequence simulated and its init window (a host-orchestrated solve
    # of its own) solved in one of 8 worker processes on the card, one
    # thread each (OpenMP too: 8 processes share the host's cores); their
    # one-sequence Sequences put side by side as Frontend.init_sequences does
    t0 = time.perf_counter()
    omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        with ProcessPoolExecutor(8, mp_context=mp.get_context("spawn")) as pool:
            done = list(pool.map(_simulate_and_init, [1 + b for b in range(Bmax)]))
    finally:
        if omp is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = omp
    prep_s = time.perf_counter() - t0
    streams = [d[0] for d in done]
    init_s = np.array([d[2] for d in done])
    fe = Frontend(prm, device=dev)
    seqs = concat_sequences([d[1] for d in done], dev)
    n = seqs.n_common
    T = MULTISEQ_TIMED
    check(n >= (T + 1) * C + MULTISEQ_PROFILED, f"multiseq: {n} common tracked frames < {(T + 1) * C + MULTISEQ_PROFILED}")
    print(
        f"multiseq: {Bmax} sequences (seeds 1..{Bmax}) simulated and initialized in 8 worker processes on the card in "
        f"{prep_s:.1f}s; an init window (one host solve each, 8 at a time) median {1e3 * np.median(init_s):.0f} ms, "
        f"max {1e3 * init_s.max():.0f} (a worker's first pays its warm-up); sequences run their common prefix of "
        f"{n} tracked frames (frames per sequence after the gate {sorted({len(f) for f in seqs.frames})}, first "
        f"tracked frame {sorted(set(seqs.first))}), each from its own first tracked frame",
        flush=True,
    )
    P = MULTISEQ_PROFILED
    chunks = [fe.stack_sequences(seqs, j * C, C) for j in range(T + 1)] + [fe.stack_sequences(seqs, (T + 1) * C, P)]
    # each sequence's own single-stream run over the warm-up chunk
    t0 = time.perf_counter()
    single_p = []
    for b in range(Bmax):
        state = tree_map(lambda x: x[b], seqs.states)
        _, out = fe.run_chunk(state, pl.FrameInput(*[t[b] for t in chunks[0]]))
        single_p.append(out.p.cpu())
    single_s = time.perf_counter() - t0
    run = multiseq.batched_chunk_fn(fe.consts, fe.dcfg, fe.scfg)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    rows = {}
    for B in MULTISEQ_B:
        states = tree_map(lambda x: x[:B].clone(), seqs.states)
        inputs = [pl.FrameInput(*[t[:B] for t in c]) for c in chunks]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        states, out = run(states, inputs[0])
        outs = [out]
        ext.extract_lines_batched.launches = ts.lm_solve_track_batched.launches = 0
        t0 = time.perf_counter()
        for j in range(1, T + 1):
            states, out = run(states, inputs[j])
            outs.append(pl.FrameOutput(*[t.cpu() for t in out]))
        wall = time.perf_counter() - t0
        b2, b1 = ext.extract_lines_batched.launches / (T * C), ts.lm_solve_track_batched.launches / (T * C)
        with torch.profiler.profile(activities=acts) as prof:
            t1 = time.perf_counter()
            states, out = run(states, inputs[T + 1])
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t1
        outs.append(out)
        ev = prof.events()
        busy = _busy_s(ev)
        launches = sum(1 for e in ev if e.name in LAUNCHES) / P
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        p = outs[0].p.cpu()
        gap = max(float((p[b] - single_p[b]).abs().max()) for b in range(B))
        fps = B * T * C / wall
        rows[B] = dict(
            fps=fps, fps_seq=fps / B, step_ms=1e3 * wall / (T * C), busy_ms=1e3 * busy / P,
            idle=1 - busy / prof_wall, launches=launches, b1=b1, b2=b2, peak_mib=peak, gap=gap,
        )
        print(
            f"multiseq B={B}: {fps:.1f} frames/s in all, {fps / B:.1f} a sequence ({1e3 * wall / (T * C):.1f} ms "
            f"a step); device busy {1e3 * busy / P:.2f} ms a step, idle share {1 - busy / prof_wall:.3f} (profiled "
            f"{P} frames); {launches:.0f} kernel launches a step, B1 {b1:g} and B2 {b2:g} a step; peak memory "
            f"{peak:.1f} MiB; batched vs single-stream poses, largest |dp| {gap:.3e} m",
            flush=True,
        )
        check(b1 == 1 and b2 == 1, f"multiseq B={B}: B1 {b1} and B2 {b2} launches a step, not 1")
        check(gap <= 1e-3, f"multiseq B={B}: batched poses {gap} m from the single-stream runs")
    check(
        rows[Bmax]["launches"] <= 1.1 * rows[1]["launches"],
        f"multiseq: {rows[Bmax]['launches']} launches a step at B={Bmax} > 1.1x B=1's {rows[1]['launches']}",
    )
    # B = 32 on to the end of the common prefix, every sequence's ATE; one
    # launch's inputs of each kernel kept for the kernels line
    captured = {}

    def keep(name, launch):
        def wrapped(*args):
            captured.setdefault(name, args)
            return launch(*args)

        return wrapped

    launch_b1, launch_b2 = ts._launch, ext._launch
    ts._launch, ext._launch = keep("track_solve", launch_b1), keep("extract_lines", launch_b2)
    try:
        for j in range((T + 1) * C + P, n, C):
            states, out = run(states, fe.stack_sequences(seqs, j, min(C, n - j)))
            outs.append(out)
    finally:
        ts._launch, ext._launch = launch_b1, launch_b2
    p = torch.cat([o.p.cpu() for o in outs], 1).numpy()
    q = torch.cat([o.q.cpu() for o in outs], 1).numpy()
    ates = []
    for b in range(Bmax):
        t_us = seqs.stamps[b][seqs.first[b] : seqs.first[b] + n]
        pairs = metrics.associate_by_time(t_us, streams[b].gt_t_us)
        check(len(pairs) == n, f"multiseq: sequence {b} has frames without ground truth")
        est = geo.make_tf(torch.as_tensor(p[b]), torch.as_tensor(q[b])).numpy()
        ates.append(metrics.ate_rmse(est[pairs[:, 0]], streams[b].gt_T_w_imu[pairs[:, 1]], align=True))
    ates = np.array(ates)
    print(
        f"multiseq B={Bmax} over the common prefix ({n} tracked frames each): ATE a sequence median "
        f"{np.median(ates):.4f}m max {ates.max():.4f}m min {ates.min():.4f}m, seed 1 {ates[0]:.4f}m; "
        f"single-stream references {single_s:.1f}s; phase {time.perf_counter() - t_phase:.1f}s",
        flush=True,
    )
    print("multiseq ATE by seed: " + json.dumps([round(float(a), 6) for a in ates]), flush=True)
    check(np.all(np.isfinite(p)) and ates.max() < 0.02, f"multiseq: ATE {ates.max()} m >= 0.02 m")
    return rows, captured, streams


# ---------------------------------------------------------- back end ----

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def feed_backend(prm, res, dev):
    """A KeyframeManager fed the front end's keyframes after the run, as
    ``liwslam_torch.run`` feeds it."""
    from liwslam_torch.backend.manager import KeyframeManager

    mgr = KeyframeManager(prm, device=dev)
    for ki, fi in enumerate(np.flatnonzero(res.is_keyframe)):
        mgr.add_keyframe(
            t_us=int(res.t_us[fi]), p=res.p[fi], q=res.q[fi], corners=res.kf_corners[ki], scan_lines=res.kf_scans[ki]
        )
    return mgr


def backend_ate(mgr, res, streams):
    """(front-end ATE over every frame, back-end ATE over the keyframes),
    aligned, as tests/test_loop_e2e.py measures them."""
    from liwslam_torch.eval import metrics

    ts, Ts = mgr.trajectory()
    pb = metrics.associate_by_time(ts, streams.gt_t_us)
    pf = metrics.associate_by_time(res.t_us, streams.gt_t_us)
    return (
        metrics.ate_rmse(res.T_w_imu()[pf[:, 0]], streams.gt_T_w_imu[pf[:, 1]]),
        metrics.ate_rmse(Ts[pb[:, 0]], streams.gt_T_w_imu[pb[:, 1]]),
    )


def run_backend_posthoc(prm, streams, res, dev):
    """The laser path's result fed to ``KeyframeManager(device="cuda")``
    after the run.  Checks at least one loop and the gate of
    tests/test_loop_e2e.py (back-end ATE <= 1.2 x front-end ATE + 0.01 m).
    Prints keyframes, loops, rejections, the solves (solver, K, E, ms,
    Gauss-Newton iterations, host syncs), ms a keyframe (wall, and the
    part up to the device's results on the host), pool capacity and peak
    device memory; then feeds a second manager under the profiler for the
    kernel launches and stream syncs a keyframe and a solve."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mgr = feed_backend(prm, res, dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    ate_front, ate_back = backend_ate(mgr, res, streams)
    n_kf = len(mgr.keyframes)
    check(n_kf == int(res.is_keyframe.sum()) and n_kf > 0, "back end: keyframe count")
    check(len(mgr.loops_found) >= 1, "back end: no loop found on the loop track")
    check(ate_back <= 1.2 * ate_front + 0.01, f"back end: ATE {ate_back} m > 1.2 x front end {ate_front} + 0.01")
    solves = mgr.perf["solves"]
    check(len(solves) >= 1, "back end: no pose-graph solve")
    solve_ms = [1e3 * s["s"] for s in solves]
    kf_ms = np.array([1e3 * t for t, _ in mgr.perf["kf_s"]])
    dev_ms = np.array([1e3 * d for _, d in mgr.perf["kf_s"]])
    solve_kf = set(mgr.perf.get("solve_kf", []))
    no_solve = np.array([k not in solve_kf for k in range(n_kf)])

    # the same feed under the profiler: launches and syncs inside the solves
    # (a record_function range around each) and outside them
    from liwslam_torch.backend import manager as km

    solve = km.KeyframeManager.solve

    def traced(self):
        with torch.profiler.record_function("pg_solve"):
            return solve(self)

    # host-side events only: the runtime's launch and sync calls are among
    # them, and the device's records add no count
    km.KeyframeManager.solve = traced
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            mgr2 = feed_backend(prm, res, dev)
            torch.cuda.synchronize()
    finally:
        km.KeyframeManager.solve = solve
    ev = prof.events()
    ranges = [
        (e.time_range.start, e.time_range.end)
        for e in ev
        if e.name == "pg_solve" and e.device_type == torch.autograd.DeviceType.CPU
    ]
    inside = lambda e: any(a <= e.time_range.start <= b for a, b in ranges)
    count = lambda names: (
        sum(1 for e in ev if e.name in names and inside(e)),
        sum(1 for e in ev if e.name in names and not inside(e)),
    )
    l_solve, l_kf = count(LAUNCHES)
    s_solve, s_kf = count(SYNCS)
    n_sol = max(len(ranges), 1)
    out = dict(
        keyframes=n_kf, loops=[(int(a), int(b)) for a, b, _ in mgr.loops_found],
        rejections=len(mgr.loop_rejections), ate_front=ate_front, ate_back=ate_back,
    )
    print(
        f"back end (post hoc, laser path's result): keyframes={n_kf} loops={len(mgr.loops_found)} "
        f"{out['loops']} rejections={len(mgr.loop_rejections)} solves={len(solves)} "
        f"ATE front={ate_front:.4f}m back={ate_back:.4f}m wall={wall:.2f}s",
        flush=True,
    )
    for s in solves:
        print(
            f"  solve: solver={s['solver']} K={s['K']} E={s['E']} ms={1e3 * s['s']:.1f} "
            f"gn_iters={s['gn_iters']} host_syncs={s['syncs']}",
            flush=True,
        )
    print(
        f"  ms a keyframe (wall, keyframes without a solve): median {np.median(kf_ms[no_solve]):.2f} "
        f"p95 {np.quantile(kf_ms[no_solve], 0.95):.2f} max {kf_ms[no_solve].max():.2f}; of it up to the "
        f"device's results on the host: median {np.median(dev_ms[no_solve]):.2f} p95 "
        f"{np.quantile(dev_ms[no_solve], 0.95):.2f}; ms a solve {[round(x, 1) for x in solve_ms]}",
        flush=True,
    )
    print(
        f"  profiled feed ({len(mgr2.keyframes)} keyframes, {len(ranges)} solves): kernel launches "
        f"{l_kf / n_kf:.1f} a keyframe and {l_solve / n_sol:.0f} a solve; stream syncs {s_kf / n_kf:.2f} a "
        f"keyframe and {s_solve / n_sol:.0f} a solve; descriptor pool {mgr._mf_pool['points'].shape[0]} slots "
        f"for {mgr._mf_slots} maps; peak device memory above the start {peak / 2**20:.1f} MiB",
        flush=True,
    )
    return out


def run_online(prm, streams, dev, laser_res, posthoc, laser_fps):
    """``OnlineRunner(prm, device="cuda")`` on the same streams,
    with B1's and B2's counts set to 0 just before and read just after.
    Checks the kernels ran, that the online manager found the same loop
    pairs as a post-hoc feed of its own front end's result and that its
    keyframe trajectory matches that feed's within 1e-4 m (the criterion
    of tests/test_online.py), that a checkpoint of the manager as ``run``
    returns it holds the feed's descriptor tables (valid flags, distance
    bins, bitmaps) exactly and every other array within 1e-4, and that the back end overlapped the front
    end (overlap seconds > 0).  When the online front end's poses equal
    the laser path's, the loops must also equal the first post-hoc run's."""
    import os
    import tempfile

    from liwslam_torch.online import OnlineRunner
    from liwslam_torch.ops import extract as ext
    from liwslam_torch.ops import track_solve as ts
    from liwslam_torch.utils import checkpoint as ckpt

    runner = OnlineRunner(prm, device=dev)
    stamps = []
    fe_run = runner.fe.run

    def run_with_stamps(streams, chunk_size, chunk_callback):
        def cb(info):
            stamps.append((time.perf_counter(), info["n"]))
            chunk_callback(info)

        return fe_run(streams, chunk_size=chunk_size, chunk_callback=cb)

    runner.fe.run = run_with_stamps
    ext.extract_lines_batched.launches = 0
    ts.lm_solve_track_batched.launches = 0
    ores = runner.run(streams, chunk_size=64)
    launches = dict(extract_lines=ext.extract_lines_batched.launches, track_solve=ts.lm_solve_track_batched.launches)
    res = ores.frontend
    with tempfile.TemporaryDirectory() as d:
        # a checkpoint of the manager as run() hands it back, before anything
        # else waits for the card, against one of a post-hoc feed
        ckpt.save_manager(os.path.join(d, "online"), ores.manager)
        ref = feed_backend(prm, res, dev)
        ckpt.save_manager(os.path.join(d, "posthoc"), ref)
        za, zb = (dict(np.load(os.path.join(d, n + ".npz"))) for n in ("online", "posthoc"))
    check(za.keys() == zb.keys(), "online: checkpoint keys differ from the post-hoc feed's")
    exact = [k for k in za if k.startswith("mf") and k.split("_", 1)[1] in ("valid", "dist_q", "bitmap")]
    check(all(np.array_equal(za[k], zb[k]) for k in exact), "online: checkpointed descriptor tables differ from the post-hoc feed's")
    ck_gap = max(float(np.abs(za[k].astype(np.float64) - zb[k]).max(initial=0.0)) for k in za if k not in exact)
    check(ck_gap <= 1e-4, f"online: checkpoint arrays {ck_gap} from the post-hoc feed's (> 1e-4)")
    tracked = sum(n for _, n in stamps)
    check(launches["track_solve"] == tracked, f"online: B1 launches {launches} != {tracked} tracked frames")
    check(launches["extract_lines"] >= len(res.t_us), f"online: B2 launches {launches} < {len(res.t_us)} frames")
    fps = sum(n for _, n in stamps[1:]) / (stamps[-1][0] - stamps[0][0])
    loops = [(int(a), int(b)) for a, b, _ in ores.manager.loops_found]
    check(loops == [(int(a), int(b)) for a, b, _ in ref.loops_found], f"online loops {loops} != post hoc's")
    check(len(loops) >= 1, "online: no loop found")
    ta, Ta = ores.manager.trajectory()
    tb, Tb = ref.trajectory()
    check(np.array_equal(ta, tb), "online: keyframe stamps differ from the post-hoc feed's")
    dp = float(np.abs(Ta[:, :3, 3] - Tb[:, :3, 3]).max())
    check(dp <= 1e-4, f"online: keyframe positions {dp} m from the post-hoc feed's (> 1e-4)")
    same_fe = np.array_equal(res.p, laser_res.p)
    if same_fe:
        check(loops == posthoc["loops"], f"online loops {loops} != the laser path's post-hoc {posthoc['loops']}")
    check(ores.overlap_s > 0, f"online: no overlap (backend busy {ores.backend_busy_s}s, drain {ores.drain_wait_s}s)")
    print(
        f"online: tracked_fps={fps:.1f} (laser path {laser_fps:.1f}) loops={len(loops)} {loops} "
        f"max |dp| vs post hoc {dp:.2e}m, checkpoints {len(za)} arrays, descriptor tables equal, the rest within "
        f"{ck_gap:.1e}; front end's poses equal the laser path's: {same_fe}; "
        f"backend busy {ores.backend_busy_s:.2f}s, overlap {ores.overlap_s:.2f}s, drain wait "
        f"{ores.drain_wait_s:.2f}s, wall {ores.wall_s:.1f}s, mailbox high water {runner.q_depth_max}; "
        f"launches={json.dumps(launches)}",
        flush=True,
    )


def _pcg_edges(T, K):
    """The topology of __graft_entry__.py:137-170 over K poses T (K,4,4):
    K - 1 sequential edges and K/2 loop edges (weight 10) between random
    nodes up to K/4 apart.  Returns (e_i, e_j, weights, loop ends a, b)."""
    rng = np.random.default_rng(0)
    n_loop = K // 2
    a = rng.integers(0, K - 1, n_loop)
    b = np.minimum(a + rng.integers(2, K // 4, n_loop), K - 1)
    ei = np.concatenate([np.arange(K - 1), a])
    ej = np.concatenate([np.arange(1, K), b])
    ew = np.concatenate([np.ones(K - 1), np.full(n_loop, 10.0)])
    return ei, ej, ew, a, b


def _yaw_tf(p, yaw):
    """Transforms (K,4,4): translations ``p`` (K,3), rotations by ``yaw``
    (K,) about z."""
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.tile(np.eye(4), (len(yaw), 1, 1))
    T[:, 0, 0], T[:, 0, 1], T[:, 1, 0], T[:, 1, 1] = c, -s, s, c
    T[:, :3, 3] = p
    return T


def _padded_graph(T0, ei, ej, etf, ew, dev, perm_seed=None):
    """A PoseGraph of the poses T0 (K,4,4) and the edges, in 4K edge slots;
    ``perm_seed`` shuffles the edges' order (the order of the solve's sums)."""
    from liwslam_torch.backend import posegraph as pg
    from liwslam_torch.core import geometry as geo

    K, n_e = len(T0), len(ei)
    if perm_seed is not None:
        order = np.random.default_rng(perm_seed).permutation(n_e)
        ei, ej, etf, ew = ei[order], ej[order], etf[order], ew[order]
    pad = 4 * K - n_e
    ei, ej = np.pad(ei, (0, pad)), np.pad(ej, (0, pad))
    etf = np.concatenate([etf, np.tile(np.eye(4), (pad, 1, 1))])
    ew = np.pad(ew, (0, pad))
    p0, q0 = (t.numpy() for t in geo.log_SE3(torch.as_tensor(np.asarray(T0, np.float64))))
    return pg.graph_from_numpy(p0, q0, K, ei, ej, etf, ew, n_e, dev)


def _poses(p, q):
    from liwslam_torch.core import geometry as geo

    return geo.make_tf(torch.as_tensor(np.asarray(p, np.float32)), torch.as_tensor(np.asarray(q, np.float32))).double().numpy()


def pcg_graph(res, K, dev, perm_seed=None):
    """A pose graph of K nodes with the topology of __graft_entry__.py:
    the front end's poses first, the trajectory continued along x (keeping
    the last front-end orientation: the graft entry's zero rotation lays
    the wheel frame on its side, where the ground rows fight the edges).
    As odometry and loop closure give them: the initial poses and
    sequential edges come from a drifted copy of the trajectory (a seeded
    random walk of 2 mm a node in x and y and 0.2 mrad a node of yaw), the
    loop edges from the true poses.  The solve the manager calls (20
    Gauss-Newton, 60 CG iterations) does not settle on it: the timing
    graph."""
    n_fe = min(len(res.p), K)
    p = np.zeros((K, 3), np.float32)
    q = np.zeros((K, 3), np.float32)
    p[:n_fe], q[:n_fe] = res.p[:n_fe], res.q[:n_fe]
    p[n_fe:, 0] = p[n_fe - 1, 0] + 0.25 * np.arange(1, K - n_fe + 1)
    p[n_fe:, 1:] = p[n_fe - 1, 1:]
    q[n_fe:] = q[n_fe - 1]
    T = _poses(p, q)
    walk = np.random.default_rng(1)
    yaw = np.cumsum(walk.normal(0, 2e-4, K))
    dxy = np.cumsum(walk.normal(0, 2e-3, (K, 2)), 0)
    yaw[0], dxy[0] = 0.0, 0.0  # the first node is fixed
    T_odo = _yaw_tf(np.zeros((K, 3)), yaw) @ T
    T_odo[:, :2, 3] += dxy
    ei, ej, ew, a, b = _pcg_edges(T, K)
    etf = np.concatenate([np.linalg.inv(T_odo[:-1]) @ T_odo[1:], np.linalg.inv(T[a]) @ T[b]])
    return _padded_graph(T_odo, ei, ej, etf, ew, dev, perm_seed)


def settled_graph(prm, res, K, dev, perm_seed=None):
    """A pose graph on which the manager's solve settles: the front end's
    poses laid flat (each wheel frame's x, y and yaw kept, its height and
    tilt zeroed, so the ground rows agree with the edges), repeated lap
    after lap to K nodes (a robot driving the bench track again and again),
    every edge (topology of :func:`pcg_graph`) measured from those poses,
    and each initial pose moved from them in its own frame by a seeded
    2 cm in x and y and 2 mrad of yaw.  Its correction is the
    perturbation, ~7 cm and ~7 mrad at the largest."""
    T_iw = prm.mat_T_imu_to_wheel().astype(np.float64)
    idx = np.arange(K) % len(res.p)
    W = _poses(res.p[idx], res.q[idx]) @ T_iw
    yaw = np.arctan2(W[:, 1, 0], W[:, 0, 0])
    T = _yaw_tf(np.stack([W[:, 0, 3], W[:, 1, 3], 0 * yaw], -1), yaw) @ np.linalg.inv(T_iw)
    ei, ej, ew, a, b = _pcg_edges(T, K)
    etf = np.concatenate([np.linalg.inv(T[:-1]) @ T[1:], np.linalg.inv(T[a]) @ T[b]])
    noise = np.random.default_rng(1)
    dp = noise.normal(0, 0.02, (K, 3)) * [1.0, 1.0, 0.0]
    dyaw = noise.normal(0, 2e-3, K)
    dp[0], dyaw[0] = 0.0, 0.0  # the first node is fixed
    T0 = T @ _yaw_tf(dp, dyaw)
    return _padded_graph(T0, ei, ej, etf, ew, dev, perm_seed)


def graph_float64(g, c):
    """A float32 PoseGraph and its PGConsts in float64."""
    g = g._replace(**{f: getattr(g, f).double() for f in ("p", "q", "e_tf", "e_weight")})
    return g, c._replace(info6=c.info6.double(), T_imu_to_wheel=c.T_imu_to_wheel.double())


def pose_gap(a, b):
    """(max |dp| m, largest rotation angle rad) between two PoseGraphs'
    poses; the angle is taken between rotation matrices (2 sin(θ/2) =
    |Ra - Rb|_F / √2), so the two rotation vectors of one turn near π
    count as one rotation."""
    from liwslam_torch.core import geometry as geo

    Ra, Rb = (geo.make_tf(g.p.cpu().double(), g.q.cpu().double())[..., :3, :3] for g in (a, b))
    return (
        float((a.p.cpu().double() - b.p.cpu().double()).abs().max()),
        float(2 * torch.asin(torch.clamp(torch.linalg.matrix_norm(Ra - Rb) / 8**0.5, max=1.0)).max()),
    )


def check_pcg(prm, res, dev):
    """``solve_pcg`` (gn_iters=20, cg_iters=60, as the manager calls it)
    on :func:`pcg_graph` at K = 1024, 4096 and 10240: ms a solve (median of
    2, host clock around the call and the poses' copy to the host), its
    Gauss-Newton iterations and host syncs, at K = 1024 launches a
    Gauss-Newton iteration (profiler, over two).  That graph's solve stops at its 20 iterations far from
    its optimum, so its answer is not compared; :func:`check_pcg_settled`
    holds the card's solve on a graph where it settles."""
    from liwslam_torch.backend import posegraph as pg

    consts = pg.make_pg_consts(prm, dev)
    for K in (1024, 4096, 10240):
        g = pcg_graph(res, K, dev)
        ms, stats = [], {}
        for _ in range(2):
            stats = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g_out, cost = pg.solve_pcg(g, consts, gn_iters=20, cg_iters=60, stats=stats)
            pq = torch.stack([g_out.p, g_out.q]).cpu().numpy()
            ms.append(1e3 * (time.perf_counter() - t0))
        check(np.all(np.isfinite(pq)), f"PCG K={K}: non-finite poses")
        line = (
            f"PCG K={K} E={int(g.n_edges)} (slots {g.e_i.shape[0]}): ms a solve {statistics.median(ms):.1f} "
            f"({', '.join(f'{m:.1f}' for m in ms)}), gn_iters={stats['gn_iters']} host_syncs={stats['syncs']}, "
            f"cost {float(cost):.6g}"
        )
        if K == 1024:
            # launches a Gauss-Newton iteration, from two, at one K only: the
            # profiler's processing of a solve's events takes many times the
            # solve, and an iteration launches the same kernels at every K,
            # CG checks aside
            st = {}
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                pg.solve_pcg(g, consts, gn_iters=2, cg_iters=60, stats=st)
                torch.cuda.synchronize()
            line += f", launches a Gauss-Newton iteration {sum(1 for e in prof.events() if e.name in LAUNCHES) / st['gn_iters']:.0f}"
        print(line, flush=True)
    check_pcg_settled(prm, res, dev)


def check_pcg_settled(prm, res, dev, K=1024):
    """``solve_pcg`` on :func:`settled_graph` at K = 1024, held against
    the same graph's float64 solve on the CPU run to its own exit (200
    Gauss-Newton and 200 CG iterations at most; ~23 on the bench track's
    poses, where reordering the CPU's edges moves it by 4e-15 m):

    - the device's float64 solve, also run to its exit: within 1e-8 m and
      1e-8 rad (the device's sums in their own order, the same algorithm);
    - the device's float32 solve as the manager calls it (gn_iters=20,
      cg_iters=60): within 2e-3 m and 1e-4 rad.  A float32 solve stalls
      along the graph's softest mode (the CPU's lands 6.5e-4 m and 1.8e-5
      rad away however long it runs; its float64 twin of 20/60 iterations
      5.5e-4 m), and the correction it has to find, printed beside it, is
      ~7e-2 m and ~7e-3 rad: a solve that did half its work fails."""
    from liwslam_torch.backend import posegraph as pg

    consts = pg.make_pg_consts(prm, dev)
    c_cpu = pg.make_pg_consts(prm, "cpu")
    g = settled_graph(prm, res, K, dev)
    st32, st_d64, st64 = {}, {}, {}
    g32, cost32 = pg.solve_pcg(g, consts, gn_iters=20, cg_iters=60, stats=st32)
    gd64, cost_d64 = pg.solve_pcg(*graph_float64(g, consts), gn_iters=200, cg_iters=200, stats=st_d64)
    gc, cc = graph_float64(settled_graph(prm, res, K, "cpu"), c_cpu)
    t0 = time.perf_counter()
    g64, cost64 = pg.solve_pcg(gc, cc, gn_iters=200, cg_iters=200, stats=st64)
    cpu_s = time.perf_counter() - t0
    cp, cq = pose_gap(gc, g64)
    dp64, dq64 = pose_gap(gd64, g64)
    dp32, dq32 = pose_gap(g32, g64)
    line = (
        f"PCG K={K} settled graph: float64 CPU solve to its exit gn_iters={st64['gn_iters']} cost {float(cost64):.6g} "
        f"({cpu_s:.1f}s), correction max |dp| {cp:.2e} m |dq| {cq:.2e} rad; the card's float64 solve gn_iters="
        f"{st_d64['gn_iters']} cost {float(cost_d64):.6g}: |dp| {dp64:.2e} m |dq| {dq64:.2e} rad (held to 1e-8, 1e-8); "
        f"the card's float32 solve (20/60) gn_iters={st32['gn_iters']} cost {float(cost32):.6g}: |dp| {dp32:.2e} m "
        f"|dq| {dq32:.2e} rad (held to 2e-3 m, 1e-4 rad)"
    )
    print(line, flush=True)
    check(cp > 10 * 2e-3 and cq > 10 * 1e-4, f"PCG settled graph: correction too small: {line}")
    check(dp64 <= 1e-8 and dq64 <= 1e-8, f"PCG card float64 vs CPU float64: {line}")
    check(dp32 <= 2e-3 and dq32 <= 1e-4, f"PCG card float32 vs CPU float64: {line}")


def check_score_memory(dev):
    """``score_pairs`` at the market preset's P = 256 against 64 candidate
    maps (the most the reference scores in one program): peak device memory
    above the inputs (< 2 GB) and ms a call; and at the office preset's
    P = 128 against 8, the first of them the probe map's corners moved by
    an SE(2) transform.  At P = 128 the same maps are also built and
    scored on the CPU: points, valid flags and counts and bins of the
    card's scoring of the CPU's maps are held equal; the card's own maps'
    ``dist_q`` equal except at .5 rounding ties (a float64 distance within
    1e-5 of a half bin, off by one at most), their bitmaps equal in every
    row without such a tie, ``ang`` within 1e-6 rad, and their counts and
    bins equal to the CPU's unless a tie flipped."""
    from liwslam_torch import config
    from liwslam_torch.backend import loop as loop_mod
    from liwslam_torch.core import geometry as geo

    for prm, M in ((config.market(), 64), (config.office(), 8)):
        P = prm.map_corner_capacity
        keys = np.random.default_rng(P).permuted(np.tile(np.arange(P), (M + 1, 1)), axis=1)
        moved = geo.make_tf_np(np.array([1.5, -2.0, 0.0]), np.array([0.0, 0.0, 0.8]))

        def pts_of(seed):
            pts = np.random.default_rng(seed).uniform(-10, 10, (2 * P, 3)).astype(np.float32) * [1, 1, 0]
            if seed == 1:
                pts = pts_of(0) @ moved[:3, :3].T.astype(np.float32) + moved[:3, 3].astype(np.float32)
            return pts.astype(np.float32)

        def maps(d):
            feats = [
                loop_mod.build_map_feature_device(
                    pts_of(s), np.ones(2 * P, bool), np.eye(4), d_res=prm.d_res, capacity=P,
                    n_dist_bins=prm.n_dist_bins, perm=keys[s], device=d,
                )
                for s in range(M + 1)
            ]
            stack = [torch.stack([getattr(m, f) for m in feats[1:]]) for f in loop_mod.MapFeature._fields[:6]]
            return feats[0], loop_mod.MapFeature(*stack, -1)

        m1, m2 = maps(dev)
        probes = torch.arange(prm.loop_probe_count, device=dev)
        kw = dict(a_res=prm.a_res, n_angle_bins=prm.n_angle_bins, min_match_threshold=prm.laser_loop_min_match_threshold)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counts, bins = loop_mod.score_pairs(m1, m2, probes, **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = time_ms(lambda: loop_mod.score_pairs(m1, m2, probes, **kw), n=5, warm=1)
        check(peak < 2e9, f"score_pairs P={P} M={M}: peak {peak} bytes >= 2 GB")
        line = (
            f"score_pairs P={P} A={prm.n_angle_bins} M={M} probes={prm.loop_probe_count}: peak device memory above "
            f"the inputs {peak / 2**20:.1f} MiB, {ms:.2f} ms a call (CUDA events), max count {int(counts.max())}"
        )
        if M == 8:
            c1, c2 = maps("cpu")
            cc, cb = loop_mod.score_pairs(c1, c2, probes.cpu(), **kw)
            onto = lambda m: loop_mod.MapFeature(*[f.to(dev) for f in m[:6]], -1)
            xc, xb = loop_mod.score_pairs(onto(c1), onto(c2), probes, **kw)
            for f in ("points", "valid"):
                check(all(torch.equal(getattr(a, f).cpu(), getattr(b, f)) for a, b in ((m1, c1), (m2, c2))), f"score_pairs: {f} differ")
            check(torch.equal(xc.cpu(), cc) and torch.equal(xb.cpu(), cb), "score_pairs: the card's counts or bins of the CPU's maps differ")
            flips, rows_ok = 0, True
            for a, b in ((m1, c1), (m2, c2)):
                dq_d, dq_c = a.dist_q.cpu(), b.dist_q
                pt = b.points.double()
                d = torch.linalg.norm(pt[..., None, :, :2] - pt[..., :, None, :2], dim=-1) / prm.d_res
                flip = dq_d != dq_c
                flips += int(flip.sum())
                check(bool(((d.frac() - 0.5).abs()[flip] < 1e-5).all()) and int((dq_d - dq_c).abs().max()) <= 1,
                      "score_pairs: dist_q differs away from a .5 tie")
                tie_row = flip.any(-1)
                rows_ok &= torch.equal(a.bitmap.cpu()[~tie_row], b.bitmap[~tie_row])
                check(float((a.ang.cpu() - b.ang).abs().max()) <= 1e-6, "score_pairs: ang differs by > 1e-6 rad")
            check(rows_ok, "score_pairs: bitmaps differ in a row without a .5 tie")
            same = torch.equal(counts.cpu(), cc) and torch.equal(bins.cpu(), cb)
            check(same or flips > 0, "score_pairs: the card's counts or bins differ from the CPU's without a tie")
            check(int(cc[0].max()) >= 10 and int(cc[1:].max()) < int(cc[0].max()), f"score_pairs: the moved map scores {int(cc[0].max())}")
            line += (
                f"; against the CPU: counts and bins of the same maps equal, the card's own maps' dist_q .5 ties "
                f"flipped {flips}, counts and bins {'equal' if same else 'differ after a tie'}, max count of the "
                f"moved map {int(cc[0].max())}, of the others {int(cc[1:].max())}"
            )
        print(line, flush=True)


def run_cli_bag(streams):
    """``python -m liwslam_torch.run --sequence <bag> --gt <tum> --debug-viz``
    on the card, as a subprocess: the bench streams written as a ROS1 bag
    (bz2 chunks, indexed) by the port's own writer
    (``io/openloris.save_bag``) and the ground truth as a TUM file, both
    under chiprun_out/cli_bag; bench.py's overrides as ``--param``.  Checks
    the report's front-end ATE < 0.02 m, at least one loop, and that the
    trajectories, the map and the three renderings exist (.png, or .ppm
    where PIL is missing)."""
    import dataclasses
    import os

    from liwslam_torch import config
    from liwslam_torch.io import openloris, tum

    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "chiprun_out", "cli_bag")
    os.makedirs(out, exist_ok=True)
    bag, gt = os.path.join(out, "bench.bag"), os.path.join(out, "gt.txt")
    t0 = time.perf_counter()
    laser_only = dataclasses.replace(streams, cam_t_us=np.zeros(0, np.int64), cam_images=np.zeros((0, 1, 1), np.float32))
    openloris.save_bag(bag, laser_only, compression="bz2", indexed=True)
    tum.write_tum(gt, streams.gt_t_us + int(1560000000.0 * 1e6), streams.gt_T_w_wheel)
    write_s = time.perf_counter() - t0
    cmd = [
        sys.executable, "-m", "liwslam_torch.run", "--sequence", bag, "--gt", gt, "--debug-viz",
        "--chunk", "64", "--out", os.path.join(out, "run"),
    ]
    for k, v in config.BENCH_WIDTHS.items():
        cmd += ["--param", f"{k}={v}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"CLI (bag) exited {proc.returncode}: {proc.stderr[-2000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    names = ("fornt_end.txt", "back_end.txt", "map.pgm", "merged_scans_frontend", "merged_scans_backend", "trajectory")
    files = {
        f: next((os.path.basename(c) for c in (os.path.join(out, "run", f), *(os.path.join(out, "run", f + e) for e in (".png", ".ppm"))) if os.path.isfile(c)), None)
        for f in names
    }
    check(report.get("ate_frontend_m", 1.0) < 0.02 and report.get("loops", 0) >= 1, f"CLI (bag) report {report}")
    check(report.get("debug_viz") and all(files.values()), f"CLI (bag) files {files}")
    print(
        f"CLI on a ROS1 bag: bag {os.path.getsize(bag) / 2**20:.1f} MiB written in {write_s:.1f}s, run {wall:.1f}s, "
        f"report {json.dumps(report)}, files {sorted(files.values())}",
        flush=True,
    )


# ------------------------------------------------- distributed modes ----


def check_pcg_dist(prm, res, dev):
    """``solve_pcg_sharded`` at world size 1 over NCCL on the card, on
    :func:`settled_graph`: in float64, both run to their exit (200
    Gauss-Newton and 200 CG iterations at most), within 1e-9 m and 1e-9
    rad of the unsharded ``solve_pcg``; in float32 as the manager calls
    the solve (20 / 60), both timed (ms a solve, median of 2, the poses'
    copy to the host included) at K = 1024 and 10240 and held, each, to
    the graph's float64 optimum within :func:`check_pcg_settled`'s
    float32 bound (2e-3 m, 1e-4 rad), the sharded solve's final cost to
    the unsharded one's within 25%.  (Both final costs sit at float32's
    rounding floor, ~1e-9 of the start and ~100x the float64 optimum's,
    where the card's atomics alone move them by 0.4-7.7% from run to run,
    so a 1% bound would compare rounding, not solves; a solve that has not
    settled ends orders of magnitude higher.)  Prints the launches
    (profiler) and all_reduce calls a Gauss-Newton iteration.  One card:
    no speed claim, the collectives run on one rank."""
    import os
    import tempfile

    import torch.distributed as dist

    from liwslam_torch.backend import posegraph as pg
    from liwslam_torch.parallel import posegraph_dist as pgd

    consts = pg.make_pg_consts(prm, dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rdv')}", world_size=1, rank=0)
        try:
            g = settled_graph(prm, res, 1024, dev)
            g64, c64 = graph_float64(g, consts)
            st_s, st_u = {}, {}
            gs, cost_s = pgd.solve_pcg_sharded(pgd.shard_edges(g64, 0, 1), c64, gn_iters=200, cg_iters=200, stats=st_s)
            gu, cost_u = pg.solve_pcg(g64, c64, gn_iters=200, cg_iters=200, stats=st_u)
            dp, dq = pose_gap(gs, gu)
            n_gn = st_s["gn_iters"]
            red = {k: v / n_gn for k, v in st_s["reductions"].items()}
            print(
                f"distributed PCG (world 1, NCCL) K=1024 settled graph float64: sharded gn_iters={n_gn} "
                f"cg_iters={st_s['cg_iters']} cost {float(cost_s):.9g}, unsharded gn_iters={st_u['gn_iters']} "
                f"cost {float(cost_u):.9g}: |dp| {dp:.2e} m |dq| {dq:.2e} rad (held to 1e-9); all_reduce calls a "
                f"Gauss-Newton iteration {json.dumps(red)}",
                flush=True,
            )
            check(dp <= 1e-9 and dq <= 1e-9, f"distributed PCG float64: |dp| {dp} |dq| {dq} from the unsharded solve")
            check(st_s["reductions"].get("K,43") == n_gn and st_s["reductions"].get("1") == n_gn
                  and st_s["reductions"].get("K,6") == st_s["cg_iters"], f"distributed PCG reductions {st_s}")
            for K in (1024, 10240):
                gk = g if K == 1024 else settled_graph(prm, res, K, dev)
                g_opt = gu if K == 1024 else pg.solve_pcg(*graph_float64(gk, consts), gn_iters=200, cg_iters=200)[0]
                r_e, r_g = pg.graph_residuals(gk, consts)
                cost0 = float(0.5 * (torch.sum(r_e * r_e) + torch.sum(r_g * r_g)))
                gl = pgd.shard_edges(gk, 0, 1)
                runs = dict(
                    sharded=lambda st: pgd.solve_pcg_sharded(gl, consts, gn_iters=20, cg_iters=60, stats=st),
                    unsharded=lambda st: pg.solve_pcg(gk, consts, gn_iters=20, cg_iters=60, stats=st),
                )
                ms = {k: [] for k in runs}
                out = {}
                for _ in range(2):
                    for name, run in runs.items():
                        st = {}
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        g_out, cost = run(st)
                        g_out.p.cpu(), g_out.q.cpu()
                        ms[name].append(1e3 * (time.perf_counter() - t0))
                        out[name] = (float(cost), st, pose_gap(g_out, g_opt))
                (cs, sts, gap_s), (cu, stu, gap_u) = out["sharded"], out["unsharded"]
                line = (
                    f"distributed PCG (world 1, NCCL) K={K} float32 (20/60): ms a solve sharded "
                    f"{statistics.median(ms['sharded']):.1f} ({', '.join(f'{m:.1f}' for m in ms['sharded'])}), unsharded "
                    f"{statistics.median(ms['unsharded']):.1f} ({', '.join(f'{m:.1f}' for m in ms['unsharded'])}); cost "
                    f"from {cost0:.6g} to {cs:.6g} vs {cu:.6g} ({100 * abs(cs - cu) / cu:.1f}% of the unsharded final cost, "
                    f"held to 25%); from the float64 optimum |dp| {gap_s[0]:.2e} / "
                    f"{gap_u[0]:.2e} m, |dq| {gap_s[1]:.2e} / {gap_u[1]:.2e} rad; gn_iters {sts['gn_iters']} / {stu['gn_iters']}"
                )
                if K == 1024:
                    # launches of two Gauss-Newton iterations (the profiler's
                    # processing of a whole solve's events takes many times it)
                    per = {}
                    for name, run in dict(
                        sharded=lambda st: pgd.solve_pcg_sharded(gl, consts, gn_iters=2, cg_iters=60, stats=st),
                        unsharded=lambda st: pg.solve_pcg(gk, consts, gn_iters=2, cg_iters=60, stats=st),
                    ).items():
                        st = {}
                        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                            run(st)
                            torch.cuda.synchronize()
                        per[name] = sum(1 for e in prof.events() if e.name in LAUNCHES) / st["gn_iters"]
                    line += f"; launches a Gauss-Newton iteration sharded {per['sharded']:.0f}, unsharded {per['unsharded']:.0f}"
                print(line, flush=True)
                for gap in (gap_s, gap_u):
                    check(gap[0] <= 2e-3 and gap[1] <= 1e-4, f"distributed PCG float32 K={K}: {line}")
                # both final costs sit at float32's rounding floor, where two
                # runs of one algorithm part by 0.4-7.7% (the order of the
                # card's atomic sums); an unsettled or wrong solve ends
                # orders of magnitude above it
                check(abs(cs - cu) <= 0.25 * cu, f"distributed PCG float32 K={K}: {line}")
        finally:
            dist.destroy_process_group()


def run_two_robots(dev):
    """``parallel/dist_runner``'s pipeline mode: 2 ranks over gloo on the
    one card (gloo reduces CUDA tensors through the host), each running
    its robot's front end at bench.py's widths and rates on the runner's
    tracks, the keyframes gathered, rank 0's manager closing the
    cross-session loop, and the graph solved edge-sharded by both.  Gates:
    at least one cross-session loop, max |dp| < 0.05 m from the
    single-process solve (tests/test_distributed_mp.py), the cost within
    5% of it, both ranks' poses bit-equal, nothing of the reference
    package loaded in either rank.  Where no cross-session loop closes at
    bench.py's widths, it runs again at the runner's own and says so."""
    from liwslam_torch.parallel import dist_runner as dr

    t0 = time.perf_counter()
    v = dr.launch(dr.RunConfig(mode="pipeline", num_processes=2, device="cuda", backend="gloo", widths="bench"))
    note = "bench.py's widths and rates"
    if v["cross_session_loops"] < 1:
        print(f"two-robot pipeline: no cross-session loop at bench.py's widths ({json.dumps(v)}); again at the runner's own", flush=True)
        v = dr.launch(dr.RunConfig(mode="pipeline", num_processes=2, device="cuda", backend="gloo", widths="runner"))
        note = "the runner's own widths and rates (none closed at bench.py's)"
    wall = time.perf_counter() - t0
    cm, cs = v["cost_multi"], v["cost_single"]
    ranks = ", ".join(f"rank {r['rank']}: {r['frames']} frames at {r['frames_per_s']:.1f} frames/s" for r in v["ranks"])
    print(
        f"two-robot pipeline (2 ranks, gloo, one card, {note}): {ranks}; keyframes {v['keyframes']} edges {v['edges']} "
        f"cross-session loops {v['cross_session_loops']}; allgather {v['gather_s']:.3f}s, sharded solve {v['solve_s']:.3f}s "
        f"(gn_iters {v['gn_iters']}, all_reduce calls {json.dumps(v['reductions'])}); cost initial {v['cost_initial']:.6g} "
        f"sharded {cm:.6g} single {cs:.6g}; max |dp| {v['max_dp']:.2e} m; ranks bit-equal {v['ranks_equal']}; wall {wall:.1f}s",
        flush=True,
    )
    check(v["cross_session_loops"] >= 1, f"two-robot pipeline: no cross-session loop: {v}")
    check(v["max_dp"] < 0.05, f"two-robot pipeline: max |dp| {v['max_dp']} m")
    check(abs(cm - cs) <= 0.05 * cs, f"two-robot pipeline: cost {cm} vs single {cs}")
    check(v["ranks_equal"], "two-robot pipeline: the ranks' poses differ")
    check(not v["reference_modules_loaded"], f"two-robot pipeline: a rank loaded {v['reference_modules_loaded']}")
    check(v["ok"], f"two-robot pipeline verdict: {v}")


MULTICARD_FRAMES = 32  # the composed flow's chunk


def run_multicard(streams, dev):
    """``parallel/dist_runner``'s composed mode at bench.py's widths (the
    counterpart of ``__graft_entry__.dryrun_multichip``): B = 8 W sequences
    of the bench track (seeds 1.., simulated by :func:`run_multiseq` and
    handed to the ranks as files) split over W = ``device_count`` NCCL
    ranks, a card each; with one card also B = 4 over W = 2 gloo ranks on
    it, so the split and the gather cross a process boundary.  Each rank
    initializes its sequences and steps them one chunk of
    ``MULTICARD_FRAMES`` frames (B1's and B2's counts set to 0 before the
    chunk and read after, in the rank); the gathered poses seed a K = 1024
    / E = 4096 graph (``dist_runner.composed_graph``) that the ranks solve
    edge-sharded.  Gates: the gathered poses equal one process's batched
    run of all B bit for bit and are finite; the sharded float64 solve
    within 1e-9 m and 1e-9 rad of the unsharded one (as
    :func:`check_pcg_dist`); the sharded float32 solve (20 / 60) within
    2e-3 m and 1e-4 rad of the float64 optimum; the ranks' poses bit-equal;
    B1 and B2 once a step on every rank; nothing of the reference loaded.
    With a second card, B1 and B2 are also launched on cuda:1 from this
    thread (:func:`check_other_card`).  Returns {run: B1 / B2 launches in
    the chunk over all ranks}."""
    import tempfile

    from liwslam_torch.parallel import dist_runner as dr

    n_cards = torch.cuda.device_count()
    runs = [("nccl", n_cards, 8 * n_cards)] + ([("gloo", 2, 4)] if n_cards == 1 else [])
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for b in range(max(B for _, _, B in runs)):
            dr.save_streams(tmp, 1 + b, streams[b])
        save_s = time.perf_counter() - t0
        for backend, W, B in runs:
            t0 = time.perf_counter()
            v = dr.launch(dr.RunConfig(mode="composed", num_processes=W, device="cuda", backend=backend, widths="bench",
                                       sequences=B, frames=MULTICARD_FRAMES, streams=tmp))
            wall = time.perf_counter() - t0
            ranks = v["ranks"]
            tag = f"composed ({backend}, W={W}, B={B})"
            print(
                f"{tag}: {v['frames_per_s']:.1f} frames/s in all, a rank "
                f"{', '.join(f'{r['frames_per_s']:.1f}' for r in ranks)} ({MULTICARD_FRAMES} frames, chunk s "
                f"{', '.join(f'{r['chunk_s']:.2f}' for r in ranks)}); launches in the chunk B1 "
                f"{[r['b1'] for r in ranks]} B2 {[r['b2'] for r in ranks]} (once a step: {MULTICARD_FRAMES}); init s "
                f"{', '.join(f'{r['init_s']:.1f}' for r in ranks)}, gather s {', '.join(f'{r['gather_s']:.4f}' for r in ranks)}; "
                f"gathered vs one process bit-equal {v['fe_bit_equal']} (max |dp| {v['fe_max_dp']:.2e} m); "
                f"graph K={v['K']} E={v['E']}: float32 sharded (20/60) {v['solve_s']:.2f}s gn_iters {v['gn_iters']} "
                f"cost {v['cost_initial']:.6g} -> {v['cost_sharded']:.6g}, from the float64 optimum |dp| "
                f"{v['max_dp32']:.2e} m |dq| {v['max_dq32']:.2e} rad (held to 2e-3, 1e-4; correction {v['correction_dp']:.2e} m "
                f"{v['correction_dq']:.2e} rad); float64 sharded vs unsharded |dp| {v['max_dp64']:.2e} m |dq| "
                f"{v['max_dq64']:.2e} rad (held to 1e-9), gn_iters {v['gn_iters64']}, sharded {v['solve64_s']:.1f}s, "
                f"unsharded {v['single64_s']:.1f}s (rank {W - 1}); one-process check {v['one_process_s']:.1f}s (rank 0); "
                f"ranks bit-equal {v['ranks_equal']}; "
                f"wall {wall:.1f}s (streams written in {save_s:.1f}s)",
                flush=True,
            )
            check(v["fe_bit_equal"] and v["fe_finite"], f"{tag}: gathered poses: {v}")
            check(v["max_dp64"] <= 1e-9 and v["max_dq64"] <= 1e-9, f"{tag}: float64 sharded vs unsharded: {v}")
            check(v["max_dp32"] <= 2e-3 and v["max_dq32"] <= 1e-4, f"{tag}: float32 vs the float64 optimum: {v}")
            check(v["ranks_equal"], f"{tag}: the ranks' poses differ")
            check(all(r["b1"] == r["b2"] == MULTICARD_FRAMES for r in ranks), f"{tag}: launches {ranks}")
            check(not v["reference_modules_loaded"], f"{tag}: a rank loaded {v['reference_modules_loaded']}")
            check(v["ok"], f"{tag} verdict: {v}")
            launches[f"{backend} W={W} B={B}"] = dict(
                track_solve=sum(r["b1"] for r in ranks), extract_lines=sum(r["b2"] for r in ranks)
            )
    if n_cards > 1:
        check_other_card(dev)
    else:
        print("device guard: one card here, so a launch on cuda:1 from a thread whose current device is 0 was not shown",
              flush=True)
    return launches


def check_other_card(dev):
    """Kernels B2 and B1 launched once each on ``cuda:1`` from this thread,
    whose current device stays ``dev``, against their plain versions on
    the same inputs (each launch runs under its inputs' device): B2 on a
    bench scan (lines aligned within 1 cm, as :func:`check_extract`), B1 on
    the two-frame problem (:func:`_check_b1`'s bounds)."""
    from liwslam_torch.ops import extract as ext
    from liwslam_torch.ops import track_solve as ts

    other = torch.device("cuda", 1)
    check(torch.cuda.current_device() == dev.index, "device guard: this thread's current device moved")
    prm = bench_params()
    from liwslam_torch.frontend.driver import Frontend

    frames, _ = Frontend(prm, device="cpu").pack_frames(_l_track_streams(prm)[1])
    kw = dict(continuous_threshold=prm.line_continuous_threshold, min_len=prm.line_min_len, max_dis=prm.line_max_dis,
              tolerance_angle_rad=prm.line_max_tolerance_angle_rad, max_lines=prm.max_lines)
    f = frames[len(frames) // 2]
    pts, ok = torch.as_tensor(f.points, device=other), torch.as_tensor(f.point_valid, device=other)
    n2, n1 = ext.extract_lines_batched.launches, ts.lm_solve_track_batched.launches
    outs = [fn(pts, ok, **kw) for fn in (ext.extract_lines, ext.extract_lines_plain)]
    (la, lb) = (torch.cat([e1, e2], 1).cpu().numpy()[lv.cpu().numpy()] for e1, e2, lv, _ in outs)
    _, miss, err2 = greedy_align(la, lb, 1e-2)
    inp, frozen = b1_problem(prm, other)
    err1 = _check_b1(inp, frozen, prm.solver_max_iterations, "on cuda:1")[0]
    launched = (ext.extract_lines_batched.launches - n2, ts.lm_solve_track_batched.launches - n1)
    print(
        f"device guard: from a thread on cuda:{torch.cuda.current_device()}, B2 on cuda:1 {len(la)} lines against "
        f"{len(lb)} ({miss} unmatched, max endpoint err {err2:.2e} m), B1 on cuda:1 max |x err| {err1:.2e}; "
        f"launches B2 {launched[0]} B1 {launched[1]}",
        flush=True,
    )
    check(launched == (1, 1), f"device guard: launches {launched}")
    check(len(la) > 0 and miss <= 1 and err2 < 1e-2, f"device guard: B2 on cuda:1: {len(la)} / {len(lb)} lines, {miss} unmatched")


def run_dynamic(prm, dev):
    """``Frontend.run`` at bench.py's widths and rates on the L track in
    ``square_room(obstacles=True)`` with tests/test_dynamic.py's three
    moving boxes and noise, B1's and B2's counts set to 0 before and read
    after.  Gates (tests/test_dynamic.py:109-123): ATE < 0.12 m without
    alignment, the median of the frames' line matches >= 4."""
    from liwslam_torch.eval import metrics
    from liwslam_torch.frontend.driver import Frontend
    from liwslam_torch.ops import extract as ext
    from liwslam_torch.ops import track_solve as ts
    from liwslam_torch.sim import world as sim

    movers = [
        sim.MovingBox(center=(2.0, 1.0), size=(0.5, 0.5), velocity=(0.5, 0.0), period=3.0),
        sim.MovingBox(center=(-1.5, 2.5), size=(0.4, 0.6), velocity=(0.0, 0.4), period=2.5),
        sim.MovingBox(center=(0.5, -2.0), size=(0.6, 0.4), velocity=(0.35, 0.35), period=4.0),
    ]
    streams = sim.simulate(
        sim.default_track("L"), sim.square_room(obstacles=True), prm, imu_hz=200, wheel_hz=20, laser_hz=10,
        n_beams=1080, noise=True, movers=movers, seed=0,
    )
    fe = Frontend(prm, device=dev)
    stamps = []
    ext.extract_lines_batched.launches = 0
    ts.lm_solve_track_batched.launches = 0
    res = fe.run(streams, chunk_size=64, chunk_callback=lambda info: stamps.append((time.perf_counter(), info["n"])))
    launches = dict(extract_lines=ext.extract_lines_batched.launches, track_solve=ts.lm_solve_track_batched.launches)
    fps = sum(n for _, n in stamps[1:]) / (stamps[-1][0] - stamps[0][0]) if len(stamps) > 1 else float("nan")
    pairs = metrics.associate_by_time(res.t_us, streams.gt_t_us)
    ate = metrics.ate_rmse(res.T_w_imu()[pairs[:, 0]], streams.gt_T_w_imu[pairs[:, 1]], align=False)
    med = float(np.median(res.n_match[res.n_match > 0]))
    print(
        f"dynamic scene (L track, 3 moving boxes, bench widths and rates): frames={len(res.t_us)} ATE={ate:.4f}m "
        f"median matches {med:.1f} tracked_fps={fps:.1f} launches={json.dumps(launches)}",
        flush=True,
    )
    check(np.all(np.isfinite(res.p)) and len(res.p) >= 40, "dynamic scene: bad or too few poses")
    check(launches["track_solve"] > 0 and launches["extract_lines"] > 0, f"dynamic scene: kernels not launched {launches}")
    check(ate < 0.12, f"dynamic-scene ATE {ate} m >= 0.12 m")
    check(med >= 4, f"dynamic scene: median matches {med} < 4")


def time_merge(streams):
    """The sensor merge of ``Frontend.pack_frames`` on the bench streams:
    the native merge beside its Python oracle, seconds each, equal."""
    from liwslam_torch.io import dispatch as dp

    times = [np.asarray(t) * 1e-6 for t in (streams.imu_t_us, streams.wheel_t_us, streams.laser_t_us, streams.cam_t_us)]
    dp.native_lib()
    t0 = time.perf_counter()
    native = dp.merge(times, watermark=1, drain=True)
    t1 = time.perf_counter()
    py = dp.merge_numpy(times, [True] * len(times), watermark=1, drain=True)
    t2 = time.perf_counter()
    check(all(np.array_equal(a, b) for a, b in zip(native, py)), "merge: native and Python orders differ")
    print(
        f"merge of the bench streams ({sum(len(t) for t in times)} messages): native {t1 - t0:.4f}s, Python {t2 - t1:.4f}s",
        flush=True,
    )


# ---------------------------------------------------------------- B3 ----


def _textured(H, W, seed=0):
    """A smooth textured image (tests/test_lk_kernel.py's)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.sin(x * 0.31) * np.cos(y * 0.23) + 0.5 * np.sin(x * 0.11 + y * 0.17)
    img = img + 0.3 * rng.standard_normal((H, W)).astype(np.float32)
    img = 0.25 * (img + np.roll(img, 1, 0) + np.roll(img, 1, 1) + np.roll(np.roll(img, 1, 0), 1, 1))
    return img.astype(np.float32)


def _shifted(img, dx, dy):
    """Bilinear shift: tracking img -> result recovers +(dx, dy)."""
    H, W = img.shape
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    xs, ys = np.clip(x - dx, 0, W - 2), np.clip(y - dy, 0, H - 2)
    x0, y0 = np.floor(xs).astype(int), np.floor(ys).astype(int)
    fx, fy = xs - x0, ys - y0
    return (
        img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy
    ).astype(np.float32)


def check_lk(cprm, images, dev):
    """Kernel B3 against tracker.lk_descent on the card: 20 consecutive
    image pairs of the bench camera stream (848x480) with the tracks that
    select_features picks, and a textured image shifted by (3.6, -2.3) px.
    ok flags agree on >= 95% of the tracks, positions within 0.05 px where
    both keep a track, the shift recovered to 0.15 px."""
    from liwslam_torch.camera import tracker as trk
    from liwslam_torch.ops import lk

    kw = dict(radius=cprm.cam_lk_radius, iters=cprm.cam_lk_iters)
    F = cprm.cam_feature_capacity
    n_trk = n_agree = n_both = 0
    err = 0.0
    start = len(images) // 3
    cases = []
    for i in range(start, start + 20):
        img0 = torch.as_tensor(images[i], device=dev)
        img1 = torch.as_tensor(images[i + 1], device=dev)
        pts, valid = trk.select_features(img0, F, cprm.feature_min_dis, cell_px=10)
        cases.append((img0, img1, pts, valid))
    H, W = CAM_WH[1], CAM_WH[0]
    tex = _textured(H, W)
    rng = np.random.default_rng(1)
    shift_pts = np.stack([rng.uniform(25, W - 25, F), rng.uniform(25, H - 25, F)], -1).astype(np.float32)
    cases.append((
        torch.as_tensor(tex, device=dev), torch.as_tensor(_shifted(tex, 3.6, -2.3), device=dev),
        torch.as_tensor(shift_pts, device=dev), torch.ones(F, dtype=torch.bool, device=dev),
    ))
    for j, (img0, img1, pts, valid) in enumerate(cases):
        pyr0 = trk.build_pyramid(img0, cprm.cam_lk_levels)
        pyr1 = trk.build_pyramid(img1, cprm.cam_lk_levels)
        gate = (cprm.cam_lk_max_err * torch.clamp(torch.amax(img0), min=1.0)).reshape(1)
        pk, okk = lk.lk_descent(pyr0, pyr1, pts, valid, gate, **kw)
        pp, okp = trk.lk_descent(pyr0, pyr1, pts, valid, gate, **kw)
        torch.cuda.synchronize()
        pk, okk, pp, okp = pk.cpu().numpy(), okk.cpu().numpy(), pp.cpu().numpy(), okp.cpu().numpy()
        v = valid.cpu().numpy()
        check(np.all(np.isfinite(pk[v])), f"B3 case {j}: non-finite positions")
        n_trk += int(v.sum())
        n_agree += int((okk == okp)[v].sum())
        both = okk & okp
        n_both += int(both.sum())
        if both.any():
            err = max(err, float(np.abs(pk[both] - pp[both]).max()))
        if j == len(cases) - 1:
            d = np.median(pk[okk] - shift_pts[okk], axis=0)
            check(okk.sum() >= 0.8 * F, f"B3 shift: {okk.sum()} of {F} tracks kept")
            check(np.abs(d - [3.6, -2.3]).max() < 0.15, f"B3 shift recovered as {d}")
    check(n_trk > 0 and n_agree >= 0.95 * n_trk, f"B3: ok flags agree on {n_agree} of {n_trk} tracks")
    check(err < 0.05, f"B3: position err {err} px where both keep a track")
    edge_err = check_lk_edges(cprm, dev)

    img0, img1, pts, valid = cases[0]
    pyr0 = trk.build_pyramid(img0, cprm.cam_lk_levels)
    pyr1 = trk.build_pyramid(img1, cprm.cam_lk_levels)
    gate = (cprm.cam_lk_max_err * torch.clamp(torch.amax(img0), min=1.0)).reshape(1)
    call = lambda: lk.lk_descent(pyr0, pyr1, pts, valid, gate, **kw)
    call_ms = time_ms(call)
    ms = kernel_ms(call, "lk_track_kernel")
    # fixed part (staging, patch0 and gradients, verification) and one
    # Gauss-Newton iteration: the same call with no iterations
    fixed_ms = kernel_ms(lambda: lk.lk_descent(pyr0, pyr1, pts, valid, gate, **dict(kw, iters=0)), "lk_track_kernel")
    per_iter_ms = (ms - fixed_ms) / (cprm.cam_lk_levels * cprm.cam_lk_iters)
    plain_ms = time_ms(lambda: trk.lk_descent(pyr0, pyr1, pts, valid, gate, **kw), n=20, warm=2)
    # bound, counted for the valid tracks of this call: each level reads a
    # (P+3)^2 window of img0 (patch, +-1 px gradients, bilinear) and a
    # (P+1)^2 window of img1, plus the level-0 verification windows; ~10
    # f32 ops a bilinear tap, 5 taps a pixel for patch0 and gradients,
    # 1 + 4 ops a pixel an iteration, 2 taps and 2 ops a pixel to verify
    n_valid = int(valid.sum())
    P = 2 * cprm.cam_lk_radius + 1
    L, it = cprm.cam_lk_levels, cprm.cam_lk_iters
    nbytes = 4 * n_valid * (L * ((P + 3) ** 2 + (P + 1) ** 2) + (P + 1) ** 2 * 2) + len(valid) * (8 + 1 + 8 + 1) + 4
    nops = n_valid * (L * (P * P * (5 * 10 + 6) + it * P * P * 15) + P * P * 22)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, nops / F32_FLOP_S * 1e3
    rsc = kernel_resources("lk_track")
    print(
        f"B3 lk_track: {len(cases)} image pairs ({CAM_WH[0]}x{CAM_WH[1]}, T={F}), ok flags agree on "
        f"{n_agree} of {n_trk} tracks, max position err {err:.3e} px over {n_both} tracks kept by both "
        f"(edges {edge_err:.3e}); kernel {ms:.4f} ms on the device ({call_ms:.4f} ms a call; fixed "
        f"{fixed_ms:.4f} + {per_iter_ms:.4f} an iteration), plain {plain_ms:.4f} ms a call; {rsc}",
        flush=True,
    )
    return dict(
        name="lk_track",
        route="cuda",
        source="liwslam_torch/csrc/lk_track.cu",
        replaces="liwslam/ops/lk.py:246",
        max_abs_err=max(err, edge_err),
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,
        call_ms=call_ms,
        fixed_ms=fixed_ms,
        per_iter_ms=per_iter_ms,
        **rsc,
    )


def _blurred(H, W, sigma=6.0, seed=2):
    """White noise blurred by a Gaussian of ``sigma`` px (a texture whose
    coarse pyramid levels still carry it: LK follows a 12 px shift)."""
    rng = np.random.default_rng(seed)
    fy, fx = np.fft.fftfreq(H)[:, None], np.fft.fftfreq(W)[None, :]
    g = np.exp(-2 * (np.pi * sigma) ** 2 * (fx**2 + fy**2))
    img = np.real(np.fft.ifft2(np.fft.fft2(rng.standard_normal((H, W))) * g))
    return (img / img.std()).astype(np.float32)


def check_lk_edges(cprm, dev):
    """Kernel B3 at the edges of its thread mapping, against
    tracker.lk_descent, with check_lk's tolerances (ok flags agree on >=
    95% of the tracks, 0.05 px where both keep a track, a shift recovered
    to 0.15 px): a smooth texture shifted by (12.4, -9.7) px, so that at
    level 0 the patch leaves the staged window of img1 (lk.MARGIN = 8 px
    around the start) and its taps read device memory; radius 15 (the
    other instantiation, one warp a row); T = 47 and T = 1 (not a multiple
    of the tracks a block); and a third of the tracks invalid (they keep
    their positions and are not ok)."""
    from liwslam_torch.camera import tracker as trk
    from liwslam_torch.ops import lk

    H, W = CAM_WH[1], CAM_WH[0]
    L, it = cprm.cam_lk_levels, cprm.cam_lk_iters
    rng = np.random.default_rng(3)
    pts = lambda T, m=40: torch.as_tensor(
        np.stack([rng.uniform(m, W - m, T), rng.uniform(m, H - m, T)], -1).astype(np.float32), device=dev
    )
    tex, blur = _textured(H, W), _blurred(H, W)
    on = lambda T: torch.ones(T, dtype=torch.bool, device=dev)
    some = torch.as_tensor(rng.uniform(size=48) > 1 / 3, device=dev)
    cases = [
        ("shift (12.4, -9.7)", blur, (12.4, -9.7), pts(48), on(48), cprm.cam_lk_radius),
        ("radius 15", tex, (3.6, -2.3), pts(48), on(48), 15),
        ("T=47", tex, (3.6, -2.3), pts(47), on(47), cprm.cam_lk_radius),
        ("T=1", tex, (3.6, -2.3), pts(1), on(1), cprm.cam_lk_radius),
        ("invalid tracks", tex, (3.6, -2.3), pts(48), some, cprm.cam_lk_radius),
    ]
    n_trk = n_agree = 0
    err = 0.0
    for name, img, (sx, sy), p0, valid, radius in cases:
        img0 = torch.as_tensor(img, device=dev)
        img1 = torch.as_tensor(_shifted(img, sx, sy), device=dev)
        pyr0, pyr1 = trk.build_pyramid(img0, L), trk.build_pyramid(img1, L)
        gate = (cprm.cam_lk_max_err * torch.clamp(torch.amax(img0), min=1.0)).reshape(1)
        pk, okk = lk.lk_descent(pyr0, pyr1, p0, valid, gate, radius=radius, iters=it)
        pp, okp = trk.lk_descent(pyr0, pyr1, p0, valid, gate, radius=radius, iters=it)
        torch.cuda.synchronize()
        pk, okk, pp, okp = pk.cpu().numpy(), okk.cpu().numpy(), pp.cpu().numpy(), okp.cpu().numpy()
        v, p0 = valid.cpu().numpy(), p0.cpu().numpy()
        check(np.all(np.isfinite(pk)), f"B3 {name}: non-finite positions")
        check(np.array_equal(pk[~v], p0[~v]) and not okk[~v].any(), f"B3 {name}: an invalid track moved or is ok")
        n_trk += int(v.sum())
        n_agree += int((okk == okp)[v].sum())
        both = okk & okp
        if both.any():
            err = max(err, float(np.abs(pk[both] - pp[both]).max()))
        check(okk.sum() >= 0.8 * v.sum(), f"B3 {name}: {okk.sum()} of {v.sum()} tracks kept")
        d = np.median(pk[okk] - p0[okk], axis=0)
        check(np.abs(d - [sx, sy]).max() < 0.15, f"B3 {name}: shift recovered as {d}")
        if name.startswith("shift"):
            # the level-0 patch moved more than MARGIN px from where the
            # window was staged: its taps came from device memory
            moved = np.abs(np.floor(pk[okk]) - np.floor(p0[okk])).max(1)
            check(np.all(moved > lk.MARGIN), f"B3 {name}: a kept track moved only {moved.min()} px")
    check(n_agree >= 0.95 * n_trk, f"B3 edges: ok flags agree on {n_agree} of {n_trk} tracks")
    check(err < 0.05, f"B3 edges: position err {err} px where both keep a track")
    print(
        f"B3 edges: {', '.join(c[0] for c in cases)}: ok flags agree on {n_agree} of {n_trk} tracks, "
        f"max position err {err:.3e} px",
        flush=True,
    )
    return err


# ---------------------------------------------------------------- B4 ----


def b4_problem(prm, dev, F=48, Wc=8, n_free=40, seed=0, min_views=2):
    """A camera joint solve like tests/test_cam_solve.py's: the two-frame
    problem's IMU, wheel, ground and prior rows (no laser rows), F
    landmarks 3.5-6.5 m in front of the camera frame, Wc window slots (the
    older at poses perturbed from the camera frame's), observations with
    1e-3 noise, 5% of the rows unused, those of the first ``n_free``
    landmarks with at least ``min_views`` used rows free (the camera path
    frees a landmark only with cam_min_obs views: with one, its depth is
    unobservable), the camera pose and the landmarks perturbed."""
    from liwslam_torch.core import geometry as geo
    from liwslam_torch.ops import cam_solve, track_solve

    x0, data, consts, x_true = two_frame_problem(prm, dev, M=1)
    data = data._replace(laser_valid=torch.zeros(1, dtype=torch.bool, device=dev))
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    Tic = np.asarray(prm.mat_T_imu_to_camera(), np.float64)
    p1, q1 = x_true[15:18].cpu().double().numpy(), x_true[18:21].cpu().double().numpy()
    T_w_i = lambda p, q: geo.make_tf(torch.as_tensor(p), torch.as_tensor(q)).numpy()
    T_w_c1 = T_w_i(p1, q1) @ Tic
    pts_c = rng.uniform(-1.5, 1.5, (F, 3)) + [0, 0, 5.0]
    world = (T_w_c1 @ np.concatenate([pts_c, np.ones((F, 1))], 1).T).T[:, :3]
    ring_p = p1[None] + rng.uniform(-0.3, 0.3, (Wc, 3))
    ring_q = q1[None] + rng.normal(0, 0.03, (Wc, 3))
    obs = np.zeros((F, Wc, 2))
    for w in range(Wc):
        T = T_w_i(p1, q1) if w == Wc - 1 else T_w_i(ring_p[w], ring_q[w])
        c = (np.linalg.inv(T @ Tic) @ np.concatenate([world, np.ones((F, 1))], 1).T).T
        obs[:, w] = c[:, :2] / c[:, 2:3] + rng.normal(0, 1e-3, (F, 2))
    use = rng.random((F, Wc)) > 0.05
    lm_free = (np.arange(F) < n_free) & (use.sum(1) >= min_views)
    x0 = x_true.clone()
    x0[15:18] += f32([0.03, -0.02, 0.01])
    x0[18:21] += f32([0.01, -0.008, 0.015])
    free, frozen = track_solve.tracking_free_mask(False)
    inp = cam_solve.pack_inputs(
        x0, f32(free), f32(world + rng.normal(0, 0.1, (F, 3))), f32(lm_free), f32(obs), f32(use),
        f32(ring_p), f32(ring_q), data, consts, f32(Tic), f32([400.0, 400.0]),
    )
    return inp, frozen


def tilted(inp, rad=0.02):
    """``inp`` with both window frames and the ring poses rolled by ``rad``.
    On level ground the ground-tilt rows of the solution sit at their kink
    (tilt ~1e-6 rad), where their Jacobian's direction is float32 noise in
    any implementation and the Schur-reduced prior differs by ~10% between
    two correct ones; at 0.02 rad it is well defined."""
    x0, ring = inp.base.x0.clone(), inp.ring.clone()
    x0[:, 3] += rad
    x0[:, 18] += rad
    ring[:, :, 3] += rad
    return inp._replace(base=inp.base._replace(x0=x0), ring=ring)


def _check_b4(inp, frozen, max_iters, name):
    """Kernel B4 against lm_solve_cam_plain on the same inputs, each of the
    B systems against its own plain run, with tests/test_cam_solve.py's
    tolerances: poses atol 1e-3, x atol 5e-3, free landmarks atol 5e-3,
    frozen landmarks unchanged, cost within 2%, Schur quadratic forms
    within 10%, dg within 1e-4 of the dH scale.  Returns (max |x, landmark
    err| over the systems, kernel iterations, plain iterations, kernel
    cost, plain cost) of system 0."""
    from liwslam_torch.ops import cam_solve as cs

    outk = cs.lm_solve_cam_batched(inp, max_iters=max_iters, frozen_dims=frozen)
    outp = cs.lm_solve_cam_plain(inp, max_iters=max_iters)
    torch.cuda.synchronize()
    err = 0.0
    for b in range(inp.world0.shape[0]):
        tag = f"B4 {name} system {b}"
        n = lambda t: t[b].cpu().double().numpy()
        xk, wk, ck, dHk, dgk, _ = map(n, outk)
        xp, wp, cp, dHp, dgp, _ = map(n, outp)
        ck, cp = float(ck), float(cp)
        lmf = inp.lm_free[b].cpu().numpy() > 0
        w0 = inp.world0[b].cpu().double().numpy()
        check(np.all(np.isfinite(xk)) and np.all(np.isfinite(wk)) and np.isfinite(ck), f"{tag}: non-finite output")
        check(np.abs(xk[15:21] - xp[15:21]).max() < 1e-3, f"{tag}: pose err {np.abs(xk[15:21] - xp[15:21]).max()}")
        check(np.abs(xk - xp).max() < 5e-3, f"{tag}: x err {np.abs(xk - xp).max()}")
        werr = float(np.abs(wk[lmf] - wp[lmf]).max()) if lmf.any() else 0.0
        check(werr < 5e-3, f"{tag}: landmark err {werr}")
        check(np.array_equal(wk[~lmf], w0[~lmf]), f"{tag}: a frozen landmark moved")
        check(abs(ck - cp) < 0.02 * max(cp, 1e-3), f"{tag}: cost {ck} vs plain {cp}")
        rng = np.random.default_rng(5)
        scale = np.abs(dHp).max()
        for _ in range(16):
            v = rng.normal(size=15)
            v /= np.linalg.norm(v)
            qk, qp = v @ dHk @ v, v @ dHp @ v
            check(abs(qk - qp) < 0.10 * max(abs(qp), 1e-4 * scale), f"{tag}: Schur form {qk} vs {qp}")
        check(np.abs(dgk - dgp).max() < 1e-4 * scale, f"{tag}: dg err {np.abs(dgk - dgp).max()}")
        err = max(err, float(np.abs(xk - xp).max()), werr)
    return err, int(outk[5][0]), int(outp[5][0]), float(outk[2][0]), float(outp[2][0])


def single_view_spread(prm, dev, frozen, max_iters):
    """(F, Wc) = (48, 1) with 40 free landmarks, two systems (seeds 0, 1):
    each landmark has one view, so its depth is unobservable and only the
    damping pins it.  Runs the kernel, the plain version and the plain
    version in float64 on the same inputs and prints how far the three
    landmark solutions lie apart; checks the kernel's poses (atol 1e-3) and
    cost (2%) against the plain version.  Its landmarks are not held to
    _check_b4's 5e-3: the float32 and float64 runs of the plain version
    already disagree by more."""
    from liwslam_torch.ops import cam_solve as cs

    inp = tilted(stack_inputs([b4_problem(prm, dev, F=48, Wc=1, seed=sd, min_views=1)[0] for sd in (0, 1)]))
    to64 = lambda t: type(t)(*map(to64, t)) if isinstance(t, tuple) else t.double()
    outk = cs.lm_solve_cam_batched(inp, max_iters=max_iters, frozen_dims=frozen)
    outp = cs.lm_solve_cam_plain(inp, max_iters=max_iters)
    out64 = cs.lm_solve_cam_plain(to64(inp), max_iters=max_iters)
    lmf = inp.lm_free > 0
    far = lambda a, b: float((a.double() - b.double())[lmf].abs().max())
    pose = lambda a, b: float((a.double() - b.double())[:, 15:21].abs().max())
    ck, cp = outk[2].double(), outp[2].double()
    check(torch.isfinite(outk[0]).all() and torch.isfinite(outk[1]).all(), "B4 single view: non-finite output")
    check(pose(outk[0], outp[0]) < 1e-3, f"B4 single view: pose err {pose(outk[0], outp[0])}")
    check(bool(((ck - cp).abs() < 0.02 * cp.clamp(min=1e-3)).all()), f"B4 single view: cost {ck} vs plain {cp}")
    print(
        f"B4 single view (F=48, Wc=1, {int(lmf.sum())} free landmarks in 2 systems): landmarks apart by "
        f"kernel-plain {far(outk[1], outp[1]):.3e}, kernel-plain64 {far(outk[1], out64[1]):.3e}, "
        f"plain-plain64 {far(outp[1], out64[1]):.3e}; poses apart by kernel-plain {pose(outk[0], outp[0]):.3e}, "
        f"kernel-plain64 {pose(outk[0], out64[0]):.3e}, plain-plain64 {pose(outp[0], out64[0]):.3e}",
        flush=True,
    )


def check_cam_solve(prm, cprm, captured, dev):
    """Kernel B4 against its plain version on one camera sub-step's inputs
    captured from the camera main path, on the synthetic problem, on a
    batch of three different synthetic systems (the per-block indexing)
    and at the edges of its thread mapping (F = 1, Wc = 1, Wc = 2, and the
    largest (F, Wc) that the shared memory admits at F = F_MAX and at Wc =
    WC_MAX), all :func:`tilted`; timed on the captured one, with the fixed
    and per-iteration split of its device time."""
    from liwslam_torch.ops import cam_solve as cs

    max_iters = cprm.solver_max_iterations
    syn, frozen = b4_problem(prm, dev)
    e1, *_ = _check_b4(tilted(syn), frozen, max_iters, "synthetic")
    batch = [b4_problem(prm, dev, seed=seed)[0] for seed in (1, 2, 3)]
    e1 = max(e1, _check_b4(tilted(stack_inputs(batch)), frozen, max_iters, "batch of 3")[0])
    wc_max_f = max(f for f in range(1, cs.F_MAX + 1) if cs.smem_bytes(f, cs.WC_MAX) <= cs.SMEM_MAX)
    f_max_wc = max(w for w in range(1, cs.WC_MAX + 1) if cs.smem_bytes(cs.F_MAX, w) <= cs.SMEM_MAX)
    edges = ((1, 8), (48, 1), (48, 2), (cs.F_MAX, f_max_wc), (wc_max_f, cs.WC_MAX))
    for F, Wc in edges:
        # at Wc = 1 no landmark has the two views b4_problem frees it with:
        # the pose against fixed points
        inp_e, _ = b4_problem(prm, dev, F=F, Wc=Wc, n_free=max(1, F * 5 // 6))
        e1 = max(e1, _check_b4(tilted(inp_e), frozen, max_iters, f"F={F} Wc={Wc}")[0])
    single_view_spread(prm, dev, frozen, max_iters)
    inp, frozen = captured
    inp = tilted(inp)
    e2, itk, itp, ck, cp = _check_b4(inp, frozen, max_iters, "bench sub-step")
    kw = dict(max_iters=max_iters, frozen_dims=frozen)
    call_ms = time_ms(lambda: cs.lm_solve_cam_batched(inp, **kw))
    ms = kernel_ms(lambda: cs.lm_solve_cam_batched(inp, **kw), "cam_solve_kernel")
    plain_ms = time_ms(lambda: cs.lm_solve_cam_plain(inp, max_iters=max_iters), n=10, warm=1)
    split = iteration_split(lambda k: cs.lm_solve_cam_batched(inp, max_iters=k, frozen_dims=frozen), "cam_solve_kernel")
    rsc = kernel_resources("cam_solve")
    F, Wc = inp.obs.shape[1:3]
    n_use = int(inp.use.sum())
    n_lin = itk + 1
    nbytes = sum(t.numel() * 4 for t in inp.base) + sum(t.numel() * 4 for t in inp[1:]) + (30 + 3 * F + 1 + 225 + 15 + 1) * 4
    # operations, counted from the source: base rows as B1's without laser
    # (dual numbers, ~7 ops a scalar op), their H, g and cost; each used
    # camera row pair ~150 scalar ops in one landmark pass (x7) and, for
    # the F current cells, one pose pass (x7); landmark blocks ~(30 Wc + 120)
    # a landmark.  Each step: inverse and Schur shares ~250 a landmark, the
    # 30x30 Cholesky and solves ~12800, back-substitution ~60 a landmark.
    # The Schur reduction: ~16300.
    lin_ops = 7 * (5 * 1500 + 2 * 1200 + 2 * 400) + 5 * 1260 + 2 * (900 * 37 + 30 * 37 + 37)
    lin_ops += 7 * 150 * (n_use + F) + F * (30 * Wc + 120)
    nops = n_lin * lin_ops + (n_lin - 1) * (F * 310 + 12800) + 16300
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, nops / F32_FLOP_S * 1e3
    print(
        f"B4 cam_solve: F={F}, Wc={Wc}, {n_use} camera rows used, kernel {itk} / plain {itp} LM iterations, "
        f"max |x, landmark err| {max(e1, e2):.3e} (bench sub-step, synthetic, a batch of 3, (F, Wc) = "
        f"{', '.join(map(str, edges))}), cost {ck:.6g} vs {cp:.6g}; kernel {ms:.4f} ms on the device "
        f"({call_ms:.4f} ms a call; fixed {split['fixed_ms']:.4f} + {split['per_iter_ms']:.4f} an iteration), "
        f"plain {plain_ms:.4f} ms a call; {rsc}",
        flush=True,
    )
    return dict(
        name="cam_solve",
        route="cuda",
        source="liwslam_torch/csrc/cam_solve.cu",
        replaces="liwslam/ops/cam_solve.py:437",
        max_abs_err=max(e1, e2),
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,
        call_ms=call_ms,
        fixed_ms=split["fixed_ms"],
        per_iter_ms=split["per_iter_ms"],
        **rsc,
    )


# -------------------------------------------------------- the parent ----


def build_parent(name, src):
    """Compile ``src`` (a parent's B2 or B3 source with this tree's C
    interface) with the port's nvcc flags into liwslam_torch/_build/ as
    ``lib<name>.parent.so``; returns (its ``liwslam_<name>`` entry, spill
    bytes in ptxas's report)."""
    import ctypes
    import os
    import re

    from liwslam_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(_build.BUILD_DIR, f"lib{name}.parent.so")
    cmd = [_build.find_nvcc(), *_build.FLAGS, "-o", lib, src]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"build of {src} failed:\n{out.stdout}{out.stderr}")
    log = out.stdout + out.stderr
    return getattr(ctypes.CDLL(lib), f"liwslam_{name}"), sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log))


def time_in_turns(prm, cprm, frames, images, dev, parent):
    """Device ms (profiler, median of 60 launches) and ms a call (CUDA
    events, median of 60) of B2 and B3 at check_extract's and check_lk's
    timed cases, for the kernels built from the tree ``parent`` and this
    tree's, in turns: parent, change, change, parent.  The parent's lines
    or tracks are first held to this tree's kernel's on the timed case."""
    import os

    from liwslam_torch.camera import tracker as trk
    from liwslam_torch.ops import extract as ext
    from liwslam_torch.ops import lk

    kw = dict(
        continuous_threshold=prm.line_continuous_threshold,
        min_len=prm.line_min_len,
        max_dis=prm.line_max_dis,
        tolerance_angle_rad=prm.line_max_tolerance_angle_rad,
        max_lines=prm.max_lines,
    )
    pts = torch.as_tensor(frames[0].points, device=dev)
    val = torch.as_tensor(frames[0].point_valid, device=dev)
    start = len(images) // 3
    img0 = torch.as_tensor(images[start], device=dev)
    img1 = torch.as_tensor(images[start + 1], device=dev)
    tp, tv = trk.select_features(img0, cprm.cam_feature_capacity, cprm.feature_min_dis, cell_px=10)
    pyr0 = trk.build_pyramid(img0, cprm.cam_lk_levels)
    pyr1 = trk.build_pyramid(img1, cprm.cam_lk_levels)
    gate = (cprm.cam_lk_max_err * torch.clamp(torch.amax(img0), min=1.0)).reshape(1)
    lkw = dict(radius=cprm.cam_lk_radius, iters=cprm.cam_lk_iters)
    calls = {
        "extract_lines": (ext, lambda: ext.extract_lines(pts, val, **kw), "extract_lines_kernel"),
        "lk_track": (lk, lambda: lk.lk_descent(pyr0, pyr1, tp, tv, gate, **lkw), "lk_track_kernel"),
    }
    rows = []
    for name, (mod, call, kname) in calls.items():
        own = mod._lib()
        fn, spill = build_parent(name, os.path.join(parent, "liwslam_torch", "csrc", name + ".cu"))
        fn.argtypes, fn.restype = own.argtypes, own.restype
        lib = mod._lib
        try:
            ref = [t.cpu().numpy() for t in call()]
            mod._lib = lambda: fn
            out = [t.cpu().numpy() for t in call()]
            if name == "extract_lines":
                la, lb = (np.concatenate([o[0], o[1]], 1)[o[2]] for o in (out, ref))
                _, miss, _ = greedy_align(la, lb, 1e-2)
                check(abs(len(la) - len(lb)) <= 1 and miss <= 2, f"parent: {len(la)} lines vs {len(lb)}, {miss} unmatched")
            else:
                both = out[1] & ref[1]
                check((out[1] == ref[1]).mean() >= 0.95, "parent: ok flags differ")
                check(not both.any() or np.abs(out[0][both] - ref[0][both]).max() < 0.05, "parent: positions differ")
            order = [("parent", fn, spill), ("this tree", own, None), ("this tree", own, None), ("parent", fn, spill)]
            for label, f, sb in order:
                mod._lib = lambda f=f: f
                rows.append(dict(kernel=name, variant=label, ms=kernel_ms(call, kname), call_ms=time_ms(call), spill_bytes=sb))
        finally:
            mod._lib = lib
    for r in rows:
        print(f"in turns: {r['kernel']} {r['variant']}: {r['ms']:.4f} ms on the device, {r['call_ms']:.4f} ms a call", flush=True)
    print(json.dumps({"in_turns": rows}), flush=True)
    return rows


# ------------------------------------------------------- camera path ----


def run_camera_path(cprm, streams, dev, laser_ate):
    """Frontend.run with enable_camera at 848x480 / 30 Hz on the bench
    track; the kernels' launch counts set to 0 just before and read just
    after.  Checks B1-B4 ran (B3 once a camera message, B4 once an accepted
    camera frame after the init window), the camera gates of
    tests/test_camera_e2e.py and the ATE.  Returns (launches, one captured
    B4 input)."""
    from liwslam_torch.frontend.driver import Frontend
    from liwslam_torch.ops import cam_solve, lk
    from liwslam_torch.ops import extract as ext
    from liwslam_torch.ops import track_solve as ts

    fe = Frontend(cprm, device=dev)
    stamps = []
    captured = []
    pack = cam_solve.pack_inputs

    def capture(*a):
        inp = pack(*a)
        captured.append(inp)
        return inp

    def on_chunk(info):
        stamps.append((time.perf_counter(), info["n"]))

    cam_solve.pack_inputs = capture
    ext.extract_lines_batched.launches = 0
    ts.lm_solve_track_batched.launches = 0
    lk.lk_descent.launches = 0
    cam_solve.lm_solve_cam_batched.launches = 0
    try:
        t0 = time.perf_counter()
        res = fe.run(streams, chunk_size=64, chunk_callback=on_chunk)
        wall = time.perf_counter() - t0
    finally:
        cam_solve.pack_inputs = pack
    launches = dict(
        extract_lines=ext.extract_lines_batched.launches,
        track_solve=ts.lm_solve_track_batched.launches,
        lk_track=lk.lk_descent.launches,
        cam_solve=cam_solve.lm_solve_cam_batched.launches,
    )
    # what the run should have launched, from the packed frames
    frames, lt = fe.pack_frames(streams)
    n_init = int(len(res.t_us) - sum(n for _, n in stamps))
    tracked = sum(n for _, n in stamps)
    first = len(frames) - tracked
    n_msgs = sum((f.cam_idx >= 0) + int((f.extra_idx >= 0).sum()) for f in frames)
    n_cam_tracked = sum(f.cam_idx >= 0 for f in frames[first:])
    check(len(stamps) >= 2, "camera path: need at least two chunks (one is warm-up)")
    fps = sum(n for _, n in stamps[1:]) / (stamps[-1][0] - stamps[0][0])
    check(np.all(np.isfinite(res.p)) and res.p.shape == (len(res.t_us), 3), "camera path: bad poses")
    check(launches["cam_solve"] == n_cam_tracked, f"B4 launches {launches} != {n_cam_tracked} camera frames tracked")
    # LK runs on every camera message once the chain has a previous image;
    # the init window's messages are all observed too
    check(launches["lk_track"] == n_msgs, f"B3 launches {launches} != {n_msgs} camera messages")
    check(launches["track_solve"] == tracked, f"B1 launches {launches} != {tracked} tracked frames")
    check(launches["extract_lines"] >= tracked, f"B2 launches {launches} < {tracked} tracked frames")
    check(len(res.cam_t_us) >= 300, f"camera path: {len(res.cam_t_us)} camera frames solved (< 300)")
    check(np.median(res.cam_n_tracked) >= 5, f"camera path: median tracked {np.median(res.cam_n_tracked)} < 5")
    check(res.cam_n_ready.max() >= 3, f"camera path: max ready {res.cam_n_ready.max()} < 3")
    # the tracked laser frames, as the laser-only path measures them
    ate = tracked_ate(res, streams, tracked, "camera path")
    check(ate < 0.02, f"camera path ATE {ate} m >= 0.02 m")
    check(ate <= max(1.5 * laser_ate, 0.01), f"camera path ATE {ate} m > max(1.5 x laser-only {laser_ate}, 0.01)")
    print(
        f"camera path: {CAM_WH[0]}x{CAM_WH[1]} at {CAM_HZ:.0f} Hz, frames={len(res.t_us)} "
        f"init_window={n_init} tracked={tracked} camera_frames={len(res.cam_t_us)} "
        f"median_tracked={np.median(res.cam_n_tracked):.0f} max_ready={res.cam_n_ready.max()} "
        f"tracked_fps={fps:.2f} (after a {stamps[0][1]}-frame warm-up chunk) ATE={ate:.4f}m "
        f"(laser-only {laser_ate:.4f}m) wall={wall:.1f}s launches={json.dumps(launches)}",
        flush=True,
    )
    # the captured sub-step with the most camera rows in use
    best = max(captured[len(captured) // 4 :], key=lambda inp: float(inp.use.sum()))
    return launches, (best, fe.scfg.frozen_dims)


def main(argv):
    import argparse

    ap = argparse.ArgumentParser(description="Chip smoke test of liwslam_torch on one GPU.")
    ap.add_argument("--parent", help="a parent tree (unpacked under _archive/): time its B2 and B3 in turns with this tree's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU", file=sys.stderr)
        return 1
    from liwslam_torch.ops import _build

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} (torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    print(smi, flush=True)

    t0 = time.time()
    _build.load()
    ptxas = []
    for name, info in _build.build_info.items():
        if not info["log"]:
            ptxas.append(f"{name}: loaded from an earlier build")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                ptxas.append(f"{name}: {line.strip()}")
    print(f"build: {time.time() - t0:.1f}s " + " | ".join(ptxas), flush=True)

    prm = bench_params()
    cprm = cam_params(prm)
    t0 = time.time()
    # one simulation serves both paths: the laser-only path ignores the images
    streams = bench_streams(cprm, camera=True)
    from liwslam_torch.frontend.driver import Frontend

    frames, _ = Frontend(prm, device=dev).pack_frames(streams)
    print(
        f"bench track: {len(frames)} laser frames, {len(streams.cam_t_us)} camera images "
        f"{CAM_WH[0]}x{CAM_WH[1]}, simulated in {time.time() - t0:.1f}s",
        flush=True,
    )
    time_merge(streams)

    t_start = time.time()
    lap = lambda name: print(f"time: {name} done at {time.time() - t_start:.1f}s", flush=True)
    rows = [check_extract(prm, frames, dev), check_track_solve(prm, dev)]
    lap("kernel checks")
    launches, laser_ate, laser_res, laser_fps = run_main_path(prm, streams, dev)
    lap("main path")
    ms_rows, ms_inputs, ms_streams = run_multiseq(prm, dev)
    lap("multiseq")
    t0 = time.time()
    posthoc = run_backend_posthoc(prm, streams, laser_res, dev)
    lap("back end post hoc")
    run_online(prm, streams, dev, laser_res, posthoc, laser_fps)
    lap("online runner")
    check_pcg(prm, laser_res, dev)
    lap("PCG")
    check_score_memory(dev)
    lap("score_pairs memory")
    run_cli_bag(streams)
    lap("CLI on a bag")
    print(f"back-end phases: {time.time() - t0:.1f}s", flush=True)
    check_b1_along_path(prm, streams, dev, laser_ate)
    lap("B1 witness")
    check_b2_along_path(prm, streams, dev, laser_ate)
    lap("witnesses")
    check_pcg_dist(prm, laser_res, dev)
    lap("distributed PCG")
    run_two_robots(dev)
    lap("two-robot pipeline")
    multicard = run_multicard(ms_streams, dev)
    del ms_streams
    lap("multi-card composed flow")
    run_dynamic(prm, dev)
    lap("dynamic scene")
    cam_launches, captured = run_camera_path(cprm, streams, dev, laser_ate)
    rows += [check_lk(cprm, streams.cam_images, dev), check_cam_solve(prm, cprm, captured, dev)]
    lap("camera path")
    if args.parent:
        time_in_turns(prm, cprm, frames, streams.cam_images, dev, args.parent)
    from liwslam_torch.ops import extract as ext
    from liwslam_torch.ops import track_solve as ts

    launch = dict(track_solve=ts._launch, extract_lines=ext._launch)
    # one launch at B = 32 against the same inputs one system at a time
    # (after the paths' counts were read, so these launches count nowhere)
    b32 = {name: batch_against_one(name, launch[name], args) for name, args in ms_inputs.items()}
    lap("B = 32 against one system")
    for r in rows:
        # B1, B2: the laser-only main path; B3, B4: the camera path
        r["launches"] = launches.get(r["name"], cam_launches[r["name"]])
        r["launches_camera_path"] = cam_launches[r["name"]]
        if r["name"] in b32:
            # the multi-sequence step at B = 32: launches over its timed
            # chunk, the device ms of one launch on 32 systems or scans and
            # of the same inputs one system at a time
            row = ms_rows[max(MULTISEQ_B)]
            r["launches_multiseq_b32"] = int(round(row["b1" if r["name"] == "track_solve" else "b2"] * MULTISEQ_TIMED * MULTISEQ_CHUNK))
            r.update(b32[r["name"]])
            # the composed flow's chunk (run_multicard), over all its ranks
            r["launches_multicard"] = {run: n[r["name"]] for run, n in multicard.items()}
        # the same numbers under the names PERF.md's kernel table uses
        r["kernel_ms"], r["max_err"] = r["ms"], r["max_abs_err"]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
