"""Chip smoke test of the PyTorch/CUDA port (``liwslam_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each (any failed check raises and the exit code is not 0):

1. device: the CUDA device and ``nvidia-smi``'s name and power limit;
2. build: builds (or loads) the hand-written kernels from ``liwslam_torch/
   csrc`` and prints the build seconds and ptxas's register/spill report;
3. kernels against their plain PyTorch versions on the card, on the same
   inputs: B2 (line extraction) on 20 scans of the bench track, B1 (the
   tracking solve) on a two-frame problem with 64 line matches in both
   tracking modes (``fast_mode`` freezes more dims); each kernel is timed
   by its device duration (profiler, median of 60 launches) and, with its
   plain version, by CUDA events around each call (median of 60 calls
   after warm-up);
4. main path: ``liwslam_torch.frontend.driver.Frontend(device="cuda").run``
   on the synthetic office loop track at bench.py's full size (1080-beam
   scans at 10 Hz, IMU 200 Hz, wheel 20 Hz, noise on, seed 1), with the
   kernels' launch counts set to 0 just before and read just after; checks
   that both kernels ran, and the ATE against ground truth;
5. one JSON object ``{"kernels": [...]}`` with each kernel's launches on the
   main path, error against its plain version, times and bound.

The last line is ``{"ok": true, "device": {...}}``.  No CPU fallback: the
script exits non-zero when CUDA is not available.
"""

from __future__ import annotations

import json
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


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bench_params():
    from liwslam_torch import config

    return config.office().replace(
        max_points=1152,
        max_lines=64,
        max_corners=16,
        ref_capacity=1024,
        max_imu_per_frame=32,
        max_wheel_per_frame=8,
        solver_max_iterations=8,
        init_solver_max_iterations=25,
    )


def bench_streams(prm):
    from liwslam_torch.sim import world as sim

    return sim.simulate(
        sim.default_track("loop"),
        sim.square_room(size=12.0, obstacles=True, rich=True),
        prm,
        imu_hz=200,
        wheel_hz=20,
        laser_hz=10,
        n_beams=1080,
        noise=True,
        seed=1,
    )


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
    :func:`time_ms` also measure the host's gap before the launch."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    durs = [
        (e.time_range.end - e.time_range.start) / 1e3
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name
    ]
    check(len(durs) == n, f"profiler saw {len(durs)} launches of {kernel}, expected {n}")
    return statistics.median(durs)


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
    3%, corner misses <= 5%, counts within 1 / 2 per scan)."""
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
    err = 0.0
    for k in sel:
        pts = torch.as_tensor(frames[k].points, device=dev)
        valid = torch.as_tensor(frames[k].point_valid, device=dev)
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
    check(n_lines > 0, "B2: no lines extracted")
    check(line_miss <= max(2, 0.03 * n_lines), f"B2: {line_miss} of {n_lines} lines unmatched")
    check(corner_miss <= max(2, 0.05 * n_corners), f"B2: {corner_miss} of {n_corners} corners unmatched")

    pts = torch.as_tensor(frames[sel[0]].points, device=dev)
    valid = torch.as_tensor(frames[sel[0]].point_valid, device=dev)
    call_ms = time_ms(lambda: ext.extract_lines(pts, valid, **kw))
    ms = kernel_ms(lambda: ext.extract_lines(pts, valid, **kw), "extract_lines_kernel")
    plain_ms = time_ms(lambda: ext.extract_lines_plain(pts, valid, **kw), n=60, warm=3)
    N, L = pts.shape[0], prm.max_lines
    # bytes: points + valid in, e1 + e2 + line_valid + end_gap out
    nbytes = N * 3 * 4 + N + L * (2 * 2 * 4 + 1 + 4)
    # operations: ~230 f32 ops a point (7 prefix-sum columns, gaps and
    # centroid ~20, corner response ~25, NMS ~15, joint test ~30 with acos,
    # TLS fit and projections ~80, span distance ~6, gates ~10), counted
    # from the source
    nops = 230 * N
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, nops / F32_FLOP_S * 1e3
    print(
        f"B2 extract_lines: {len(sel)} scans, {n_lines} lines ({line_miss} unmatched), "
        f"{n_corners} corners ({corner_miss} unmatched), max endpoint err {err:.3e} m; "
        f"kernel {ms:.4f} ms on the device ({call_ms:.4f} ms a call), plain {plain_ms:.4f} ms a call",
        flush=True,
    )
    return dict(
        name="extract_lines",
        route="cuda",
        source="liwslam_torch/csrc/extract_lines.cu",
        replaces="liwslam/ops/extract.py:377",
        max_abs_err=err,
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,
        call_ms=call_ms,
    )


# ---------------------------------------------------------------- B1 ----


def b1_problem(prm, dev, M=64, fast_mode=False):
    """A two-frame tracking solve in the tracking layout: ground-truth
    states at scans 40, 41 of the simulator's L track, the IMU and wheel
    preintegration between them, M synthetic wall lines seen from both
    frames with 5 mm noise (30% of the rows masked), an SPD prior on frame
    0 (none in ``fast_mode``, as on the tracking path), and frame 1
    perturbed."""
    with_prior = not fast_mode
    from liwslam_torch.core import geometry as geo
    from liwslam_torch.frontend import preintegration as pre
    from liwslam_torch.ops import track_solve
    from liwslam_torch.sim import world as sim
    from liwslam_torch.solve import factors as fac

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    track = sim.default_track("L")
    streams = sim.simulate(track, sim.square_room(), prm, imu_hz=200, laser_hz=10)
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
    rng = np.random.default_rng(3)
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
    x0[15:18] += f32([0.04, -0.03, 0.01])
    x0[18:21] += f32([0.01, -0.01, 0.02])
    x0[21:24] += f32([0.03, 0.0, -0.02])
    free, frozen = track_solve.tracking_free_mask(fast_mode)
    return track_solve.pack_inputs(x0, f32(free), data, consts), frozen


def _check_b1(inp, frozen, max_iters):
    """Kernel B1 against lm_solve_track_plain on the same inputs: poses
    atol 5e-4, whole x atol 2e-3, cost <= 1.02x the plain cost, Schur
    quadratic forms within 10%, dg within 1e-4 of the dH scale.  Returns
    (max |x err|, kernel iterations, plain iterations, kernel cost, plain
    cost)."""
    from liwslam_torch.ops import track_solve as ts

    xk, ck, dHk, dgk, itk = ts.lm_solve_track_batched(inp, max_iters=max_iters, frozen_dims=frozen)
    xp, cp, dHp, dgp, itp = ts.lm_solve_track_plain(inp, max_iters=max_iters)
    torch.cuda.synchronize()
    xk, xp = xk[0].cpu().double().numpy(), xp[0].cpu().double().numpy()
    ck, cp = float(ck[0]), float(cp[0])
    dHk, dHp = dHk[0].cpu().double().numpy(), dHp[0].cpu().double().numpy()
    dgk, dgp = dgk[0].cpu().double().numpy(), dgp[0].cpu().double().numpy()
    check(np.all(np.isfinite(xk)) and np.isfinite(ck), "B1: non-finite output")
    check(np.abs(xk[15:21] - xp[15:21]).max() < 5e-4, f"B1 pose err {np.abs(xk[15:21] - xp[15:21]).max()}")
    err = float(np.abs(xk - xp).max())
    check(err < 2e-3, f"B1 x err {err}")
    check(ck <= cp * 1.02, f"B1 cost {ck} vs plain {cp}")
    rng = np.random.default_rng(5)
    scale = np.abs(dHp).max()
    for _ in range(16):
        v = rng.normal(size=15)
        v /= np.linalg.norm(v)
        qk, qp = v @ dHk @ v, v @ dHp @ v
        check(abs(qk - qp) < 0.10 * max(abs(qp), 1e-4 * scale), f"B1 Schur form {qk} vs {qp}")
    check(np.abs(dgk - dgp).max() < 1e-4 * scale, f"B1 dg err {np.abs(dgk - dgp).max()}")
    return err, int(itk[0]), int(itp[0]), ck, cp


def check_track_solve(prm, dev):
    """Kernel B1 against its plain version in both tracking modes (the
    frozen-dim skip differs), timed in the main path's mode."""
    from liwslam_torch.ops import track_solve as ts

    err = 0.0
    for fast in (True, False):
        inp_f, frozen_f = b1_problem(prm, dev, fast_mode=fast)
        e, it_k, it_p, ck, cp = _check_b1(inp_f, frozen_f, prm.solver_max_iterations)
        err = max(err, e)
        if fast == prm.fast_mode:
            inp, frozen, itk, itp, costs = inp_f, frozen_f, it_k, it_p, (ck, cp)
    kw = dict(max_iters=prm.solver_max_iterations, frozen_dims=frozen)
    call_ms = time_ms(lambda: ts.lm_solve_track_batched(inp, **kw))
    ms = kernel_ms(lambda: ts.lm_solve_track_batched(inp, **kw), "track_solve_kernel")
    plain_ms = time_ms(lambda: ts.lm_solve_track_plain(inp, max_iters=prm.solver_max_iterations), n=60, warm=3)
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
        f"B1 track_solve: M={M}, kernel {itk} / plain {itp} LM iterations, "
        f"max |x err| {err:.3e} (both modes), cost {costs[0]:.6g} vs {costs[1]:.6g}; "
        f"kernel {ms:.4f} ms on the device ({call_ms:.4f} ms a call), plain {plain_ms:.4f} ms a call",
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
    )


# --------------------------------------------------------- main path ----


def run_main_path(prm, streams, dev):
    """Frontend.run at bench size; returns (result, stats)."""
    from liwslam_torch.eval import metrics
    from liwslam_torch.frontend.driver import Frontend
    from liwslam_torch.ops import extract as ext
    from liwslam_torch.ops import track_solve as ts

    fe = Frontend(prm, device=dev)
    stamps = []

    def on_chunk(info):
        stamps.append((time.perf_counter(), info["n"]))

    ext.extract_lines.launches = 0
    ts.lm_solve_track_batched.launches = 0
    t0 = time.perf_counter()
    res = fe.run(streams, chunk_size=64, chunk_callback=on_chunk)
    wall = time.perf_counter() - t0
    launches = dict(
        extract_lines=ext.extract_lines.launches,
        track_solve=ts.lm_solve_track_batched.launches,
    )
    n_init = int(len(res.t_us) - sum(n for _, n in stamps))
    tracked = len(res.t_us) - n_init
    check(len(stamps) >= 2, "main path: need at least two chunks (one is warm-up)")
    fps = sum(n for _, n in stamps[1:]) / (stamps[-1][0] - stamps[0][0])
    check(np.all(np.isfinite(res.p)) and res.p.shape == (len(res.t_us), 3), "main path: bad poses")
    est = res.T_w_imu()[n_init:]
    pairs = metrics.associate_by_time(res.t_us[n_init:], streams.gt_t_us)
    check(len(pairs) == tracked, "main path: frames without ground truth")
    ate = metrics.ate_rmse(est[pairs[:, 0]], streams.gt_T_w_imu[pairs[:, 1]], align=True)
    check(launches["extract_lines"] >= n_init + tracked, f"B2 launches {launches} < {n_init} + {tracked}")
    check(launches["track_solve"] == tracked, f"B1 launches {launches} != {tracked} tracked frames")
    check(ate < 0.02, f"main path ATE {ate} m >= 0.02 m")
    print(
        f"main path: frames={len(res.t_us)} init_window={n_init} tracked={tracked} "
        f"tracked_fps={fps:.1f} (after a {stamps[0][1]}-frame warm-up chunk) "
        f"ATE={ate:.4f}m wall={wall:.1f}s launches={json.dumps(launches)}",
        flush=True,
    )
    return launches


def main():
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
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                ptxas.append(f"{name}: {line.strip()}")
    print(f"build: {time.time() - t0:.1f}s " + " | ".join(ptxas), flush=True)

    prm = bench_params()
    t0 = time.time()
    streams = bench_streams(prm)
    from liwslam_torch.frontend.driver import Frontend

    frames, _ = Frontend(prm, device=dev).pack_frames(streams)
    print(f"bench track: {len(frames)} laser frames, simulated in {time.time() - t0:.1f}s", flush=True)

    rows = [check_extract(prm, frames, dev), check_track_solve(prm, dev)]
    launches = run_main_path(prm, streams, dev)
    for r in rows:
        r["launches"] = launches[r["name"]]
        # the same numbers under the names PERF.md's kernel table uses
        r["kernel_ms"], r["max_err"] = r["ms"], r["max_abs_err"]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
