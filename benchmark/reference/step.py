"""The front-end odometry step, plain PyTorch: the benchmark's frozen
reference copy of the port's ``frontend/pipeline.tracking_step`` (reference
``trajectory::add_sensor_data(laser)`` and ``do_tracking``,
``src/trajectory/trajectory.cpp:137-277,525-560``).  One step: de-skew,
IMU + wheel preintegration, dead reckoning, line/corner extraction (the
plain ``extract``), submap matching, the two-frame LM solve with its Schur
reduction (the plain ``track_solve``), the square-root prior, the keyframe
decision and submap accumulation.

With laser-only input the tracking window is exactly two frames
[previous, current] (``pop_frame_for_tracking``, trajectory.cpp:590-623).

:func:`tracking_step` can follow a program's chain step by step
(``follow``): it computes the step from the state it is given and reports
its own answer, then carries on from the program's answer for that frame
(pose, velocity, biases, keyframe flag), so one step's rounding is never
amplified over the next ones.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference import geometry as geo
from benchmark.reference import matching as mm
from benchmark.reference import preintegration as pre
from benchmark.reference import scan as scan_mod
from benchmark.reference import track_solve
from benchmark.reference import factors as fac
from benchmark.reference import gn

W_TRACK = 2  # tracking window size (see module docstring)


class StaticCfg(NamedTuple):
    """Shapes and algorithm switches (Python values)."""

    max_lines: int
    max_corners: int
    ref_capacity: int
    acc_corner_capacity: int
    ref_n_accumulation: int
    fast_mode: bool
    solver_max_iterations: int
    solver_early_exit: bool
    # dims of the tracking state that are never free
    frozen_dims: tuple


class DynCfg(NamedTuple):
    """Runtime scalars (Python floats) and device constants."""

    line_continuous_threshold: float
    line_min_len: float
    line_max_dis: float
    tolerance_angle_rad: float
    resolution: float
    ref_motion_filter_p: float
    ref_motion_filter_q: float
    kf_p_threshold: float
    kf_q_threshold: float
    wheel_sigma: torch.Tensor  # (3,)
    imu_Q: torch.Tensor  # (12,12)
    track_free: torch.Tensor  # (30,) free mask of the tracking solve


def make_static_cfg(params) -> StaticCfg:
    _, frozen = track_solve.tracking_free_mask(params.fast_mode)
    return StaticCfg(
        max_lines=params.max_lines,
        max_corners=params.max_corners,
        ref_capacity=params.ref_capacity,
        acc_corner_capacity=4 * params.max_corners,
        ref_n_accumulation=params.ref_n_accumulation,
        fast_mode=params.fast_mode,
        solver_max_iterations=params.solver_max_iterations,
        solver_early_exit=params.solver_early_exit,
        frozen_dims=frozen,
    )


def make_dyn_cfg(params, device="cpu") -> DynCfg:
    free, _ = track_solve.tracking_free_mask(params.fast_mode)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
    return DynCfg(
        line_continuous_threshold=float(params.line_continuous_threshold),
        line_min_len=float(params.line_min_len),
        line_max_dis=float(params.line_max_dis),
        tolerance_angle_rad=float(params.line_max_tolerance_angle_rad),
        resolution=float(params.laser_resolution),
        ref_motion_filter_p=float(params.ref_motion_filter_p),
        ref_motion_filter_q=float(params.ref_motion_filter_q),
        kf_p_threshold=float(params.key_frame_p_motion_threshold),
        kf_q_threshold=float(params.key_frame_q_motion_threshold),
        wheel_sigma=f32(params.wheel_sigma),
        imu_Q=pre.imu_noise_Q(params, device),
        track_free=f32(free),
    )


class TrackState(NamedTuple):
    """Everything that persists frame to frame on the device."""

    win: fac.WindowState  # W_TRACK frames; slot -1 is "current"
    imu: pre.ImuCarry  # times relative to the previous frame stamp
    wheel: pre.WheelCarry
    pair: mm.SubmapPair  # double-buffered reference submap
    prior_J: torch.Tensor  # (15,15) marginalization prior (solver.cpp:390-441)
    prior_X: torch.Tensor  # (15,)
    prior_res: torch.Tensor  # (15,)
    prior_valid: torch.Tensor  # () bool
    last_keyframe_T: torch.Tensor  # (4,4) laser-frame pose of the last keyframe
    acc_corners: torch.Tensor  # (K,3) world-frame corners since the last keyframe
    acc_valid: torch.Tensor  # (K,)
    angular_local: torch.Tensor  # (3,) current_angular_local


class FrameInput(NamedTuple):
    """One frame's packed sensor slices; times are int32 microseconds
    relative to the previous frame's stamp."""

    dt_us: torch.Tensor  # () int32
    imu_acc: torch.Tensor  # (I,3)
    imu_gyro: torch.Tensor  # (I,3)
    imu_t_us: torch.Tensor  # (I,) int32
    imu_mask: torch.Tensor  # (I,) bool
    wheel_pose: torch.Tensor  # (Wh,4,4)
    wheel_t_us: torch.Tensor  # (Wh,) int32
    wheel_mask: torch.Tensor  # (Wh,) bool
    points: torch.Tensor  # (N,3) laser frame
    point_valid: torch.Tensor  # (N,) bool
    ray_t: torch.Tensor  # (N,) seconds relative to the frame stamp


class FrameOutput(NamedTuple):
    p: torch.Tensor  # (3,)
    q: torch.Tensor
    v: torch.Tensor
    bs: torch.Tensor  # (6,)
    is_keyframe: torch.Tensor  # () bool
    kf_corners: torch.Tensor  # (K,3) world-frame corners (valid on keyframe)
    kf_corner_valid: torch.Tensor  # (K,)
    n_match: torch.Tensor  # () int32
    n_lines: torch.Tensor  # () int32
    solve_cost: torch.Tensor  # ()
    scan_p1: torch.Tensor  # (L,3) extracted lines (laser frame) for the back end
    scan_p2: torch.Tensor
    scan_line_valid: torch.Tensor


def init_track_state(p0, q0, v0, bs0, scfg: StaticCfg) -> TrackState:
    dev, dtype = p0.device, p0.dtype
    rep = lambda a: a[None].expand(W_TRACK, a.shape[0]).clone()
    return TrackState(
        win=fac.WindowState(p=rep(p0), q=rep(q0), v=rep(v0), bs=rep(bs0)),
        imu=pre.imu_reset(0, bs0[:3], bs0[3:]),
        wheel=pre.wheel_reset(0, dev, dtype),
        pair=mm.empty_pair(scfg.ref_capacity, dev, dtype),
        prior_J=torch.zeros((15, 15), dtype=dtype, device=dev),
        prior_X=torch.zeros(15, dtype=dtype, device=dev),
        prior_res=torch.zeros(15, dtype=dtype, device=dev),
        prior_valid=torch.zeros((), dtype=torch.bool, device=dev),
        last_keyframe_T=geo.make_tf(p0, q0),
        acc_corners=torch.zeros((scfg.acc_corner_capacity, 3), dtype=dtype, device=dev),
        acc_valid=torch.zeros(scfg.acc_corner_capacity, dtype=torch.bool, device=dev),
        angular_local=torch.zeros(3, dtype=dtype, device=dev),
    )


def _build_factor_data(st: TrackState, imu_res, wheel_res, match, scfg) -> fac.FactorData:
    M = match.new_p1.shape[0]
    dev, dtype = st.prior_J.device, st.prior_J.dtype
    eye = lambda n: torch.eye(n, dtype=dtype, device=dev)
    second = torch.arange(W_TRACK, device=dev) == W_TRACK - 1  # [False, True]
    return fac.FactorData(
        imu_X=torch.stack([torch.zeros_like(imu_res.X), imu_res.X]),
        imu_J=torch.stack([eye(15), imu_res.J]),
        imu_sqrtP=torch.stack([eye(15), imu_res.sqrt_inverse_P]),
        imu_Dt=torch.stack([torch.zeros_like(imu_res.Dt), imu_res.Dt]),
        imu_valid=second,
        wheel_dT=torch.stack([eye(4), wheel_res.delta_T]),
        wheel_sqrt=torch.stack([eye(3), wheel_res.sqrt_inverse_P]),
        wheel_valid=second,
        laser_l1p1=match.ref_p1,
        laser_l1p2=match.ref_p2,
        laser_l2p1=match.new_p1,
        laser_l2p2=match.new_p2,
        laser_i_idx=torch.full((M,), -1, dtype=torch.int32, device=dev),
        laser_j_idx=torch.full((M,), W_TRACK - 1, dtype=torch.int32, device=dev),
        laser_ref_p=match.ref_pose_p[None].expand(M, 3),
        laser_ref_q=match.ref_pose_q[None].expand(M, 3),
        laser_valid=match.valid,
        ground_weight=torch.full((), math.sqrt(W_TRACK), dtype=dtype, device=dev),
        frame_valid=torch.ones(W_TRACK, dtype=torch.bool, device=dev),
        prior_J=st.prior_J,
        prior_X=st.prior_X,
        prior_res=st.prior_res,
        prior_idx=torch.zeros((), dtype=torch.int32, device=dev),
        prior_valid=st.prior_valid & (not scfg.fast_mode),
    )


def wrap_q(x, W):
    """Re-wrap every frame's so3 block of a flat window state."""
    st = fac.WindowState.from_flat(x, W)
    return st._replace(q=geo.normalize_so3(st.q)).flat()


def extract(points, valid, dcfg: DynCfg, scfg: StaticCfg) -> scan_mod.ScanFeatures:
    return scan_mod.extract_features(
        points,
        valid,
        continuous_threshold=dcfg.line_continuous_threshold,
        min_len=dcfg.line_min_len,
        max_dis=dcfg.line_max_dis,
        tolerance_angle_rad=dcfg.tolerance_angle_rad,
        resolution=dcfg.resolution,
        max_lines=scfg.max_lines,
        max_corners=scfg.max_corners,
    )


class Follow(NamedTuple):
    """A program's answer for one frame, which the reference carries on
    from: (3,) p, q, v; (6,) bs; () bool is_keyframe."""

    p: torch.Tensor
    q: torch.Tensor
    v: torch.Tensor
    bs: torch.Tensor
    is_keyframe: torch.Tensor


class StepDetail(NamedTuple):
    """What the reference step worked out besides its outputs: the solve's
    Schur-reduced information of the current frame (15,15), its LM
    iterations, and its own scan features."""

    info: torch.Tensor
    iters: torch.Tensor
    feats: scan_mod.ScanFeatures


def tracking_step(
    state: TrackState,
    inp: FrameInput,
    consts: fac.SolveConsts,
    dcfg: DynCfg,
    scfg: StaticCfg,
    follow: Follow = None,
):
    """One laser frame through the full front end.  Returns (new_state,
    FrameOutput, StepDetail).

    With ``follow`` the outputs are still this step's own answer, but the
    state it leaves carries the followed frame: its pose, velocity and
    biases take the window's current slot, the prior's linearization point
    and the IMU carry's biases, and the keyframe test, the corner
    accumulator and the submap addition are made at its pose; the output's
    keyframe flag is the test made at the followed pose, and the state
    takes the followed flag."""
    Til = consts.T_imu_to_laser
    Tiw = consts.T_imu_to_wheel
    cur_p, cur_q = state.win.p[-1], state.win.q[-1]
    cur_v, cur_bs = state.win.v[-1], state.win.bs[-1]

    # 1. de-skew with the current twist estimate (trajectory.cpp:140-147)
    T_w_l = geo.tf_compose(geo.make_tf(cur_p, cur_q), Til)
    R_il = Til[:3, :3]
    ang_laser = geo.log_SO3(geo.matmul(geo.matmul(R_il.T, geo.exp_so3(state.angular_local)), R_il))
    pts = scan_mod.deskew(inp.points, inp.ray_t, geo.matvec(T_w_l[:3, :3].T, cur_v), ang_laser)

    # 2. preintegrate up to the frame stamp (trajectory.cpp:176-184)
    imu_c = pre.imu_interval_parallel(
        state.imu, inp.imu_acc, inp.imu_gyro, inp.imu_t_us, inp.imu_mask, inp.dt_us, dcfg.imu_Q
    )
    imu_res = pre.imu_result(imu_c)
    wheel_c = pre.wheel_add_samples(state.wheel, inp.wheel_pose, inp.wheel_t_us, inp.wheel_mask)
    wheel_c = pre.wheel_update_only_t(wheel_c, inp.dt_us)
    wheel_res = pre.wheel_result(wheel_c, dcfg.wheel_sigma)
    # carries for the next interval, rebased to this frame
    imu_next = pre.imu_reset(0, cur_bs[:3], cur_bs[3:])._replace(
        last_acc=imu_c.last_acc,
        last_gyro=imu_c.last_gyro,
        last_t_us=imu_c.last_t_us - inp.dt_us,
        has_sample=imu_c.has_sample,
    )
    wheel_next = pre.wheel_rebase(pre.wheel_reset(wheel_c), inp.dt_us)
    ang = imu_res.X[6:9] / torch.clamp(imu_res.Dt, min=1e-6)

    # 3. dead reckoning via the wheel delta (trajectory.cpp:82-98,189-192)
    delta_imu = geo.tf_compose(geo.tf_compose(Tiw, wheel_res.delta_T), geo.tf_inv(Tiw))
    pred_p, pred_q = geo.log_SE3(geo.tf_compose(geo.make_tf(cur_p, cur_q), delta_imu))

    # 4. feature extraction
    feats = extract(pts, inp.point_valid, dcfg, scfg)

    # 5. match against the reference submap
    match = mm.match_lines(state.pair.ref, feats, pred_p, pred_q, Til, resolution=dcfg.resolution)

    # 6. slide the window and solve
    win = fac.WindowState(
        p=torch.stack([cur_p, pred_p]),
        q=torch.stack([cur_q, pred_q]),
        v=torch.stack([cur_v, cur_v]),
        bs=torch.stack([cur_bs, cur_bs]),
    )
    data = _build_factor_data(state, imu_res, wheel_res, match, scfg)
    x_opt, cost, dH, dg, iters = track_solve.lm_solve_track(
        win.flat(),
        dcfg.track_free,
        data,
        consts,
        max_iters=scfg.solver_max_iterations,
        early_exit=scfg.solver_early_exit,
        frozen_dims=scfg.frozen_dims,
    )
    win = fac.WindowState.from_flat(x_opt, W_TRACK)
    new_p, new_q, new_v, new_bs = win.p[-1], win.q[-1], win.v[-1], win.bs[-1]
    if follow is not None:
        x_opt = torch.cat([x_opt[:15], follow.p, follow.q, follow.v, follow.bs])
        win = fac.WindowState.from_flat(x_opt, W_TRACK)
    use_p, use_q, use_bs = win.p[-1], win.q[-1], win.bs[-1]
    if scfg.fast_mode:
        prior_J, prior_X, prior_res = state.prior_J, state.prior_X, state.prior_res
        prior_valid = torch.zeros_like(state.prior_valid)
    else:
        # 7. marginalization prior (solver.cpp:257-442)
        prior_J, prior_res = gn.sqrt_prior(dH, dg)
        prior_X = x_opt[15:]
        prior_valid = torch.ones_like(state.prior_valid)

    # 8. keyframe decision (trajectory.cpp:247-270)
    cur_laser_T = geo.tf_compose(geo.make_tf(use_p, use_q), Til)
    dkp, dkq = geo.log_SE3(geo.tf_compose(geo.tf_inv(state.last_keyframe_T), cur_laser_T))
    moved = (geo.safe_norm(dkp) >= dcfg.kf_p_threshold) | (
        geo.safe_norm(dkq) >= dcfg.kf_q_threshold
    )
    n_match = match.n
    n_lines = feats.n_lines
    is_kf = moved | (n_match < (n_lines - n_match))
    use_kf = follow.is_keyframe if follow is not None else is_kf

    # corner accumulation in the world laser frame (trajectory.cpp:239-243)
    cw = geo.tf_apply(cur_laser_T, feats.corners)
    K = state.acc_corners.shape[0]
    cv = feats.corner_valid
    base = torch.sum(state.acc_valid.to(torch.int64))
    slot = base + torch.cumsum(cv.to(torch.int64), 0) - 1
    slot = torch.clamp(torch.where(cv, slot, K), max=K)  # overflow -> trash
    placed = torch.zeros((K + 1, 4), dtype=cw.dtype, device=cw.device)
    placed = placed.index_put((slot,), torch.cat([cw, cv.to(cw.dtype)[:, None]], 1))[:K]
    touched = placed[:, 3] > 0.5
    acc_c = torch.where(touched[:, None], placed[:, :3], state.acc_corners)
    acc_v = state.acc_valid | touched

    out = FrameOutput(
        p=new_p,
        q=new_q,
        v=new_v,
        bs=new_bs,
        is_keyframe=is_kf,
        kf_corners=acc_c,
        kf_corner_valid=acc_v & is_kf,
        n_match=n_match,
        n_lines=n_lines,
        solve_cost=cost,
        scan_p1=feats.p1,
        scan_p2=feats.p2,
        scan_line_valid=feats.line_valid,
    )

    # reset the accumulator on a keyframe
    acc_c = torch.where(use_kf, 0.0, 1.0) * acc_c
    acc_v = acc_v & ~use_kf
    last_kf_T = torch.where(use_kf, cur_laser_T, state.last_keyframe_T)

    # 9. accumulate the scan into the reference submap
    pair = mm.add_scan(
        state.pair,
        feats,
        use_p,
        use_q,
        Til,
        ref_n_accumulation=scfg.ref_n_accumulation,
        motion_filter_p=dcfg.ref_motion_filter_p,
        motion_filter_q=dcfg.ref_motion_filter_q,
    )
    new_state = TrackState(
        win=win,
        # biases of the next interval come from the solve
        imu=imu_next._replace(X=torch.cat([imu_next.X[:9], use_bs])),
        wheel=wheel_next,
        pair=pair,
        prior_J=prior_J,
        prior_X=prior_X,
        prior_res=prior_res,
        prior_valid=prior_valid,
        last_keyframe_T=last_kf_T,
        acc_corners=acc_c,
        acc_valid=acc_v,
        angular_local=ang,
    )
    return new_state, out, StepDetail(info=dH, iters=iters, feats=feats)
