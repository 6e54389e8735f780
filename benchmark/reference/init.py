"""The init window, plain PyTorch: the benchmark's frozen reference copy of
the laser path of the port's ``frontend/driver.Frontend.initialize`` and
``_finish_init`` (``trajectory::check_and_processing_initialize``,
trajectory.cpp:381-487): the static-start gate, the 10-frame bootstrap
window with its >=2-matched-lines gate and full reset on failure, the init
solve (``gn.lm_solve``, QR), the submap rebuild from the optimized poses
and the marginalization that seeds the prior.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import factors as fac
from benchmark.reference import geometry as geo
from benchmark.reference import gn
from benchmark.reference import matching as mm
from benchmark.reference import preintegration as pre
from benchmark.reference import step as pl


class InitResult:
    """The window's outcome: the tracking state it seeds, the index of the
    first tracked frame, and the window's optimized states."""

    def __init__(self, track, first, window):
        self.track, self.first, self.window = track, first, window


def _preint(imu_c, wheel_c, inp, dcfg, ba, bw):
    imu_c = pre.imu_interval_parallel(
        imu_c, inp.imu_acc, inp.imu_gyro, inp.imu_t_us, inp.imu_mask, inp.dt_us, dcfg.imu_Q
    )
    imu_res = pre.imu_result(imu_c)
    wheel_c = pre.wheel_add_samples(wheel_c, inp.wheel_pose, inp.wheel_t_us, inp.wheel_mask)
    wheel_c = pre.wheel_update_only_t(wheel_c, inp.dt_us)
    wheel_res = pre.wheel_result(wheel_c, dcfg.wheel_sigma)
    keep = (pre.imu_rebase(imu_c, inp.dt_us), pre.wheel_rebase(wheel_c, inp.dt_us))
    imu_next = pre.imu_reset(0, ba, bw)._replace(
        last_acc=imu_c.last_acc,
        last_gyro=imu_c.last_gyro,
        last_t_us=imu_c.last_t_us - inp.dt_us,
        has_sample=imu_c.has_sample,
    )
    nxt = (imu_next, pre.wheel_rebase(pre.wheel_reset(wheel_c), inp.dt_us))
    return keep, nxt, imu_res, wheel_res


def initialize(frames, prm, consts, dcfg, scfg, device="cpu"):
    """The INITIALIZING state machine over packed frames (a list of
    ``step.FrameInput`` of numpy arrays).  Returns an :class:`InitResult`."""
    dev = torch.device(device)
    W = prm.slide_window_size
    z3 = torch.zeros(3, dtype=torch.float32, device=dev)
    Tiw64 = prm.mat_T_imu_to_wheel()
    p0, q0 = geo.log_SE3(geo.tf_inv(consts.T_imu_to_wheel))
    to_dev = lambda f: pl.FrameInput(*[torch.as_tensor(np.asarray(a)).to(dev) for a in f])

    def dead_reckon(cur_p, cur_q, wheel_res):
        delta_imu = Tiw64 @ wheel_res.delta_T.cpu().double().numpy() @ np.linalg.inv(Tiw64)
        T_new = geo.make_tf(cur_p, cur_q).cpu().double().numpy() @ delta_imu
        return geo.log_SE3(torch.as_tensor(T_new, dtype=torch.float32).to(dev))

    k = 0
    n_frames = len(frames)
    while True:
        imu_c = pre.imu_reset(0, z3, z3)
        wheel_c = pre.wheel_reset(0, dev)
        cur_p, cur_q = p0, q0
        window = []
        front_sub = None
        started = False
        imu_seen = wheel_seen = 0
        while k < n_frames:
            base_np = frames[k]
            inp = to_dev(base_np)
            imu_seen += int(np.sum(base_np.imu_mask))
            wheel_seen += int(np.sum(base_np.wheel_mask))
            keep, nxt, imu_res, wheel_res = _preint(imu_c, wheel_c, inp, dcfg, z3, z3)
            accepted = True
            if imu_seen < 2 or wheel_seen < 2:
                accepted = False
            elif not started:
                # static-start gate (trajectory.cpp:163-165): wheel delta
                # conjugated into the laser frame
                dT = wheel_res.delta_T.cpu().double().numpy()
                Tlw = np.linalg.inv(prm.mat_T_imu_to_laser()) @ Tiw64
                dl = Tlw @ dT @ np.linalg.inv(Tlw)
                dp_, dq_ = geo.log_SE3(torch.as_tensor(dl, dtype=torch.float32))
                if (
                    float(torch.linalg.norm(dp_)) < prm.p_motion_threshold
                    and float(torch.linalg.norm(dq_)) < prm.q_motion_threshold
                ):
                    accepted = False
                else:
                    started = True
            if not accepted:
                imu_c, wheel_c = keep
                k += 1
                continue
            imu_c, wheel_c = nxt
            cur_p, cur_q = dead_reckon(cur_p, cur_q, wheel_res)
            feats = pl.extract(inp.points, inp.point_valid, dcfg, scfg)
            if front_sub is None:
                front_sub = mm.submap_from_scan(feats, cur_p, cur_q, prm.ref_capacity)
                match = None
            else:
                match = mm.match_lines(
                    front_sub, feats, cur_p, cur_q, consts.T_imu_to_laser, resolution=dcfg.resolution
                )
                if int(match.n) < 2:
                    # reset everything (trajectory.cpp:412-418)
                    k += 1
                    break
            window.append(dict(p=cur_p, q=cur_q, imu=imu_res, wheel=wheel_res, feats=feats, match=match))
            k += 1
            if len(window) >= W:
                track, st_opt = _finish_init(window, prm, consts, dcfg, scfg, dev)
                return InitResult(track, k, st_opt)
        else:
            raise RuntimeError(f"stream ended during initialization (frame {k}/{n_frames})")


def _finish_init(window, prm, consts, dcfg, scfg, dev):
    """init_solve + submap rebuild + marginalization -> (TrackState, window
    state)."""
    W = len(window)
    M = prm.max_lines
    f32 = dict(dtype=torch.float32, device=dev)
    st = fac.WindowState(
        p=torch.stack([f["p"] for f in window]),
        q=torch.stack([f["q"] for f in window]),
        v=torch.zeros((W, 3), **f32),
        bs=torch.zeros((W, 6), **f32),
    )
    eye = lambda n: torch.eye(n, **f32)
    Ms = M * W
    las = {k: np.zeros((Ms, 3), np.float32) for k in ("l1p1", "l1p2", "l2p1", "l2p2")}
    j_idx = np.zeros(Ms, np.int32)
    lvalid = np.zeros(Ms, bool)
    for i, f in enumerate(window):
        if f["match"] is None:
            continue
        sl = slice(i * M, (i + 1) * M)
        mt = f["match"]
        for key, t in (("l1p1", mt.ref_p1), ("l1p2", mt.ref_p2), ("l2p1", mt.new_p1), ("l2p2", mt.new_p2)):
            las[key][sl] = t.cpu().numpy()
        j_idx[sl] = i
        lvalid[sl] = mt.valid.cpu().numpy()
    first = lambda i, a, b: a if i > 0 else b
    valid_w = torch.as_tensor([i > 0 for i in range(W)], device=dev)
    data = fac.FactorData(
        imu_X=torch.stack([first(i, f["imu"].X, torch.zeros(15, **f32)) for i, f in enumerate(window)]),
        imu_J=torch.stack([first(i, f["imu"].J, eye(15)) for i, f in enumerate(window)]),
        imu_sqrtP=torch.stack([first(i, f["imu"].sqrt_inverse_P, eye(15)) for i, f in enumerate(window)]),
        imu_Dt=torch.stack([first(i, f["imu"].Dt, torch.zeros((), **f32)) for i, f in enumerate(window)]),
        imu_valid=valid_w,
        wheel_dT=torch.stack([first(i, f["wheel"].delta_T, eye(4)) for i, f in enumerate(window)]),
        wheel_sqrt=torch.stack([first(i, f["wheel"].sqrt_inverse_P, eye(3)) for i, f in enumerate(window)]),
        wheel_valid=valid_w,
        laser_l1p1=torch.as_tensor(las["l1p1"], device=dev),
        laser_l1p2=torch.as_tensor(las["l1p2"], device=dev),
        laser_l2p1=torch.as_tensor(las["l2p1"], device=dev),
        laser_l2p2=torch.as_tensor(las["l2p2"], device=dev),
        laser_i_idx=torch.zeros(Ms, dtype=torch.int32, device=dev),  # vs frame 0
        laser_j_idx=torch.as_tensor(j_idx, device=dev),
        laser_ref_p=torch.zeros((Ms, 3), **f32),
        laser_ref_q=torch.zeros((Ms, 3), **f32),
        laser_valid=torch.as_tensor(lvalid, device=dev),
        ground_weight=torch.full((), float(np.sqrt(W)), **f32),
        frame_valid=torch.ones(W, dtype=torch.bool, device=dev),
        prior_J=torch.zeros((15, 15), **f32),
        prior_X=torch.zeros(15, **f32),
        prior_res=torch.zeros(15, **f32),
        prior_idx=torch.zeros((), dtype=torch.int32, device=dev),
        prior_valid=torch.zeros((), dtype=torch.bool, device=dev),
    )
    res_fn = lambda x: fac.stack_residuals(fac.WindowState.from_flat(x[: W * 15], W), data, consts)
    x_opt, _, _ = gn.lm_solve(
        res_fn, st.flat(), torch.ones(W * 15, **f32), gn.LMConfig(max_iters=prm.init_solver_max_iterations),
        wrap_fn=lambda x: pl.wrap_q(x, W),
    )
    st_opt = fac.WindowState.from_flat(x_opt, W)

    # rebuild the submaps from the optimized poses (trajectory.cpp:466-478)
    pair = mm.empty_pair(prm.ref_capacity, dev)
    for i, f in enumerate(window):
        pair = mm.add_scan(
            pair, f["feats"], st_opt.p[i], st_opt.q[i], consts.T_imu_to_laser,
            ref_n_accumulation=prm.ref_n_accumulation,
            motion_filter_p=dcfg.ref_motion_filter_p,
            motion_filter_q=dcfg.ref_motion_filter_q,
        )

    # marginalization seeds the prior (trajectory.cpp:479); the laser
    # reference side becomes the frozen optimized frame-0 pose
    data_m = data._replace(
        laser_i_idx=torch.full((Ms,), -1, dtype=torch.int32, device=dev),
        laser_ref_p=st_opt.p[0][None].expand(Ms, 3),
        laser_ref_q=st_opt.q[0][None].expand(Ms, 3),
    )
    res_fn_m = lambda x: fac.stack_residuals(fac.WindowState.from_flat(x, W), data_m, consts)
    lin_J, lin_res, lin_X = gn.marginalize(res_fn_m, x_opt, keep=15)

    track = pl.init_track_state(st_opt.p[-1], st_opt.q[-1], st_opt.v[-1], st_opt.bs[-1], scfg)
    track = track._replace(
        pair=pair,
        prior_J=lin_J,
        prior_X=lin_X,
        prior_res=lin_res,
        prior_valid=torch.full((), not prm.fast_mode, dtype=torch.bool, device=dev),
        last_keyframe_T=geo.make_tf(st_opt.p[-1], st_opt.q[-1]) @ consts.T_imu_to_laser,
    )
    return track, st_opt
