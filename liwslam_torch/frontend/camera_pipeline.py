"""The camera-enabled front end: one laser frame with its camera sub-step.

Port of ``liwslam/frontend/camera_pipeline.py`` (reference
``trajectory::add_sensor_data(camera)``, ``trajectory.cpp:279-380``, the
camera rows of the tracking solve, ``solver.cpp:641-666``, and the
landmark bookkeeping of ``feature_manger``, ``camera_manager.cpp:100-311``).

The first camera message after a laser frame is a window frame of its own:

    [prev frame] --imu/wheel A--> [camera frame] --imu/wheel B--> [laser]
                     camera solve                    laser solve

The camera sub-step splits the interval's preintegration at the camera
stamp, LK-tracks and replenishes the features (kernel B3), records the
observations, triangulates mature landmarks, solves the window [prev
frozen, camera free] jointly with the free landmarks (kernel B4),
marginalizes the previous frame into the prior and filters outliers; the
unchanged laser step (``pipeline.tracking_step``) then runs the rest of
the interval.  The interval's later camera messages are only LK-tracked
(no replenish, no observation), which keeps LK baselines at one camera
period.

The step keeps a frame on the card: whether an interval has a camera frame
and which later messages exist are host values from packing
(``FrameInputCam.cam_valid`` / ``cam_extra_mask``), so the step branches
on them without reading the device; slots are placed by scatters into
buffers of F+2 rows (the last two take the dropped writes), never by
boolean-mask indexing.

The landmark table (``camera.features.FeatureWindow``) is slot-aligned
with the tracker: slot f of the track table is landmark slot f.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from liwslam_torch.camera import features as ft
from liwslam_torch.camera import tracker as trk
from liwslam_torch.core import geometry as geo
from liwslam_torch.frontend import pipeline as pl
from liwslam_torch.frontend import preintegration as pre
from liwslam_torch.ops import cam_solve
from liwslam_torch.ops import lk
from liwslam_torch.solve import factors as fac
from liwslam_torch.solve import gn


class CamStaticCfg(NamedTuple):
    """Shapes and counts of the camera path (Python values)."""

    n_features: int  # landmark / track slot capacity F
    obs_window: int  # Wc observation ring length
    max_new_per_frame: int  # replenishment cap per frame
    min_obs: int  # observations required before triangulation
    lk_radius: int
    lk_levels: int
    lk_iters: int
    solver_max_iterations: int
    fast_mode: bool
    cell_px: int = 10  # NMS cell size (>= feature_min_dis)


class CamDynCfg(NamedTuple):
    """Runtime camera constants (device tensors)."""

    K: torch.Tensor  # (3,3)
    K_inv: torch.Tensor  # (3,3)
    T_imu_to_camera: torch.Tensor  # (4,4)
    sqrt_info: torch.Tensor  # (2,) camera whitening (fx/sigma)
    feature_min_dis: torch.Tensor  # () px
    max_feature_num: torch.Tensor  # () int32 replenish-to target
    min_parallax: torch.Tensor  # () normalized-plane parallax gate
    max_reproj_err: torch.Tensor  # () normalized (max_camera_reproject_error/fx)
    max_feature_dis: torch.Tensor  # () max landmark depth [m]
    lk_max_err: torch.Tensor  # () LK verification gate (fraction of range)


def make_cam_static_cfg(params) -> CamStaticCfg:
    return CamStaticCfg(
        n_features=params.cam_feature_capacity,
        obs_window=params.cam_obs_window,
        max_new_per_frame=params.cam_feature_capacity,
        min_obs=params.cam_min_obs,
        lk_radius=params.cam_lk_radius,
        lk_levels=params.cam_lk_levels,
        lk_iters=params.cam_lk_iters,
        solver_max_iterations=params.solver_max_iterations,
        fast_mode=params.fast_mode,
        cell_px=max(1, int(-(-float(params.feature_min_dis) // 1))),
    )


def make_cam_dyn_cfg(params, device="cpu") -> CamDynCfg:
    K = np.asarray(params.mat_camera_K(), np.float64)
    fx = K[0, 0]
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)
    return CamDynCfg(
        K=f32(K),
        K_inv=f32(np.linalg.inv(K)),
        T_imu_to_camera=f32(params.mat_T_imu_to_camera()),
        sqrt_info=fac.camera_sqrt_info(params, device=device),
        feature_min_dis=f32(params.feature_min_dis),
        max_feature_num=torch.as_tensor(np.int32(params.max_feature_num), device=device),
        min_parallax=f32(params.cam_min_parallax),
        # params.cpp:176-190 normalizes the pixel threshold by fx
        max_reproj_err=f32(params.max_camera_reproject_error / fx),
        max_feature_dis=f32(params.max_camera_feature_dis),
        lk_max_err=f32(params.cam_lk_max_err),
    )


class CamTrackState(NamedTuple):
    """Per-stream camera state: the slot-aligned track table and landmark
    window; ``ring_*`` hold the (frozen) IMU-frame poses of the ``Wc`` most
    recent accepted camera frames."""

    fw: ft.FeatureWindow
    px: torch.Tensor  # (F,2) current pixel positions (in prev_img)
    live: torch.Tensor  # (F,) bool: LK chain alive
    ring_p: torch.Tensor  # (Wc,3)
    ring_q: torch.Tensor  # (Wc,3)
    ring_valid: torch.Tensor  # (Wc,) bool
    prev_img: torch.Tensor  # (H,W)
    prev_valid: torch.Tensor  # () bool


def init_cam_state(img_h, img_w, ccfg: CamStaticCfg, device="cpu", dtype=torch.float32) -> CamTrackState:
    F, Wc = ccfg.n_features, ccfg.obs_window
    return CamTrackState(
        fw=ft.empty_window(F, Wc, device, dtype),
        px=torch.zeros((F, 2), dtype=dtype, device=device),
        live=torch.zeros(F, dtype=torch.bool, device=device),
        ring_p=torch.zeros((Wc, 3), dtype=dtype, device=device),
        ring_q=torch.zeros((Wc, 3), dtype=dtype, device=device),
        ring_valid=torch.zeros(Wc, dtype=torch.bool, device=device),
        prev_img=torch.zeros((img_h, img_w), dtype=dtype, device=device),
        prev_valid=torch.zeros((), dtype=torch.bool, device=device),
    )


def px_to_norm(px, K_inv):
    """Pixel -> normalized camera plane."""
    h = torch.cat([px, torch.ones_like(px[..., :1])], -1) @ K_inv.T
    return h[..., :2]


def _put(buf_len, dest, values, fill):
    """``fill`` (buf_len,...) with ``values`` scattered to rows ``dest``;
    rows >= buf_len - 2 take the writes to drop and are cut off (``dest``
    there may repeat)."""
    out = torch.full((buf_len + 2,) + values.shape[1:], fill, dtype=values.dtype, device=values.device)
    return out.index_put((dest,), values)[:buf_len]


def observe(cam: CamTrackState, img, ccfg: CamStaticCfg, cdyn: CamDynCfg, replenish: bool = True):
    """LK-track the live features into ``img`` (kernel B3 on the card) and
    replenish new ones in dead slots (camera_manager.cpp:55-113).  A reused
    slot starts a new landmark: its id and observation history are reset.
    ``replenish=False`` runs the LK half only (the interval's non-accepted
    camera messages)."""
    fw = cam.fw
    new_px, ok = lk.lk_track(
        cam.prev_img, img, cam.px, cam.live & cam.prev_valid,
        radius=ccfg.lk_radius, iters=ccfg.lk_iters, levels=ccfg.lk_levels, max_err=cdyn.lk_max_err,
    )
    px = torch.where(ok[:, None], new_px, cam.px)
    live = ok
    seen = torch.ones_like(cam.prev_valid)
    if not replenish:
        return cam._replace(px=px, live=live, prev_img=img, prev_valid=seen)

    # replenish up to max_feature_num live tracks (goodFeaturesToTrack with
    # min-distance masking, camera_manager.cpp:93-113)
    n_live = torch.sum(live.to(torch.int32))
    budget = torch.clamp(cdyn.max_feature_num - n_live, min=0)
    fresh_px, fresh_ok = trk.select_features(
        img, ccfg.max_new_per_frame, cdyn.feature_min_dis,
        existing_xy=px, existing_valid=live, budget=budget, cell_px=ccfg.cell_px,
    )
    # fresh tracks go to the dead slots in order; F+1 marks a dropped write
    F = px.shape[0]
    free = ~live
    drop = torch.full_like(fw.ids, F + 1, dtype=torch.int64)
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    slot_by_rank = _put(F, torch.where(free, free_rank, drop), torch.arange(F, device=px.device), F + 1)
    fresh_rank = torch.cumsum(fresh_ok.to(torch.int64), 0) - 1
    take = fresh_ok & (fresh_rank < torch.sum(free.to(torch.int64)))
    dest = torch.where(take, slot_by_rank.gather(0, torch.clamp(fresh_rank, 0, F - 1)), drop[: fresh_ok.shape[0]])
    placed = _put(F, dest, fresh_ok, False)
    px = torch.where(placed[:, None], _put(F, dest, fresh_px, 0.0), px)
    live = live | placed
    new_ids = fw.next_id + fresh_rank.to(torch.int32)
    ids = torch.where(placed, _put(F, dest, new_ids, -1), fw.ids)
    fw = fw._replace(
        ids=ids,
        obs_mask=fw.obs_mask & ~placed[:, None],
        ready=fw.ready & ~placed,
        next_id=fw.next_id + torch.sum(fresh_ok.to(torch.int32)),
    )
    return cam._replace(fw=fw, px=px, live=live, prev_img=img, prev_valid=seen)


def record(cam: CamTrackState, p, q, cdyn: CamDynCfg) -> CamTrackState:
    """Record the current tracks as observations of an accepted camera
    frame at IMU-frame pose (p, q) (feature_manger::add_match)."""
    fw = cam.fw
    xy = px_to_norm(cam.px, cdyn.K_inv)
    obs = torch.cat([fw.obs[:, 1:], xy[:, None]], 1)
    mask = torch.cat([fw.obs_mask[:, 1:], (cam.live & (fw.ids >= 0))[:, None]], 1)
    return cam._replace(
        fw=fw._replace(obs=obs, obs_mask=mask),
        ring_p=torch.cat([cam.ring_p[1:], p[None]], 0),
        ring_q=torch.cat([cam.ring_q[1:], q[None]], 0),
        ring_valid=torch.cat([cam.ring_valid[1:], torch.ones_like(cam.ring_valid[:1])], 0),
    )


def filter_outliers(cam: CamTrackState, cur_p, cur_q, cdyn: CamDynCfg) -> CamTrackState:
    """filter_outlier_world_point (trajectory.cpp:689-730): drop ready
    landmarks by reprojection error / depth against the newest frame, then
    every feature without an observation in the newest frame."""
    fw = cam.fw
    T_c_w = geo.tf_inv(geo.make_tf(cur_p, cur_q) @ cdyn.T_imu_to_camera)
    cm = geo.tf_apply(T_c_w, fw.world)
    z = cm[:, 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    err = torch.linalg.norm(cm[:, :2] / zs[:, None] - fw.obs[:, -1], dim=-1)
    has_latest = fw.obs_mask[:, -1]
    bad = fw.ready & has_latest & ((err > cdyn.max_reproj_err) | (z > cdyn.max_feature_dis) | (z < 0.1))
    drop = bad | ~has_latest
    fw = fw._replace(
        ids=torch.where(drop, torch.full_like(fw.ids, -1), fw.ids),
        ready=fw.ready & ~drop,
        obs_mask=fw.obs_mask & ~drop[:, None],
    )
    return cam._replace(fw=fw, live=cam.live & ~drop)


def _cam_factor_data(st: pl.TrackState, imu_res, wheel_res, scfg) -> fac.FactorData:
    """W=2 FactorData for the [prev, camera] interval: no laser rows."""
    dev, dtype = st.prior_J.device, st.prior_J.dtype
    eye = lambda n: torch.eye(n, dtype=dtype, device=dev)
    z3 = torch.zeros((1, 3), dtype=dtype, device=dev)
    second = torch.arange(2, device=dev) == 1
    return fac.FactorData(
        imu_X=torch.stack([torch.zeros_like(imu_res.X), imu_res.X]),
        imu_J=torch.stack([eye(15), imu_res.J]),
        imu_sqrtP=torch.stack([eye(15), imu_res.sqrt_inverse_P]),
        imu_Dt=torch.stack([torch.zeros_like(imu_res.Dt), imu_res.Dt]),
        imu_valid=second,
        wheel_dT=torch.stack([eye(4), wheel_res.delta_T]),
        wheel_sqrt=torch.stack([eye(3), wheel_res.sqrt_inverse_P]),
        wheel_valid=second,
        laser_l1p1=z3,
        laser_l1p2=z3,
        laser_l2p1=z3,
        laser_l2p2=z3,
        laser_i_idx=torch.full((1,), -1, dtype=torch.int32, device=dev),
        laser_j_idx=torch.ones(1, dtype=torch.int32, device=dev),
        laser_ref_p=z3,
        laser_ref_q=z3,
        laser_valid=torch.zeros(1, dtype=torch.bool, device=dev),
        ground_weight=torch.full((), 2.0**0.5, dtype=dtype, device=dev),
        frame_valid=torch.ones(2, dtype=torch.bool, device=dev),
        prior_J=st.prior_J,
        prior_X=st.prior_X,
        prior_res=st.prior_res,
        prior_idx=torch.zeros((), dtype=torch.int32, device=dev),
        prior_valid=st.prior_valid & (not scfg.fast_mode),
    )


class CamFrameOutput(NamedTuple):
    p: torch.Tensor  # (3,) camera-frame-time IMU pose
    q: torch.Tensor
    valid: bool  # host: the interval had a camera frame
    n_tracked: torch.Tensor  # () int32
    n_ready: torch.Tensor  # () int32
    solve_cost: torch.Tensor  # ()


def camera_sub_step(state: pl.TrackState, cam: CamTrackState, inp: pl.FrameInput, cam_img,
                    cam_t_us, consts, dcfg: pl.DynCfg, scfg: pl.StaticCfg, ccfg: CamStaticCfg,
                    cdyn: CamDynCfg):
    """Process the interval's accepted camera frame.  Returns (state, cam)
    positioned at the camera stamp, the FrameInput remainder for the laser
    part of the interval, and the CamFrameOutput."""
    cur_p, cur_q = state.win.p[-1], state.win.q[-1]
    cur_v, cur_bs = state.win.v[-1], state.win.bs[-1]

    # preintegrate [prev, camera]
    m1_imu = inp.imu_mask & (inp.imu_t_us <= cam_t_us)
    imu_c = pre.imu_interval_parallel(
        state.imu, inp.imu_acc, inp.imu_gyro, inp.imu_t_us, m1_imu, cam_t_us, dcfg.imu_Q
    )
    imu_res = pre.imu_result(imu_c)
    m1_wh = inp.wheel_mask & (inp.wheel_t_us <= cam_t_us)
    wheel_c = pre.wheel_add_samples(state.wheel, inp.wheel_pose, inp.wheel_t_us, m1_wh)
    wheel_c = pre.wheel_update_only_t(wheel_c, cam_t_us)
    wheel_res = pre.wheel_result(wheel_c, dcfg.wheel_sigma)
    ang = imu_res.X[6:9] / torch.clamp(imu_res.Dt, min=1e-6)

    # dead reckoning to the camera stamp (update_current_status)
    Tiw = consts.T_imu_to_wheel
    delta_imu = Tiw @ wheel_res.delta_T @ geo.tf_inv(Tiw)
    pred_p, pred_q = geo.log_SE3(geo.make_tf(cur_p, cur_q) @ delta_imu)

    # feature tracking + observation recording + triangulation
    cam = observe(cam, cam_img, ccfg, cdyn)
    cam = record(cam, pred_p, pred_q, cdyn)
    cam = cam._replace(
        fw=ft.triangulate_ready(
            cam.fw, cam.ring_p, cam.ring_q, cdyn.T_imu_to_camera,
            min_obs=ccfg.min_obs, min_parallax=cdyn.min_parallax,
        )
    )

    # joint [prev frozen, camera free] + landmarks solve (kernel B4 on the card)
    win = fac.WindowState(
        p=torch.stack([cur_p, pred_p]),
        q=torch.stack([cur_q, pred_q]),
        v=torch.stack([cur_v, cur_v]),
        bs=torch.stack([cur_bs, cur_bs]),
    )
    data = _cam_factor_data(state, imu_res, wheel_res, scfg)
    fw = cam.fw
    n_obs = torch.sum(fw.obs_mask.to(torch.int32), 1)
    lm_free = fw.ready & (n_obs >= 2)
    use = fw.obs_mask & fw.ready[:, None] & cam.ring_valid[None, :]
    x30_opt, world_opt, cost, dH, dg = cam_solve.lm_solve_cam(
        win.flat(), dcfg.track_free, fw.world, lm_free, fw.obs, use, cam.ring_p, cam.ring_q,
        data, consts, cdyn.T_imu_to_camera, cdyn.sqrt_info,
        max_iters=ccfg.solver_max_iterations, frozen_dims=scfg.frozen_dims,
    )
    win = fac.WindowState.from_flat(x30_opt, 2)
    cam = cam._replace(fw=fw._replace(world=world_opt))

    # prior: marginalize the previous frame (keep the camera frame)
    if scfg.fast_mode:
        prior_J, prior_X, prior_res = state.prior_J, state.prior_X, state.prior_res
        prior_valid = torch.zeros_like(state.prior_valid)
    else:
        prior_J, prior_res = gn.sqrt_prior(dH, dg)
        prior_X = x30_opt[15:]
        prior_valid = torch.ones_like(state.prior_valid)

    new_p, new_q = win.p[-1], win.q[-1]
    cam = filter_outliers(cam, new_p, new_q, cdyn)
    # the newest ring slot takes the solved camera pose
    cam = cam._replace(
        ring_p=torch.cat([cam.ring_p[:-1], new_p[None]], 0),
        ring_q=torch.cat([cam.ring_q[:-1], new_q[None]], 0),
    )

    # continuation carries for the laser remainder
    new_bs = win.bs[-1]
    imu_next = pre.imu_reset(0, new_bs[:3], new_bs[3:])._replace(
        last_acc=imu_c.last_acc,
        last_gyro=imu_c.last_gyro,
        last_t_us=imu_c.last_t_us - cam_t_us,
        has_sample=imu_c.has_sample,
    )
    state2 = state._replace(
        win=win,
        imu=imu_next,
        wheel=pre.wheel_rebase(pre.wheel_reset(wheel_c), cam_t_us),
        prior_J=prior_J,
        prior_X=prior_X,
        prior_res=prior_res,
        prior_valid=prior_valid,
        angular_local=ang,
    )
    inp_rest = inp._replace(
        dt_us=inp.dt_us - cam_t_us,
        imu_t_us=inp.imu_t_us - cam_t_us,
        imu_mask=inp.imu_mask & (inp.imu_t_us > cam_t_us),
        wheel_t_us=inp.wheel_t_us - cam_t_us,
        wheel_mask=inp.wheel_mask & (inp.wheel_t_us > cam_t_us),
    )
    out = CamFrameOutput(
        p=new_p,
        q=new_q,
        valid=True,
        n_tracked=torch.sum(cam.fw.obs_mask[:, -1].to(torch.int32)),
        n_ready=torch.sum(cam.fw.ready.to(torch.int32)),
        solve_cost=cost,
    )
    return state2, cam, inp_rest, out


class FrameInputCam(NamedTuple):
    """FrameInput plus the interval's camera messages, on the device, with
    the branch flags on the host.

    ``cam_img`` is the accepted frame (the first message after the
    previous laser frame; it becomes a window frame, trajectory.cpp:301);
    ``cam_extra_imgs`` are the interval's later messages, LK-tracked only
    (trajectory.cpp:279-310).  The images are views of one staged chunk
    (``driver.Frontend.stage``), not copies."""

    base: pl.FrameInput
    cam_img: torch.Tensor  # (H,W) f32 (ignored unless cam_valid)
    cam_t_us: torch.Tensor  # () int32 relative to the previous frame stamp
    cam_valid: bool
    cam_extra_imgs: tuple  # of (H,W) f32, one per True in cam_extra_mask
    cam_extra_mask: np.ndarray  # (NE,) bool


def tracking_step_cam(state: pl.TrackState, cam: CamTrackState, inp: FrameInputCam, consts,
                      dcfg: pl.DynCfg, scfg: pl.StaticCfg, ccfg: CamStaticCfg, cdyn: CamDynCfg):
    """One laser frame with the optional camera sub-step.  Returns
    ((state, cam), (FrameOutput, CamFrameOutput))."""
    base = inp.base
    if inp.cam_valid:
        state, cam, base, cam_out = camera_sub_step(
            state, cam, base, inp.cam_img, inp.cam_t_us, consts, dcfg, scfg, ccfg, cdyn
        )
    else:
        zero = torch.zeros(3, dtype=state.win.p.dtype, device=state.win.p.device)
        cam_out = CamFrameOutput(
            p=zero,
            q=zero,
            valid=False,
            n_tracked=torch.zeros((), dtype=torch.int32, device=zero.device),
            n_ready=torch.sum(cam.fw.ready.to(torch.int32)),
            solve_cost=zero[0],
        )
    # full-camera-rate LK: the interval's later messages keep the track
    # chain at one-camera-period baselines; no observations are recorded
    for img in inp.cam_extra_imgs:
        cam = observe(cam, img, ccfg, cdyn, replenish=False)
    state, out = pl.tracking_step(state, base, consts, dcfg, scfg)
    return (state, cam), (out, cam_out)


def run_chunk_cam(state, cam, inputs, consts, dcfg, scfg, ccfg, cdyn):
    """The camera-enabled step over a list of FrameInputCam.  Returns
    ((state, cam), (FrameOutput, CamFrameOutput) with a leading frame dim;
    the CamFrameOutput's ``valid`` is a numpy bool array)."""
    outs, cam_outs = [], []
    for inp in inputs:
        (state, cam), (out, cam_out) = tracking_step_cam(state, cam, inp, consts, dcfg, scfg, ccfg, cdyn)
        outs.append(out)
        cam_outs.append(cam_out)
    out = pl.FrameOutput(*[torch.stack(f) for f in zip(*outs)])
    cam_out = CamFrameOutput(
        *[np.asarray(f) if i == 2 else torch.stack(f) for i, f in enumerate(zip(*cam_outs))]
    )
    return (state, cam), (out, cam_out)
