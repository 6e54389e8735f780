"""Per-landmark feature window bookkeeping (the reference's feature_manger).

Port of ``liwslam/camera/features.py``: the fixed-capacity landmark
table (``FeatureWindow``), the parallax gate and multi-view triangulation
of the landmarks that are ready (``camera_manager.cpp:140-190``), which
the camera path runs, and the window bookkeeping the camera path does in
its own fused form (``push_frame``, ``shift``, ``pop_oldest``: the
reference's ``feature_manger``, ``camera_manager.cpp:140-178``), the
reprojection-error outlier filter (``trajectory.cpp:689-730``), the
residual rows and the joint pose and landmark refinement of a window
(``solver.cpp:50-169``).  Landmarks are slots and observations a dense
(F, W, 2) array with a mask, so every operation is a batched tensor
program with no host round trip.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from liwslam_torch.camera.triangulation import triangulate_svd
from liwslam_torch.core import geometry as geo
from liwslam_torch.solve import factors as fac
from liwslam_torch.solve import gn

_EPS = 1e-9


class FeatureWindow(NamedTuple):
    """Fixed-capacity landmark table over a W-frame sliding window."""

    ids: torch.Tensor  # (F,) int32 track id, -1 = empty slot
    obs: torch.Tensor  # (F,W,2) normalized camera-plane observations
    obs_mask: torch.Tensor  # (F,W) bool
    world: torch.Tensor  # (F,3) triangulated world point
    ready: torch.Tensor  # (F,) bool: world point initialized
    next_id: torch.Tensor  # () int32: allocator for new tracks


def empty_window(F: int, W: int, device="cpu", dtype=torch.float32) -> FeatureWindow:
    return FeatureWindow(
        ids=torch.full((F,), -1, dtype=torch.int32, device=device),
        obs=torch.zeros((F, W, 2), dtype=dtype, device=device),
        obs_mask=torch.zeros((F, W), dtype=torch.bool, device=device),
        world=torch.zeros((F, 3), dtype=dtype, device=device),
        ready=torch.zeros(F, dtype=torch.bool, device=device),
        next_id=torch.zeros((), dtype=torch.int32, device=device),
    )


def push_frame(fw: FeatureWindow, tr_ids, tr_xy, tr_valid) -> FeatureWindow:
    """Record one frame's tracked features in window slot W-1.

    ``tr_ids`` (T,) int32: the ids of tracked features; fresh detections
    carry id -2 and get new ids (as many as there are free slots, in
    order).  Call :func:`shift` first when the window advances."""
    W = fw.obs.shape[1]
    # existing tracks: each feature's slot (the first slot with its id)
    eqm = (tr_ids[:, None] == fw.ids[None, :]) & tr_valid[:, None] & (tr_ids[:, None] >= 0)  # (T,F)
    has_slot = torch.any(eqm, 1)
    slot_of = torch.argmax(eqm.to(torch.int32), 1)
    obs, obs_mask = fw.obs.clone(), fw.obs_mask.clone()
    widx = slot_of[has_slot]
    obs[widx, W - 1] = tr_xy[has_slot].to(obs.dtype)
    obs_mask[widx, W - 1] = True

    # fresh detections: the free slots in order
    fresh = tr_valid & (tr_ids == -2)
    free_slots = torch.nonzero(fw.ids < 0)[:, 0]
    fresh_rank = torch.cumsum(fresh.to(torch.int32), 0, dtype=torch.int32) - 1
    take = fresh & (fresh_rank < free_slots.shape[0])
    dest = free_slots[fresh_rank[take].long()]
    ids = fw.ids.clone()
    ids[dest] = fw.next_id + fresh_rank[take]
    obs[dest, W - 1] = tr_xy[take].to(obs.dtype)
    obs_mask[dest, W - 1] = True
    n_new = torch.sum(fresh.to(torch.int32))
    return fw._replace(ids=ids, obs=obs, obs_mask=obs_mask, next_id=fw.next_id + n_new)


def assigned_ids(fw: FeatureWindow, tr_ids, tr_valid):
    """The ids under which :func:`push_frame` stores this frame's features
    (fresh detections receive newly allocated ids)."""
    fresh = tr_valid & (tr_ids == -2)
    fresh_rank = torch.cumsum(fresh.to(torch.int32), 0, dtype=torch.int32) - 1
    return torch.where(fresh, fw.next_id + fresh_rank, tr_ids.to(torch.int32))


def shift(fw: FeatureWindow) -> FeatureWindow:
    """Advance the window by one frame (the new frame enters at slot W-1)."""
    obs = torch.cat([fw.obs[:, 1:], torch.zeros_like(fw.obs[:, :1])], 1)
    obs_mask = torch.cat([fw.obs_mask[:, 1:], torch.zeros_like(fw.obs_mask[:, :1])], 1)
    return fw._replace(obs=obs, obs_mask=obs_mask)


def pop_oldest(fw: FeatureWindow) -> FeatureWindow:
    """feature_manger::pop_frame (camera_manager.cpp:166-178): drop the
    oldest frame's observations; slots left without one are freed."""
    fw = shift(fw)
    alive = torch.any(fw.obs_mask, 1)
    return fw._replace(ids=torch.where(alive, fw.ids, torch.full_like(fw.ids, -1)), ready=fw.ready & alive)


def _cam_poses(win_p, win_q, T_imu_to_cam):
    """(W,4,4) camera-to-world poses of the window's IMU poses."""
    return geo.make_tf(win_p, win_q) @ T_imu_to_cam


def parallax(fw: FeatureWindow) -> torch.Tensor:
    """(F,) max pairwise image-plane displacement between a landmark's
    observations: the triangulation gate (camera_manager.cpp:155-163)."""
    d = torch.linalg.norm(fw.obs[:, :, None, :] - fw.obs[:, None, :, :], dim=-1)  # (F,W,W)
    pm = fw.obs_mask[:, :, None] & fw.obs_mask[:, None, :]
    return torch.amax(torch.where(pm, d, torch.zeros_like(d)), dim=(1, 2))


def triangulate_ready(
    fw: FeatureWindow,
    win_p,
    win_q,
    T_imu_to_cam,
    *,
    min_obs: int = 5,
    min_parallax: float = 0.02,
) -> FeatureWindow:
    """Initialize the world points of landmarks with enough parallax-gated
    observations (multi-view SVD, camera_manager.cpp:179-190); ``win_p``,
    ``win_q`` (W,3) are the IMU-frame poses of the window's frames."""
    T_w_c = geo.make_tf(win_p, win_q) @ T_imu_to_cam  # (W,4,4)
    cam_pts = torch.cat([fw.obs, torch.ones_like(fw.obs[..., :1])], -1)  # (F,W,3)
    F = fw.obs.shape[0]
    pts, _ = triangulate_svd(cam_pts, T_w_c[None].expand(F, -1, -1, -1), fw.obs_mask)
    n_obs = torch.sum(fw.obs_mask.to(torch.int32), 1)
    init = (fw.ids >= 0) & ~fw.ready & (n_obs >= min_obs) & (parallax(fw) >= min_parallax)
    return fw._replace(
        world=torch.where(init[:, None], pts, fw.world),
        ready=fw.ready | init,
    )


def reproj_error(fw: FeatureWindow, win_p, win_q, T_imu_to_cam):
    """(F,) mean normalized-plane reprojection error over each landmark's
    observations (trajectory::filter_outlier_world_point); an observation
    from a camera the point lies behind counts 1e3."""
    T_c_w = geo.tf_inv(_cam_poses(win_p, win_q, T_imu_to_cam))  # (W,4,4)
    cam = geo.tf_apply(T_c_w[None], fw.world[:, None, :])  # (F,W,3)
    z = cam[..., 2]
    z = torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)
    err = torch.linalg.norm(cam[..., :2] / z[..., None] - fw.obs, dim=-1)
    err = torch.where(cam[..., 2] <= 0.0, torch.full_like(err, 1e3), err)
    n = torch.clamp(torch.sum(fw.obs_mask.to(fw.world.dtype), 1), min=1.0)
    return torch.sum(torch.where(fw.obs_mask, err, torch.zeros_like(err)), 1) / n


def filter_outliers(fw: FeatureWindow, win_p, win_q, T_imu_to_cam, *, max_err: float) -> FeatureWindow:
    """Drop ready landmarks whose mean reprojection error exceeds the
    (fx-normalized) threshold (trajectory.cpp:689-730)."""
    bad = fw.ready & (reproj_error(fw, win_p, win_q, T_imu_to_cam) > max_err)
    return fw._replace(
        ids=torch.where(bad, torch.full_like(fw.ids, -1), fw.ids),
        ready=fw.ready & ~bad,
        obs_mask=fw.obs_mask & ~bad[:, None],
    )


def camera_residual_rows(fw: FeatureWindow, win: fac.WindowState, T_imu_to_cam, sqrt_info, *, latest_only: bool = False):
    """(F*W, 2) whitened reprojection rows for the window solve, zero where
    the observation is missing or the landmark not ready.  ``latest_only``
    keeps the latest frame's rows alone, the tracking-time problem
    (solver.cpp:669-698); the init solve uses all of them."""
    F, W = fw.obs_mask.shape
    r = fac.camera_residual(win.p[None], win.q[None], fw.world[:, None, :], fw.obs, T_imu_to_cam, sqrt_info)
    use = fw.obs_mask & fw.ready[:, None]
    if latest_only:
        use = use & (torch.arange(W, device=use.device) == W - 1)[None, :]
    return (r * use[..., None].to(r.dtype)).reshape(F * W, 2)


def refine_window(fw: FeatureWindow, win: fac.WindowState, T_imu_to_cam, sqrt_info, *, free_frame_mask=None, max_iters: int = 10):
    """Joint pose and landmark refinement (the camera rows of init_solve /
    estimate_features, solver.cpp:50-169): LM (``gn.lm_solve``) over the
    flat state [frames | world points].  Landmarks that are not ready stay
    fixed; ``free_frame_mask`` (W,15) frees frame dims (all when None).
    Returns (window, frame states, cost)."""
    Wn, F = win.p.shape[0], fw.ids.shape[0]
    dtype = win.p.dtype
    x0 = torch.cat([win.flat(), fw.world.reshape(-1)])

    def res_fn(x):
        st = fac.WindowState.from_flat(x[: Wn * 15], Wn)
        return camera_residual_rows(fw._replace(world=x[Wn * 15 :].reshape(F, 3)), st, T_imu_to_cam, sqrt_info).reshape(-1)

    if free_frame_mask is None:
        free_frames = torch.ones((Wn, 15), dtype=dtype, device=x0.device)
    else:
        free_frames = torch.as_tensor(free_frame_mask, dtype=dtype, device=x0.device).reshape(Wn, 15)
    free_lms = fw.ready[:, None].to(dtype).expand(F, 3)
    free = torch.cat([free_frames.reshape(-1), free_lms.reshape(-1)])
    x_opt, cost, _ = gn.lm_solve(res_fn, x0, free, gn.LMConfig(max_iters=max_iters))
    return fw._replace(world=x_opt[Wn * 15 :].reshape(F, 3)), fac.WindowState.from_flat(x_opt[: Wn * 15], Wn), cost
