"""Per-landmark feature window bookkeeping (the reference's feature_manger).

Port of the part of ``liwslam/camera/features.py`` that the camera path
runs: the fixed-capacity landmark table (``FeatureWindow``), its empty
constructor, the parallax gate and multi-view triangulation of the
landmarks that are ready (``camera_manager.cpp:140-190``).  Landmarks are
slots and observations a dense (F, W, 2) array with a mask, so every
operation is a batched tensor program with no host round trip.

Not ported yet (used only by the reference package's tests):
``push_frame``, ``pop_oldest``, ``reproj_error``, ``filter_outliers``,
``camera_residual_rows``, ``refine_window``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from liwslam_torch.camera.triangulation import triangulate_svd
from liwslam_torch.core import geometry as geo


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
