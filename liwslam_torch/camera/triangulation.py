"""Multi-view triangulation (reference ``e_cv::triangulate_points_SVD``,
common.cpp:124-154).

Port of ``liwslam/camera/triangulation.py``: ``triangulate_svd``, a DLT
over N views on normalized camera rays, batched over leading dims (the
camera path's), and the two-view helpers of camera_match::update_scale
(camera_manager.cpp:7-29), which the camera path does not call.
"""

from __future__ import annotations

import torch

from liwslam_torch.core import geometry as geo


def triangulate_svd(cam_points, T_w_cs, valid):
    """DLT over up to N views, batched over leading dims.

    cam_points: (...,N,3) normalized observations (x, y, 1); T_w_cs:
    (...,N,4,4) camera-to-world poses; valid: (...,N) bool.  Returns
    (world_point (...,3), mean reprojection error (...)).  The smallest
    right singular vector of the (2N,4) system is dehomogenised, which
    cancels its sign."""
    T_c_ws = geo.tf_inv(T_w_cs)
    P = T_c_ws[..., :3, :4]
    x = cam_points[..., 0:1]
    y = cam_points[..., 1:2]
    m = valid.to(cam_points.dtype)[..., None]
    rows1 = (x * P[..., 2, :] - P[..., 0, :]) * m
    rows2 = (y * P[..., 2, :] - P[..., 1, :]) * m
    A = torch.cat([rows1, rows2], -2)  # (...,2N,4)
    _, _, Vh = torch.linalg.svd(A, full_matrices=True)
    X = Vh[..., -1, :]
    w = X[..., 3:4]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    wp = X[..., :3] / w

    cam = (T_c_ws[..., :3, :3] @ wp[..., None, :, None])[..., 0] + T_c_ws[..., :3, 3]
    z = cam[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    err = torch.linalg.norm((cam / z - cam_points)[..., :2], dim=-1)
    n = torch.clamp(torch.sum(valid.to(cam_points.dtype), -1), min=1.0)
    mean_err = torch.sum(torch.where(valid, err, torch.zeros_like(err)), -1) / n
    return wp, mean_err


def triangulate_two_view(c1, c2, tf_1_2):
    """Depth s1 along ray c1 of the point seen at normalized c1 and c2,
    with T_cam1_cam2 = ``tf_1_2``: the 2x2 normal equations of
    min |s1 c1 - (R s2 c2 + t)| (e_cv::triangulate); batched over leading
    dims of c1, c2 (...,3)."""
    R, t = tf_1_2[..., :3, :3], tf_1_2[..., :3, 3]
    r2 = geo.matvec(R, c2)
    a11 = torch.sum(c1 * c1, -1)
    a12 = -torch.sum(c1 * r2, -1)
    a22 = torch.sum(r2 * r2, -1)
    b1 = torch.sum(c1 * t, -1)
    b2 = -torch.sum(r2 * t, -1)
    det = a11 * a22 - a12 * a12
    return (b1 * a22 - b2 * a12) / torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)


def epipolar_inliers(c1s, c2s, valid, tf_1_2, thresh=1e-4):
    """camera_match::update_scale's epipolar gate: with E = [t]x R of the
    given relative pose, keep the pairs of (N,3) normalized points with
    |c1' E c2| below ``thresh``."""
    E = geo.skew(tf_1_2[:3, 3]) @ tf_1_2[:3, :3]
    err = torch.einsum("ni,ij,nj->n", c1s, E, c2s)
    return valid & (torch.abs(err) < thresh)


def update_scale(c1s, c2s, valid, tf_1_2, thresh=1e-4):
    """camera_match::update_scale over N matches: the depths along ray 1
    and the epipolar inlier mask, ((N,), (N,))."""
    return triangulate_two_view(c1s, c2s, tf_1_2), epipolar_inliers(c1s, c2s, valid, tf_1_2, thresh)
