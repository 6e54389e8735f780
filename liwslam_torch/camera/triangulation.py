"""Multi-view triangulation (reference ``e_cv::triangulate_points_SVD``,
common.cpp:124-154).

Port of ``liwslam/camera/triangulation.py:triangulate_svd``: a DLT over N
views on normalized camera rays, batched over leading dims.  The two-view
helpers of that module (``triangulate_two_view``, ``epipolar_inliers``,
``update_scale``) are not on the camera path and are not ported yet.
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
