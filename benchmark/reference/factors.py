"""Batched factor residuals over a fixed-capacity sliding window.

The benchmark's frozen reference copy of the port's ``solve/factors``.

Port of ``liwslam/solve/factors.py`` (the reference's Ceres functors,
``src/factor/*.h``): residual functions over struct-of-array window
states, written with plain tensor ops so ``torch.func.jacfwd`` of the
stacked residual replaces Ceres autodiff.

- imu_factor.h:75-87 — preintegration residual with first-order bias
  repair, gravity ``g*(0,0,1)``, whitened by ``sqrt_inverse_P``.
- wheel_factor.h:39-70 — [arc-length, direction-angle, yaw-norm].
- laser_factor.h:31-88 — point-to-line distances of both endpoints of the
  new line to the matched reference line, z zeroed, length-weighted.
- ground_factor.h:25-89 — wheel-frame height and tilt penalties.
- marginalization_factor.h:50 — the prior is ``J_lin (X - X_lin)``.

- camera_factor.h:36-67 — whitened normalized-plane reprojection error.
- edge_factor.h:88-117 — the pose graph's relative-pose edge residual.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import geometry as geo

_EPS = 1e-8
FRAME_DIM = 15


class WindowState(NamedTuple):
    """Sliding window state (frame_info p/q/v/bs, trajectory_type.h)."""

    p: torch.Tensor  # (W,3)
    q: torch.Tensor  # (W,3)
    v: torch.Tensor  # (W,3)
    bs: torch.Tensor  # (W,6)

    def flat(self):
        return torch.cat([self.p, self.q, self.v, self.bs], -1).reshape(-1)

    @staticmethod
    def from_flat(x, W):
        f = x.reshape(W, FRAME_DIM)
        return WindowState(p=f[:, 0:3], q=f[:, 3:6], v=f[:, 6:9], bs=f[:, 9:15])


class SolveConsts(NamedTuple):
    """Extrinsics and information weights (0-d tensors on the device)."""

    T_imu_to_wheel: torch.Tensor  # (4,4)
    T_imu_to_laser: torch.Tensor  # (4,4)
    g: torch.Tensor  # ()
    laser_sqrt_info: torch.Tensor  # () = 1/line_to_line_sigma
    ground_p_info: torch.Tensor  # () = 1/manifold_p_sigma
    ground_q_info: torch.Tensor  # () = 1/manifold_q_sigma


def make_consts(params, device="cpu") -> SolveConsts:
    f = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)
    return SolveConsts(
        T_imu_to_wheel=f(params.mat_T_imu_to_wheel()),
        T_imu_to_laser=f(params.mat_T_imu_to_laser()),
        g=f(params.g),
        laser_sqrt_info=f(1.0 / params.line_to_line_sigma),
        ground_p_info=f(1.0 / params.manifold_p_sigma),
        ground_q_info=f(1.0 / params.manifold_q_sigma),
    )


class FactorData(NamedTuple):
    """All measurements binding one window solve (masked, fixed shapes)."""

    imu_X: torch.Tensor  # (W,15) row i: factor between frames i-1, i
    imu_J: torch.Tensor  # (W,15,15)
    imu_sqrtP: torch.Tensor  # (W,15,15)
    imu_Dt: torch.Tensor  # (W,)
    imu_valid: torch.Tensor  # (W,) bool
    wheel_dT: torch.Tensor  # (W,4,4)
    wheel_sqrt: torch.Tensor  # (W,3,3)
    wheel_valid: torch.Tensor  # (W,)
    laser_l1p1: torch.Tensor  # (M,3) ref-line endpoints (ref laser frame)
    laser_l1p2: torch.Tensor  # (M,3)
    laser_l2p1: torch.Tensor  # (M,3) new-line endpoints (own laser frame)
    laser_l2p2: torch.Tensor  # (M,3)
    laser_i_idx: torch.Tensor  # (M,) int — ref frame, < 0: frozen ref pose
    laser_j_idx: torch.Tensor  # (M,) int
    laser_ref_p: torch.Tensor  # (M,3) frozen ref pose (used when i_idx<0)
    laser_ref_q: torch.Tensor  # (M,3)
    laser_valid: torch.Tensor  # (M,)
    ground_weight: torch.Tensor  # ()
    frame_valid: torch.Tensor  # (W,) bool
    prior_J: torch.Tensor  # (15,15)
    prior_X: torch.Tensor  # (15,)
    prior_res: torch.Tensor  # (15,) constant term (unused, see below)
    prior_idx: torch.Tensor  # () int
    prior_valid: torch.Tensor  # () bool


def _ez(like):
    """(0, 0, 1) on like's device, without a host-to-device copy."""
    one = torch.ones(1, dtype=like.dtype, device=like.device)
    return torch.nn.functional.pad(one, (2, 0))


def imu_residual(st: WindowState, d: FactorData, c: SolveConsts):
    """(W,15) rows; row i = factor between frames i-1, i (imu_factor.h)."""
    pi, qi, vi, bsi = st.p[:-1], st.q[:-1], st.v[:-1], st.bs[:-1]
    pj, qj, vj, bsj = st.p[1:], st.q[1:], st.v[1:], st.bs[1:]
    X, J, Dt = d.imu_X[1:], d.imu_J[1:], d.imu_Dt[1:, None]
    mv = lambda A, v: (A @ v[..., None])[..., 0]
    dba = bsi[:, :3] - X[:, 9:12]
    dbw = bsi[:, 3:] - X[:, 12:15]
    alpha = X[:, 0:3] + mv(J[:, 0:3, 9:12], dba) + mv(J[:, 0:3, 12:15], dbw)
    beta = X[:, 3:6] + mv(J[:, 3:6, 9:12], dba) + mv(J[:, 3:6, 12:15], dbw)
    gamma = X[:, 6:9] + mv(J[:, 6:9, 12:15], dbw)
    ez = _ez(st.p)
    R_iw = geo.exp_so3(-qi)
    r_alpha = alpha - mv(R_iw, pj - pi + 0.5 * c.g * ez * Dt * Dt - vi * Dt)
    r_beta = beta - mv(R_iw, vj + c.g * ez * Dt - vi)
    r_gamma = geo.log_SO3(geo.exp_so3(-gamma) @ (R_iw @ geo.exp_so3(qj)))
    r = torch.cat([r_alpha, r_beta, r_gamma, bsj[:, :3] - bsi[:, :3], bsj[:, 3:] - bsi[:, 3:]], -1)
    rows = mv(d.imu_sqrtP[1:], r)
    rows = torch.cat([torch.zeros_like(rows[:1]), rows], 0)
    return rows * d.imu_valid[:, None].to(rows.dtype)


def wheel_residual(st: WindowState, d: FactorData, c: SolveConsts):
    """(W,3) rows (wheel_factor.h:39-70)."""
    Tiw = c.T_imu_to_wheel
    tf_i = geo.make_tf(st.p[:-1], st.q[:-1]) @ Tiw
    tf_j = geo.make_tf(st.p[1:], st.q[1:]) @ Tiw
    p, q = geo.log_SE3(geo.tf_inv(tf_i) @ tf_j)
    op, oq = geo.log_SE3(d.wheel_dT[1:])
    o_len = torch.sqrt(op[:, 0] ** 2 + op[:, 1] ** 2 + _EPS)
    length = torch.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2 + _EPS)
    zero = torch.zeros_like(p[:, 0])
    o_dir = torch.stack([op[:, 0], op[:, 1], zero], -1)
    ndir = torch.stack([p[:, 0], p[:, 1], zero], -1)
    on = geo.safe_norm(o_dir)
    nn = geo.safe_norm(ndir)
    both = (on > 1e-4) & (nn > 1e-4)
    o_u = o_dir / on[:, None]
    n_u = ndir / nn[:, None]
    sinn = geo.safe_norm(torch.cross(o_u, n_u, dim=-1))
    angle = torch.where(both, torch.arcsin(torch.clamp(sinn, 0.0, 1.0 - 1e-6)), nn)
    degenerate = (length < 1e-4) | (o_len < 1e-4)
    r0 = torch.where(degenerate, length, o_len - length)
    qn = geo.safe_norm(q)
    oqn = geo.safe_norm(oq)
    r2 = torch.where((qn < 1e-3) | (oqn < 1e-3), qn, oqn - qn)
    Wm = d.wheel_sqrt[1:]
    rows = torch.stack([Wm[:, 0, 0] * r0, Wm[:, 1, 1] * angle, Wm[:, 2, 2] * r2], -1)
    rows = torch.cat([torch.zeros_like(rows[:1]), rows], 0)
    return rows * d.wheel_valid[:, None].to(rows.dtype)


def laser_residual(st: WindowState, d: FactorData, c: SolveConsts):
    """(M,2) rows (laser_factor.h:31-88)."""
    Til = c.T_imu_to_laser
    W = st.p.shape[0]
    use_frame = (d.laser_i_idx >= 0)[:, None]
    ic = torch.clamp(d.laser_i_idx, 0, W - 1).long()
    jc = d.laser_j_idx.long()
    pi = torch.where(use_frame, st.p[ic], d.laser_ref_p)
    qi = torch.where(use_frame, st.q[ic], d.laser_ref_q)
    T_w_i = geo.make_tf(pi, qi) @ Til
    T_w_j = geo.make_tf(st.p[jc], st.q[jc]) @ Til
    flat = 1.0 - _ez(st.p)  # zero the z components
    a1 = geo.tf_apply(T_w_i, d.laser_l1p1) * flat
    a2 = geo.tf_apply(T_w_i, d.laser_l1p2) * flat
    b1 = geo.tf_apply(T_w_j, d.laser_l2p1) * flat
    b2 = geo.tf_apply(T_w_j, d.laser_l2p2) * flat
    d1 = geo.dis_from_line(b1, a1, a2)
    d2 = geo.dis_from_line(b2, a1, a2)
    len1 = torch.linalg.norm(d.laser_l1p1 - d.laser_l1p2, dim=-1)
    len2 = torch.linalg.norm(d.laser_l2p1 - d.laser_l2p2, dim=-1)
    wsum = torch.sqrt(torch.clamp(torch.minimum(len1, len2) / 2.0 / 0.02, min=_EPS))
    rows = (wsum * c.laser_sqrt_info)[:, None] * torch.stack([d1, d2], -1)
    return rows * d.laser_valid[:, None].to(rows.dtype)


def ground_residual(st: WindowState, d: FactorData, c: SolveConsts):
    """(W,2) rows: [p, q] ground factors (ground_factor.h)."""
    tf_w_o = geo.make_tf(st.p, st.q) @ c.T_imu_to_wheel
    r_p = c.ground_p_info * tf_w_o[:, 2, 3]
    z_axis = tf_w_o[:, :3, 2]
    sinn = geo.safe_norm(torch.cross(z_axis, _ez(st.p).expand_as(z_axis), dim=-1))
    r_q = c.ground_q_info * torch.arcsin(torch.clamp(sinn, 0.0, 1.0 - 1e-6))
    rows = torch.stack([r_p, r_q], -1) * d.ground_weight
    return rows * d.frame_valid[:, None].to(rows.dtype)


def prior_residual(st: WindowState, d: FactorData, c: SolveConsts):
    """(15,) marginalization prior on frame prior_idx.  The constant term
    ``prior_res`` is left out, as in the reference (the honest version is
    commented out at marginalization_factor.h:50)."""
    i = d.prior_idx.long()
    X = torch.cat([st.p[i], st.q[i], st.v[i], st.bs[i]])
    r = d.prior_J @ (X - d.prior_X)
    return r * d.prior_valid.to(r.dtype)


def stack_residuals(st: WindowState, d: FactorData, c: SolveConsts):
    """The full whitened residual vector of one window problem."""
    return torch.cat(
        [
            imu_residual(st, d, c).reshape(-1),
            wheel_residual(st, d, c).reshape(-1),
            laser_residual(st, d, c).reshape(-1),
            ground_residual(st, d, c).reshape(-1),
            prior_residual(st, d, c),
        ]
    )


def camera_residual(p, q, world_point, cam_point_xy, T_imu_to_camera, sqrt_info):
    """(...,2) whitened normalized-plane reprojection error of world points
    seen from IMU-frame poses (p, q) (camera_factor.h:36-67), broadcasting
    over leading dims; ``sqrt_info`` is (2,) = fx / camera_sigma."""
    T_w_c = geo.make_tf(p, q) @ T_imu_to_camera
    cam = geo.tf_apply(geo.tf_inv(T_w_c), world_point)
    z = cam[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return sqrt_info * (cam_point_xy - cam[..., :2] / z)


def camera_sqrt_info(params, dtype=torch.float32, device="cpu"):
    """camera_noise (camera_factor.h:18-27): sigma normalized by fx."""
    fx = params.mat_camera_K()[0, 0]
    s = np.asarray(params.camera_sigma) / fx
    return torch.as_tensor(1.0 / s, dtype=dtype, device=device)


# --- pose-graph factors (back end) -------------------------------------------


def edge_residual(p_i, q_i, p_j, q_j, tf12, info6, weight):
    """edge_factor.h:88-117: log_SE3(tf_j^-1 tf_i tf12), diag-weighted;
    broadcasts over leading (edge) dims, ``weight`` has one per edge."""
    err = geo.tf_inv(geo.make_tf(p_j, q_j)) @ geo.make_tf(p_i, q_i) @ tf12
    rp, rq = geo.log_SE3(err)
    return weight[..., None] * info6 * torch.cat([rp, rq], -1)


def point_residual(p, q, pt1, pt2):
    """point_factor.h:16-35: 100 (p1 - T p2)."""
    return 100.0 * (pt1 - geo.tf_apply(geo.make_tf(p, q), pt2))


def prior_factor_residual(p_i, q_i, prior_p, prior_q, sqrt_H):
    """edge_factor.h:27-77 (prior_factor): the state difference
    [prior_p - p; prior_q - q] weighted by a stored 6x6 square-root
    information block.  The reference defines it and calls it nowhere (its
    one call site is commented out, keyframe_manager.cpp:756-772)."""
    return geo.matvec(sqrt_H, torch.cat([prior_p - p_i, prior_q - q_i], -1))


def loop_edge_residual(p_i, q_i, p_j, q_j, w_tf12, T_imu_to_wheel, info6, weight=1.0):
    """edge_factor.h:128-179 (loop_edge_factor): the planar relative-pose
    residual in the wheel frame, x, y and yaw rows, rows 3-5 zero.
    ``w_tf12`` is the measured relative transform already conjugated into
    the wheel frame.  Row 1 is weighted by ``info6[1]``, the intended
    1/loop_sigma_p[1] (see :func:`edge_info6`).  Defined and not called,
    as in the reference."""
    Tiw = T_imu_to_wheel
    tf_ij = geo.tf_inv(geo.make_tf(p_i, q_i)) @ geo.make_tf(p_j, q_j)
    w_tf_ij = geo.tf_inv(Tiw) @ tf_ij @ Tiw
    p, q = geo.log_SE3(w_tf_ij)
    op, oq = geo.log_SE3(w_tf12)
    z = torch.zeros_like(p[..., 0])
    return torch.stack(
        [
            weight * info6[0] * (p[..., 0] - op[..., 0]),
            weight * info6[1] * (p[..., 1] - op[..., 1]),
            weight * info6[5] * (q[..., 2] - oq[..., 2]),
            z,
            z,
            z,
        ],
        -1,
    )


def edge_info6(params, device="cpu"):
    """Intended diagonal of edge_noise (edge_factor.h:15-25; the reference
    leaves J(1,1)=1 due to the J(1,2) typo; the intended value is used)."""
    info = np.concatenate([1.0 / np.asarray(params.loop_sigma_p), 1.0 / np.asarray(params.loop_sigma_q)])
    return torch.as_tensor(info.astype(np.float32), device=device)
