"""Trajectory evaluation: ATE, evo-equivalent.

The port's own copy of the parts of ``liwslam/eval/metrics.py`` it uses
(numpy only).

The reference evaluates TUM trajectory files with the external ``evo``
tool (docker/Dockerfile: pip install evo).  This module provides the same
metric in-repo: absolute trajectory error after SE(3) Umeyama alignment.
Host-side numpy.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(est_xyz: np.ndarray, gt_xyz: np.ndarray, with_scale=False):
    """Least-squares rigid alignment est -> gt.  Returns (R, t, s)."""
    mu_e = est_xyz.mean(0)
    mu_g = gt_xyz.mean(0)
    E = est_xyz - mu_e
    G = gt_xyz - mu_g
    C = G.T @ E / len(est_xyz)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float((D * S.diagonal()).sum() / (E**2).sum() * len(est_xyz)) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est_T: np.ndarray, gt_T: np.ndarray, align=True) -> float:
    """Absolute trajectory error RMSE (m) of (F,4,4) pose arrays."""
    est = est_T[:, :3, 3]
    gt = gt_T[:, :3, 3]
    if align:
        R, t, s = umeyama_alignment(est, gt)
        est = (s * (R @ est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def rpe(est_T: np.ndarray, gt_T: np.ndarray, delta: int = 1):
    """Relative pose error over ``delta`` frames: (trans RMSE m, rot RMSE rad)."""
    et, er = [], []
    for i in range(len(est_T) - delta):
        de = np.linalg.inv(est_T[i]) @ est_T[i + delta]
        dg = np.linalg.inv(gt_T[i]) @ gt_T[i + delta]
        err = np.linalg.inv(dg) @ de
        et.append(np.linalg.norm(err[:3, 3]))
        c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        er.append(np.arccos(c))
    return float(np.sqrt(np.mean(np.square(et)))), float(np.sqrt(np.mean(np.square(er))))


def associate_by_time(t_est, t_gt, max_diff_us=20000):
    """Index pairs (i_est, i_gt) of nearest-time associations."""
    pairs = []
    j = 0
    for i, t in enumerate(t_est):
        j = int(np.searchsorted(t_gt, t))
        best = None
        for jj in (j - 1, j):
            if 0 <= jj < len(t_gt) and abs(int(t_gt[jj]) - int(t)) <= max_diff_us:
                if best is None or abs(int(t_gt[jj]) - int(t)) < abs(
                    int(t_gt[best]) - int(t)
                ):
                    best = jj
        if best is not None:
            pairs.append((i, best))
    return np.asarray(pairs, np.int64).reshape(-1, 2)
