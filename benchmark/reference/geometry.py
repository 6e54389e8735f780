"""Batched Lie-group primitives (so3/SE3) on torch tensors: the benchmark's
frozen reference copy of the port's ``core/geometry``, products as library
matrix products.

Originally a port of ``liwslam/core/geometry.py`` (the reference ``lie::`` namespace,
``src/utilies/common.h:119-196``).  Everything broadcasts over leading
batch dimensions and is safe under ``torch.func.jacfwd``: small-angle
singularities use Taylor branches selected by ``torch.where`` on clamped
inputs, so neither branch produces a non-finite value or tangent.

``log_SE3`` follows the reference convention: the translation part is the
raw translation column, not the V-corrected SE3 log (common.h:166-171).

"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def safe_norm(v, dim=-1, eps=_EPS, keepdim=False):
    """sqrt(max(sum v^2, eps^2)): finite value and finite derivative at 0."""
    s = torch.sum(v * v, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(s, min=eps * eps))


def matmul(A, B):
    """A @ B for small matrices, (...,m,k) @ (...,k,n): the library product
    (the port sums elementwise products for batch invariance; the reference
    needs none)."""
    return A @ B


def matvec(A, v):
    """A @ v for (...,m,k) and (...,k)."""
    return (A @ v[..., None])[..., 0]


def skew(w):
    """Cross-product matrix: skew(w) @ v == cross(w, v)."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([z, -w[..., 2], w[..., 1]], -1),
            torch.stack([w[..., 2], z, -w[..., 0]], -1),
            torch.stack([-w[..., 1], w[..., 0], z], -1),
        ],
        -2,
    )


def diag_sq(sigma):
    """diag(sigma_i^2) (convert::disdiagonal2, common.h:40-47)."""
    sigma = torch.as_tensor(sigma)
    n = sigma.shape[-1]
    return torch.eye(n, dtype=sigma.dtype, device=sigma.device) * (sigma**2)[..., None, :]


def exp_so3(w):
    """Rodrigues: so3 vector (...,3) -> rotation matrix (...,3,3)."""
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta * theta)
    )
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    # R = (1 - b theta^2) I + a K + b w w^T
    dgn = 1.0 - b * theta2
    rows = [
        [dgn + b * wx * wx, -a * wz + b * wx * wy, a * wy + b * wx * wz],
        [a * wz + b * wx * wy, dgn + b * wy * wy, -a * wx + b * wy * wz],
        [-a * wy + b * wx * wz, a * wx + b * wy * wz, dgn + b * wz * wz],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def quat_from_mat(R):
    """Rotation matrix (...,3,3) -> unit quaternion (...,4) [w,x,y,z], w >= 0.

    Branchless Shepperd extraction: all four candidates, selected by the
    largest pivot (first index on ties, as argmax)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def ssqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    s0 = ssqrt(1.0 + tr) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = ssqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = ssqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = ssqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)
    b0 = (tr >= m00) & (tr >= m11) & (tr >= m22)
    b1 = ~b0 & (m00 >= m11) & (m00 >= m22)
    b2 = ~b0 & ~b1 & (m11 >= m22)
    q = torch.where(
        b0[..., None],
        q0,
        torch.where(b1[..., None], q1, torch.where(b2[..., None], q2, q3)),
    )
    q = q / safe_norm(q, keepdim=True)
    # canonical hemisphere (w >= 0) so the angle lands in [0, pi]
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def log_SO3(R):
    """Rotation matrix (...,3,3) -> so3 vector (...,3), |angle| <= pi."""
    q = quat_from_mat(R)
    qw, qv = q[..., 0], q[..., 1:]
    sin_half = safe_norm(qv)
    angle = 2.0 * torch.atan2(sin_half, qw)
    small = sin_half < _EPS
    scale = torch.where(small, 2.0, angle / torch.clamp(sin_half, min=_EPS))
    return scale[..., None] * qv


def normalize_so3(w):
    """Wrap an so3 vector so its angle lies in (-pi, pi]."""
    theta = torch.sqrt(torch.clamp(torch.sum(w * w, -1), min=_EPS * _EPS))
    two_pi = 2.0 * math.pi
    wrapped = theta - two_pi * torch.floor((theta + math.pi) / two_pi)
    scale = torch.where(theta > math.pi, wrapped / theta, 1.0)
    return w * scale[..., None]


def make_tf_R(p, R):
    """(p (...,3), R (...,3,3)) -> homogeneous transform (...,4,4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], p.shape[:-1])
    R = R.expand(batch + (3, 3))
    p = p.expand(batch + (3,))
    top = torch.cat([R, p[..., :, None]], -1)
    # [0, 0, 0, 1] built on the device (a tensor from a Python list would
    # be a host-to-device copy, which waits for the card)
    one = torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device)
    return torch.cat([top, torch.nn.functional.pad(one, (3, 0))], -2)


def make_tf(p, w):
    """(p (...,3), so3 w (...,3)) -> homogeneous transform (...,4,4)."""
    return make_tf_R(p, exp_so3(w))


def log_SE3(T):
    """(...,4,4) -> (p (...,3), so3 (...,3))."""
    return T[..., :3, 3], log_SO3(T[..., :3, :3])


def tf_inv(T):
    """Inverse of a rigid transform."""
    R = T[..., :3, :3]
    p = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_tf_R(-matvec(Rt, p), Rt)


def tf_apply(T, pts):
    """Apply (...,4,4) to points (...,3), broadcasting over leading dims."""
    return matvec(T[..., :3, :3], pts) + T[..., :3, 3]


def tf_compose(A, B):
    """A @ B for (...,4,4) transforms."""
    return matmul(A, B)


def dis_from_line(p, p1, p2):
    """Distance of point(s) p from the infinite line through p1, p2
    (e_laser::dis_from_line, common.h:86-95).  Safe for degenerate lines."""
    d = p2 - p1
    d = d / safe_norm(d, keepdim=True)
    v = p - p2
    perp = v - torch.sum(d * v, -1, keepdim=True) * d
    return safe_norm(perp)


def angle_wrap(a):
    """Wrap angle(s) to [-pi, pi)."""
    return a - 2.0 * math.pi * torch.floor((a + math.pi) / (2.0 * math.pi))


def mat_from_quat(q):
    """Unit quaternion (...,4) [w,x,y,z] -> rotation matrix (...,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def normalize_tf(T):
    """Re-orthonormalize the rotation block via quaternion round trip
    (lie::normalize_tf)."""
    return make_tf_R(T[..., :3, 3], mat_from_quat(quat_from_mat(T[..., :3, :3])))
