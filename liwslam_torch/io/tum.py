"""TUM trajectory file I/O (the reference's fornt_end.txt / back_end.txt,
``trajectory.cpp:549-559``, ``keyframe_manager.cpp:374-397``).

The port's own copy of ``liwslam/io/tum.py``, host numpy throughout: the
rotation-quaternion conversions are the float64 twins in
``liwslam_torch.core.geometry`` (the reference converts with its float32
device functions)."""

from __future__ import annotations

import numpy as np

from liwslam_torch.core import geometry as geo


def write_tum(path, t_us, T_w, time_offset_s=0.0):
    """T_w: (F,4,4).  Writes '#Time px py pz qx qy qz qw'."""
    with open(path, "w") as f:
        f.write("#Time px py pz qx qy qz qw\n")
        for i in range(len(t_us)):
            t = t_us[i] * 1e-6 + time_offset_s
            x, y, z = T_w[i, :3, 3]
            w, qx, qy, qz = geo.quat_from_mat_np(T_w[i, :3, :3])
            f.write(f"{t:.10f} {x:.10f} {y:.10f} {z:.10f} {qx:.10f} {qy:.10f} {qz:.10f} {w:.10f}\n")


def mat_from_quat_np(q):
    """Unit quaternions (...,4) [w,x,y,z] -> rotation matrices (...,3,3),
    float64 numpy."""
    q = np.asarray(q, np.float64)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return np.stack([np.stack(r, -1) for r in rows], -2)


def read_tum(path):
    """Returns (t_s (F,), T (F,4,4))."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(x) for x in line.split()])
    arr = np.asarray(rows)
    qxyzw = arr[:, 4:8]
    T = np.tile(np.eye(4), (len(arr), 1, 1))
    T[:, :3, :3] = mat_from_quat_np(np.concatenate([qxyzw[:, 3:4], qxyzw[:, :3]], axis=1))
    T[:, :3, 3] = arr[:, 1:4]
    return arr[:, 0], T
