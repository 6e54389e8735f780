"""OpenLORIS-Scene sequence loading (bag-free) + npz interchange.

The reference ingests OpenLORIS rosbags over ROS topics
(``lvio_2d_node.cpp:10-19``, topics from ``config/office.yaml``: /scan,
/odom, /d400/imu0).  This loader reads the equivalent streams from plain
files so no ROS stack is needed:

- ``<seq>/imu.txt``         : ``t ax ay az wx wy wz``   (combined), or
  ``<seq>/d400_accelerometer.txt`` (``t ax ay az``) +
  ``<seq>/d400_gyroscope.txt``     (``t wx wy wz``) — merged by
  interpolating accelerometer onto gyroscope timestamps (what the bag's
  /d400/imu0 combiner does).
- ``<seq>/odom.txt``        : ``t x y z qx qy qz qw`` (+ ignored twist cols)
- ``<seq>/laser.txt``       : per line ``t angle_min angle_increment n r0 r1 ...``
- or a single ``<seq>.npz`` in the interchange schema below.

All timestamps are rebased to the first message (int64 microseconds).
Field orders follow the OpenLORIS raw-package text conventions; adjust
here if a dataset variant differs — everything downstream consumes only
the ``Streams`` arrays.

The port's own copy of ``liwslam/io/openloris.py``, host numpy throughout:
quaternions convert with the float64 helpers of ``io/tum`` and
``core/geometry`` (the reference converts with its float32 device
functions), so values agree to float32's resolution.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from liwslam_torch.core import geometry as geo
from liwslam_torch.io import rosbag, tum
from liwslam_torch.sim.world import SimStreams


def _quats(T):
    """(F,4,4) poses -> (F,4) [w,x,y,z] quaternions of their rotations."""
    return np.asarray([geo.quat_from_mat_np(R) for R in np.asarray(T)[:, :3, :3]]).reshape(-1, 4)


def _to_us(t_s, t0_s):
    return np.round((np.asarray(t_s) - t0_s) * 1e6).astype(np.int64)


def load_sequence(path, max_beams=None, T_imu_to_wheel=None) -> SimStreams:
    """Load a sequence directory (or .npz).

    ``T_imu_to_wheel``: optional (4,4) extrinsic (the config's
    ``T_imu_to_wheel``); when given and ``<seq>/groundtruth.txt`` exists
    (TUM format, base/wheel-frame poses — OpenLORIS ships gt for the
    base_link frame), ``gt_T_w_imu`` is derived as
    ``T_w_wheel @ inv(T_imu_to_wheel)`` so ATE can be evaluated directly
    against the front end's IMU-frame estimate.
    """
    if path.endswith(".npz"):
        return load_npz(path)
    imu_path = os.path.join(path, "imu.txt")
    if os.path.exists(imu_path):
        imu = np.loadtxt(imu_path)
        imu_t, acc, gyro = imu[:, 0], imu[:, 1:4], imu[:, 4:7]
    else:
        a = np.loadtxt(os.path.join(path, "d400_accelerometer.txt"))
        g = np.loadtxt(os.path.join(path, "d400_gyroscope.txt"))
        imu_t = g[:, 0]
        gyro = g[:, 1:4]
        acc = np.stack(
            [np.interp(imu_t, a[:, 0], a[:, 1 + k]) for k in range(3)], -1
        )
    odom = np.loadtxt(os.path.join(path, "odom.txt"))
    odom_t = odom[:, 0]
    wheel_pose = np.tile(np.eye(4), (len(odom), 1, 1))
    q_wxyz = np.concatenate([odom[:, 7:8], odom[:, 4:7]], axis=1)
    wheel_pose[:, :3, :3] = tum.mat_from_quat_np(q_wxyz)
    wheel_pose[:, :3, 3] = odom[:, 1:4]

    laser_t = []
    pts = []
    valid = []
    times_rel = []
    n_beams = max_beams
    with open(os.path.join(path, "laser.txt")) as f:
        for line in f:
            vals = line.split()
            if not vals or vals[0].startswith("#"):
                continue
            t = float(vals[0])
            a0 = float(vals[1])
            da = float(vals[2])
            n = int(vals[3])
            r = np.asarray([float(x) for x in vals[4 : 4 + n]])
            ang = a0 + da * np.arange(n)
            ok = np.isfinite(r) & (r > 0.1)
            xyz = np.stack(
                [r * np.cos(ang), r * np.sin(ang), np.zeros(n)], -1
            ).astype(np.float32)
            if n_beams is None:
                n_beams = n
            xyz = xyz[:n_beams]
            ok = ok[:n_beams]
            laser_t.append(t)
            pts.append(xyz)
            valid.append(ok)
            # per-ray offsets: assume a uniform sweep over the scan period
            times_rel.append((np.arange(n_beams) / max(n_beams, 1) * 0.025).astype(np.float32))
    t0 = min(imu_t[0], odom_t[0], laser_t[0])

    gt_t_us = np.zeros(0, np.int64)
    gt_T_w_imu = np.zeros((0, 4, 4))
    gt_T_w_wheel = np.zeros((0, 4, 4))
    gt_path = os.path.join(path, "groundtruth.txt")
    if os.path.exists(gt_path):
        gt_t_s, gt_T_w_wheel = tum.read_tum(gt_path)
        gt_t_us = _to_us(gt_t_s, t0)
        if T_imu_to_wheel is not None:
            gt_T_w_imu = gt_T_w_wheel @ np.linalg.inv(np.asarray(T_imu_to_wheel, np.float64))
        else:
            gt_T_w_imu = np.zeros((0, 4, 4))

    return SimStreams(
        imu_t_us=_to_us(imu_t, t0),
        imu_acc=acc.astype(np.float32),
        imu_gyro=gyro.astype(np.float32),
        wheel_t_us=_to_us(odom_t, t0),
        wheel_pose=wheel_pose.astype(np.float32),
        laser_t_us=_to_us(laser_t, t0),
        laser_points=np.stack(pts),
        laser_times_rel=np.stack(times_rel),
        laser_valid=np.stack(valid),
        gt_t_us=gt_t_us,
        gt_T_w_imu=gt_T_w_imu,
        gt_T_w_wheel=gt_T_w_wheel,
    )


def save_text_sequence(path, streams: SimStreams, t0_s=1560000000.0):
    """Write ``streams`` in the OpenLORIS raw-text layout read by
    ``load_sequence`` (imu.txt / odom.txt / laser.txt / groundtruth.txt).

    The inverse of ``load_sequence`` for round-trip ingestion tests and
    for converting simulator output into the dataset interchange format.
    Laser beams must lie on a uniform angle grid (OpenLORIS scans do;
    the simulator's do); invalid beams are written as NaN ranges.
    """
    os.makedirs(path, exist_ok=True)
    it = streams.imu_t_us * 1e-6 + t0_s
    np.savetxt(
        os.path.join(path, "imu.txt"),
        np.column_stack([it, streams.imu_acc, streams.imu_gyro]),
        fmt="%.9f",
    )

    wt = streams.wheel_t_us * 1e-6 + t0_s
    q_wxyz = _quats(streams.wheel_pose)
    np.savetxt(
        os.path.join(path, "odom.txt"),
        np.column_stack(
            [wt, streams.wheel_pose[:, :3, 3], q_wxyz[:, 1:4], q_wxyz[:, 0:1]]
        ),
        fmt="%.9f",
    )

    lt = streams.laser_t_us * 1e-6 + t0_s
    with open(os.path.join(path, "laser.txt"), "w") as f:
        for k in range(len(lt)):
            xy = streams.laser_points[k, :, :2]
            r = np.linalg.norm(xy, axis=-1)
            ang = np.unwrap(np.arctan2(xy[:, 1], xy[:, 0]))
            # recover the uniform grid from two valid beams
            ok = streams.laser_valid[k] & (r > 0.1)
            idx = np.flatnonzero(ok)
            if len(idx) >= 2:
                i0, i1 = idx[0], idx[-1]
                da = (ang[i1] - ang[i0]) / max(i1 - i0, 1)
                a0 = ang[i0] - da * i0
            else:
                a0, da = -np.pi, 2 * np.pi / max(len(r), 1)
            r = np.where(ok, r, np.nan)
            vals = " ".join(f"{x:.6f}" for x in r)
            f.write(f"{lt[k]:.9f} {a0:.9f} {da:.9f} {len(r)} {vals}\n")

    if len(streams.gt_t_us):
        tum.write_tum(
            os.path.join(path, "groundtruth.txt"),
            streams.gt_t_us,
            streams.gt_T_w_wheel,
            time_offset_s=t0_s,
        )


def load_bag(
    path,
    *,
    laser_topic="/scan",
    wheel_odom_topic="/odom",
    imu_topic="/d400/imu0",
    camera_topic=None,  # e.g. "/d400/color/image_raw" (config/office.yaml:4)
    max_beams=None,
    T_imu_to_wheel=None,
    gt_path=None,
) -> SimStreams:
    """Load sensor streams straight from an OpenLORIS ROS1 bag.

    Topic defaults follow the reference's OpenLORIS configs
    (``config/office.yaml:1-3``: /scan, /odom, /d400/imu0).  Uses the
    pure-Python bag reader (liwslam_torch.io.rosbag) — no ROS stack needed.
    Ground truth is distributed separately as TUM text; pass ``gt_path``
    to attach it (base/wheel-frame, converted like ``load_sequence``).
    """
    imu_t, acc, gyro = [], [], []
    odom_t, odom_p, odom_q = [], [], []
    laser = []
    cam_t, cam_imgs = [], []
    wanted = {laser_topic, wheel_odom_topic, imu_topic}
    if camera_topic:
        wanted.add(camera_topic)
    for topic, mtype, msg in rosbag.read_messages(path, topics=wanted):
        if topic == imu_topic:
            imu_t.append(msg["stamp"])
            acc.append(msg["acc"])
            gyro.append(msg["gyro"])
        elif topic == wheel_odom_topic:
            odom_t.append(msg["stamp"])
            odom_p.append(msg["p"])
            odom_q.append(msg["q_xyzw"])
        elif topic == laser_topic:
            laser.append(msg)
        elif camera_topic and topic == camera_topic:
            cam_t.append(msg["stamp"])
            cam_imgs.append(msg["image"])
    if not laser or not imu_t or not odom_t:
        raise ValueError(
            f"{path}: missing topics (laser={len(laser)}, imu={len(imu_t)}, "
            f"odom={len(odom_t)}) — check topic names"
        )

    # real bags store messages in chunk order, which may be out of stamp
    # order across chunks (rosbag play re-orders via the index; our
    # reader streams file order).  Sort each stream by stamp so the
    # dispatcher's monotonicity filter doesn't silently drop data.
    def _argsorted(ts):
        return np.argsort(np.asarray(ts), kind="stable")

    o = _argsorted(imu_t)
    imu_t = [imu_t[i] for i in o]
    acc = [acc[i] for i in o]
    gyro = [gyro[i] for i in o]
    o = _argsorted(odom_t)
    odom_t = [odom_t[i] for i in o]
    odom_p = [odom_p[i] for i in o]
    odom_q = [odom_q[i] for i in o]
    laser = [laser[i] for i in _argsorted([m["stamp"] for m in laser])]
    if cam_t:
        o = _argsorted(cam_t)
        cam_t = [cam_t[i] for i in o]
        cam_imgs = [cam_imgs[i] for i in o]

    wheel_pose = np.tile(np.eye(4), (len(odom_t), 1, 1))
    q_xyzw = np.stack(odom_q)
    q_wxyz = np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, 0:3]], axis=1)
    wheel_pose[:, :3, :3] = tum.mat_from_quat_np(q_wxyz)
    wheel_pose[:, :3, 3] = np.stack(odom_p)

    n_beams = max_beams or max(len(m["ranges"]) for m in laser)
    L = len(laser)
    pts = np.zeros((L, n_beams, 3), np.float32)
    valid = np.zeros((L, n_beams), bool)
    times_rel = np.zeros((L, n_beams), np.float32)
    laser_t = np.asarray([m["stamp"] for m in laser])
    for k, m in enumerate(laser):
        r = np.asarray(m["ranges"], np.float64)[:n_beams]
        n = len(r)
        ang = m["angle_min"] + m["angle_increment"] * np.arange(n)
        ok = np.isfinite(r) & (r > max(m["range_min"], 0.05)) & (
            r < m["range_max"]
        )
        pts[k, :n] = np.stack(
            [np.where(ok, r, 0.0) * np.cos(ang),
             np.where(ok, r, 0.0) * np.sin(ang),
             np.zeros(n)], -1
        )
        valid[k, :n] = ok
        times_rel[k, :n] = m["time_increment"] * np.arange(n)

    t0 = min(imu_t[0], odom_t[0], laser_t[0])
    gt_t_us = np.zeros(0, np.int64)
    gt_T_w_imu = np.zeros((0, 4, 4))
    gt_T_w_wheel = np.zeros((0, 4, 4))
    if gt_path is not None:
        gt_t_s, gt_T_w_wheel = tum.read_tum(gt_path)
        gt_t_us = _to_us(gt_t_s, t0)
        if T_imu_to_wheel is not None:
            gt_T_w_imu = gt_T_w_wheel @ np.linalg.inv(
                np.asarray(T_imu_to_wheel, np.float64)
            )

    return SimStreams(
        imu_t_us=_to_us(imu_t, t0),
        imu_acc=np.stack(acc).astype(np.float32),
        imu_gyro=np.stack(gyro).astype(np.float32),
        wheel_t_us=_to_us(odom_t, t0),
        wheel_pose=wheel_pose.astype(np.float32),
        laser_t_us=_to_us(laser_t, t0),
        laser_points=pts,
        laser_times_rel=times_rel,
        laser_valid=valid,
        gt_t_us=gt_t_us,
        gt_T_w_imu=gt_T_w_imu,
        gt_T_w_wheel=gt_T_w_wheel,
        cam_t_us=_to_us(cam_t, t0) if cam_t else np.zeros(0, np.int64),
        cam_images=(
            np.stack(cam_imgs).astype(np.float32)
            if cam_imgs
            else np.zeros((0, 1, 1), np.float32)
        ),
    )


def save_bag(path, streams: SimStreams, *, t0_s=1560000000.0,
             laser_topic="/scan", wheel_odom_topic="/odom",
             imu_topic="/d400/imu0", camera_topic="/d400/color/image_raw",
             **writer_kw):
    """Write ``streams`` as a ROS1 bag (inverse of ``load_bag``; lets the
    simulator emit real .bag fixtures for the converter round-trip).
    Extra kwargs go to :class:`rosbag.BagWriter` (e.g. compression="lz4",
    indexed=True for rosbag-C++-shaped fixtures)."""
    with rosbag.BagWriter(path, **writer_kw) as w:
        for k in range(len(streams.imu_t_us)):
            t = streams.imu_t_us[k] * 1e-6 + t0_s
            w.write(
                imu_topic,
                "sensor_msgs/Imu",
                t,
                rosbag.serialize_imu(t, streams.imu_acc[k], streams.imu_gyro[k]),
            )
        q_wxyz = _quats(streams.wheel_pose)
        for k in range(len(streams.wheel_t_us)):
            t = streams.wheel_t_us[k] * 1e-6 + t0_s
            q_xyzw = np.concatenate([q_wxyz[k, 1:4], q_wxyz[k, 0:1]])
            w.write(
                wheel_odom_topic,
                "nav_msgs/Odometry",
                t,
                rosbag.serialize_odometry(t, streams.wheel_pose[k, :3, 3], q_xyzw),
            )
        for k in range(len(streams.laser_t_us)):
            t = streams.laser_t_us[k] * 1e-6 + t0_s
            xy = streams.laser_points[k, :, :2]
            r = np.linalg.norm(xy, axis=-1)
            ok = streams.laser_valid[k] & (r > 0.1)
            idx = np.flatnonzero(ok)
            if len(idx) >= 2:
                # fit a0/da over VALID beams only: invalid returns are
                # (0,0) and unwrapping arctan2 through them corrupts the
                # angle sequence, silently dropping interleaved beams on
                # round-trip (advisor r2)
                av = np.unwrap(np.arctan2(xy[idx, 1], xy[idx, 0]))
                da, a0 = np.polyfit(idx.astype(np.float64), av, 1)
            else:
                a0, da = -np.pi, 2 * np.pi / max(len(r), 1)
            tr = streams.laser_times_rel[k]
            time_inc = float(tr[1] - tr[0]) if len(tr) > 1 else 0.0
            w.write(
                laser_topic,
                "sensor_msgs/LaserScan",
                t,
                rosbag.serialize_laser_scan(
                    t,
                    np.where(ok, r, np.nan),
                    float(a0),
                    float(da),
                    time_increment=time_inc,
                ),
            )
        cam_t = getattr(streams, "cam_t_us", np.zeros(0, np.int64))
        for k in range(len(cam_t)):
            t = cam_t[k] * 1e-6 + t0_s
            w.write(
                camera_topic,
                "sensor_msgs/Image",
                t,
                rosbag.serialize_image(t, streams.cam_images[k]),
            )


_FIELDS = [
    "imu_t_us", "imu_acc", "imu_gyro", "wheel_t_us", "wheel_pose",
    "laser_t_us", "laser_points", "laser_times_rel", "laser_valid",
    "gt_t_us", "gt_T_w_imu", "gt_T_w_wheel",
]


def save_npz(path, streams: SimStreams):
    np.savez_compressed(path, **{k: getattr(streams, k) for k in _FIELDS})


def load_npz(path) -> SimStreams:
    z = np.load(path)
    return SimStreams(**{k: z[k] for k in _FIELDS})
