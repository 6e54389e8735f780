"""Synthetic line-world simulator: ground-truth tracks -> clean sensor
streams, the traffic generator's source of scans, IMU and wheel samples.

A copy of the port's ``sim/world.py`` (numpy only; the same world, track
and sensor models), without the camera and the moving obstacles, which no
cell uses.  Its streams are noise-free: the benchmark draws the sensors'
noise itself, on the device, with ``noise.add_noise`` (the simulator's own
noise model: IMU acc 0.02, gyro 0.002, a wheel pose 0.0005 m / rad, laser
range 0.005 m), so that every sequence of a fleet gets its own draw.

- wheel odometry: absolute planar poses of the wheel frame,
- IMU: specific force + body rates in the IMU frame (gravity included),
  closed form from the piecewise-constant twist,
- laser: 2D raycasts against the wall segments from the laser extrinsic
  pose (one pose a scan: no per-ray skew).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

G_W = np.array([0.0, 0.0, -9.8])  # world gravity (world = initial wheel frame)


def make_tf_np(p, yaw):
    T = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = [p[0], p[1], 0.0]
    return T


@dataclass
class TwistTrack:
    """Piecewise-constant body twist (v_x, v_y, omega_z) wheel trajectory.

    ``T0`` optionally places the track's start pose in the world (multi-
    robot scenes: each robot's odometry is still relative to its own
    start, but raycast/GT use the world pose)."""

    segments: list  # list of (duration_s, vx, vy, wz)
    T0: np.ndarray = None  # (4,4) world start pose; identity if None

    def total_time(self):
        return sum(s[0] for s in self.segments)

    def pose(self, t: float) -> np.ndarray:
        """Exact wheel pose at time t (closed-form twist integration)."""
        T = np.eye(4) if self.T0 is None else np.asarray(self.T0, np.float64)
        rem = t
        for dur, vx, vy, wz in self.segments:
            dt = min(rem, dur)
            if dt > 0:
                T = T @ _exp_twist2d(vx, vy, wz, dt)
            rem -= dt
            if rem <= 0:
                break
        return T

    def twist(self, t: float):
        """Body twist (v (3,), w (3,)) at time t (left-continuous at
        segment boundaries)."""
        rem = t
        for dur, vx, vy, wz in self.segments:
            if rem <= dur:
                return np.array([vx, vy, 0.0]), np.array([0.0, 0.0, wz])
            rem -= dur
        dur, vx, vy, wz = self.segments[-1]
        return np.array([vx, vy, 0.0]), np.array([0.0, 0.0, wz])

    def poses(self, ts: np.ndarray) -> np.ndarray:
        return np.stack([self.pose(float(t)) for t in ts])


def _exp_twist2d(vx, vy, wz, dt):
    """SE(2) exponential embedded in SE(3)."""
    th = wz * dt
    if abs(wz) < 1e-9:
        p = np.array([vx * dt, vy * dt])
    else:
        # V matrix for SE(2)
        s, c = np.sin(th), np.cos(th)
        # translation = V(theta) @ (v*dt); the th/wz factor folds in the dt
        V = np.array([[s / th, -(1 - c) / th], [(1 - c) / th, s / th]]) * th / wz
        p = V @ np.array([vx, vy])
    return make_tf_np(p, th)


def square_room(size=8.0, obstacles=True, rich=False) -> np.ndarray:
    """Wall segments (S,4) [x1,y1,x2,y2] of a square room w/ L-obstacles
    (gives the corner detector work).  ``rich`` adds box obstacles along
    the walls — an office-like corner density for loop-closure tests."""
    s = size / 2
    segs = [
        (-s, -s, s, -s),
        (s, -s, s, s),
        (s, s, -s, s),
        (-s, s, -s, -s),
    ]
    if obstacles:
        segs += [
            (-s + 1.5, -s + 2.0, -s + 3.0, -s + 2.0),
            (-s + 3.0, -s + 2.0, -s + 3.0, -s + 3.2),
            (s - 2.0, -1.0, s - 2.0, 1.0),
            (s - 2.0, 1.0, s - 3.2, 1.0),
            (-1.0, s - 2.5, 1.2, s - 2.5),
        ]
    if rich:
        # boxes ("desks") hugging each wall, size-scaled
        rng = np.random.default_rng(7)
        n_side = max(2, int(size / 4))
        for wall in range(4):
            for k in range(n_side):
                u = -s + (k + 0.6) * size / (n_side + 0.2) + rng.uniform(-0.3, 0.3)
                w = rng.uniform(0.5, 1.1)
                d = rng.uniform(0.5, 0.9)
                if wall == 0:  # bottom
                    box = (u, -s, u + w, -s + d)
                elif wall == 1:  # right
                    box = (s - d, u, s, u + w)
                elif wall == 2:  # top
                    box = (u, s - d, u + w, s)
                else:  # left
                    box = (-s, u, -s + d, u + w)
                x1, y1, x2, y2 = box
                segs += [
                    (x1, y1, x2, y1),
                    (x2, y1, x2, y2),
                    (x2, y2, x1, y2),
                    (x1, y2, x1, y1),
                ]
    return np.asarray(segs, np.float64)


def corridor_world(length=30.0, width=3.0) -> np.ndarray:
    """A long corridor with alcoves: the loop-closure stress case."""
    w = width / 2
    segs = [
        (0, -w, length, -w),
        (0, w, length, w),
        (0, -w, 0, w),
        (length, -w, length, w),
    ]
    for x in np.arange(4.0, length - 2, 5.0):
        segs += [(x, w, x, w + 0.6), (x, w + 0.6, x + 0.8, w + 0.6), (x + 0.8, w + 0.6, x + 0.8, w)]
    return np.asarray(segs, np.float64)


def raycast(origin_xy, dirs_xy, segments, max_range=30.0, min_range=0.1):
    """Batch 2D raycast.  origin_xy (2,) or (B,2); dirs_xy (B,2) unit;
    segments (S,4).  Returns ranges (B,), inf where no hit."""
    o = np.broadcast_to(np.asarray(origin_xy, np.float64), dirs_xy.shape)
    d = dirs_xy
    a = segments[:, 0:2]
    b = segments[:, 2:4]
    e = b - a  # (S,2)
    # solve o + t d = a + s e : [d, -e][t, s]' = a - o
    dx = d[:, None, 0]
    dy = d[:, None, 1]
    ex = e[None, :, 0]
    ey = e[None, :, 1]
    det = dx * (-ey) - dy * (-ex)  # (B,S)
    rx = a[None, :, 0] - o[:, None, 0]
    ry = a[None, :, 1] - o[:, None, 1]
    safe = np.where(np.abs(det) < 1e-12, 1.0, det)
    t = (rx * (-ey) - ry * (-ex)) / safe
    s = (dx * ry - dy * rx) / safe
    hit = (np.abs(det) > 1e-12) & (t > min_range) & (s >= 0.0) & (s <= 1.0)
    t = np.where(hit, t, np.inf)
    rng = t.min(axis=1)
    return np.where(rng <= max_range, rng, np.inf)




def _exp_twist2d_many(vx, vy, wz, dt):
    """:func:`_exp_twist2d` over arrays of equal length: (n,4,4)."""
    th = wz * dt
    small = np.abs(wz) < 1e-9
    wz_s = np.where(small, 1.0, wz)
    th_s = np.where(np.abs(th) < 1e-12, 1.0, th)
    s, c = np.sin(th), np.cos(th)
    a = np.where(np.abs(th) < 1e-12, 1.0, s / th_s) * th / wz_s
    b = np.where(np.abs(th) < 1e-12, 0.0, (1 - c) / th_s) * th / wz_s
    px = np.where(small, vx * dt, a * vx - b * vy)
    py = np.where(small, vy * dt, b * vx + a * vy)
    T = np.zeros((len(dt), 4, 4))
    T[:, 0, 0], T[:, 0, 1], T[:, 1, 0], T[:, 1, 1] = c, -s, s, c
    T[:, 2, 2] = T[:, 3, 3] = 1.0
    T[:, 0, 3], T[:, 1, 3] = px, py
    return T


def track_poses(track: TwistTrack, ts: np.ndarray) -> np.ndarray:
    """Wheel poses (n,4,4) at times ``ts``: ``track.pose`` for many times at
    once (each segment's start pose composed once)."""
    seg = np.asarray(track.segments, np.float64)
    starts = np.concatenate([[0.0], np.cumsum(seg[:, 0])])
    T = np.eye(4) if track.T0 is None else np.asarray(track.T0, np.float64)
    T_start = [T]
    for dur, vx, vy, wz in seg:
        T = T @ _exp_twist2d(vx, vy, wz, dur)
        T_start.append(T)
    T_start = np.stack(T_start)
    i = np.clip(np.searchsorted(starts, ts, side="right") - 1, 0, len(seg) - 1)
    dt = np.minimum(ts - starts[i], seg[i, 0])
    return T_start[i] @ _exp_twist2d_many(seg[i, 1], seg[i, 2], seg[i, 3], dt)


def track_twists(track: TwistTrack, ts: np.ndarray):
    """Body twists (v (n,3), w (n,3)) at times ``ts`` (left-continuous at
    segment boundaries, as ``track.twist``)."""
    seg = np.asarray(track.segments, np.float64)
    ends = np.cumsum(seg[:, 0])
    i = np.minimum(np.searchsorted(ends, ts, side="left"), len(seg) - 1)
    z = np.zeros(len(ts))
    return np.stack([seg[i, 1], seg[i, 2], z], -1), np.stack([z, z, seg[i, 3]], -1)


def raycast_many(origins, dirs, segments, max_range, scans_a_block=64):
    """:func:`raycast` for many scans: origins (n,2), dirs (n,B,3) with
    their planar norm n2 (the ranges are divided by it, as ``simulate``
    does), in blocks of scans, float64.  Returns ranges (n,B), inf where
    no hit."""
    out = np.empty(dirs.shape[:2])
    a = segments[:, 0:2]
    e = segments[:, 2:4] - a
    for s0 in range(0, len(origins), scans_a_block):
        o = origins[s0 : s0 + scans_a_block][:, None, None, :]
        d3 = dirs[s0 : s0 + scans_a_block]
        n2 = np.linalg.norm(d3[..., :2], axis=-1)
        d = (d3[..., :2] / n2[..., None])[:, :, None, :]
        det = d[..., 0] * (-e[:, 1]) - d[..., 1] * (-e[:, 0])
        rx = a[:, 0] - o[..., 0]
        ry = a[:, 1] - o[..., 1]
        safe = np.where(np.abs(det) < 1e-12, 1.0, det)
        t = (rx * (-e[:, 1]) - ry * (-e[:, 0])) / safe
        s = (d[..., 0] * ry - d[..., 1] * rx) / safe
        hit = (np.abs(det) > 1e-12) & (t > 0.1) & (s >= 0.0) & (s <= 1.0)
        rng = np.where(hit, t, np.inf).min(axis=-1)
        out[s0 : s0 + scans_a_block] = np.where(rng <= max_range, rng, np.inf) / n2
    return out


def simulate_clean(track: TwistTrack, segments, T_iw, T_il, *, imu_hz, wheel_hz, laser_hz, n_beams,
                   duration, max_range=25.0):
    """Noise-free streams of ``duration`` seconds along ``track``: a dict of
    int64 microsecond stamps and float32 samples (``imu_t_us``,
    ``imu_acc``, ``imu_gyro``, ``wheel_t_us``, ``wheel_pose``,
    ``laser_t_us``, ``laser_points`` (n,beams,3) in the laser frame,
    ``laser_hit`` (n,beams), and ``gt_T_w_imu`` (n,4,4) float64).  The
    sensors' phases are the port's simulator's (wheel +3.1 ms, laser
    first at 0.1007 s)."""
    T_iw = np.asarray(T_iw, np.float64)
    T_il = np.asarray(T_il, np.float64)
    T_wi_inv = np.linalg.inv(T_iw)
    r_imu = T_wi_inv[:3, 3]
    R_iw3 = T_iw[:3, :3]
    imu_ts = np.arange(0.0, duration, 1.0 / imu_hz)
    v_b, w_b = track_twists(track, imu_ts)
    Tw = track_poses(track, imu_ts)
    vel_pt = v_b + np.cross(w_b, r_imu[None, :])
    a_w = np.einsum("nij,nj->ni", Tw[:, :3, :3], np.cross(w_b, vel_pt))
    R_w_imu = (Tw @ T_wi_inv)[:, :3, :3]
    acc = np.einsum("nji,nj->ni", R_w_imu, a_w - G_W[None, :])
    gyro = w_b @ R_iw3.T

    wheel_ts = np.arange(0.0, duration, 1.0 / wheel_hz) + 0.0031
    wheel_poses = track_poses(track, wheel_ts)

    laser_ts = np.arange(0.1, duration, 1.0 / laser_hz) + 0.0007
    beams = np.linspace(-np.pi, np.pi, n_beams, endpoint=False)
    d_l = np.stack([np.cos(beams), np.sin(beams), np.zeros(n_beams)], -1)
    Twl = track_poses(track, laser_ts) @ T_wi_inv @ T_il
    rngs = raycast_many(Twl[:, :2, 3], np.einsum("nij,bj->nbi", Twl[:, :3, :3], d_l), segments, max_range)
    hit = np.isfinite(rngs) & (rngs > 0.1)
    pts = (np.where(hit, rngs, 0.0)[..., None] * d_l[None]).astype(np.float32)
    us = lambda x: np.round(np.asarray(x) * 1e6).astype(np.int64)
    return dict(
        imu_t_us=us(imu_ts),
        imu_acc=acc.astype(np.float32),
        imu_gyro=gyro.astype(np.float32),
        wheel_t_us=us(wheel_ts),
        wheel_pose=wheel_poses.astype(np.float32),
        laser_t_us=us(laser_ts),
        laser_points=pts,
        laser_hit=hit,
        gt_T_w_imu=track_poses(track, laser_ts) @ T_wi_inv,
    )
