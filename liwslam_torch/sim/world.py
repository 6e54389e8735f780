"""Synthetic line-world simulator: ground-truth trajectories -> sensor streams.

The port's own copy of ``liwslam/sim/world.py`` (numpy only); the same
seed gives the same streams in both packages.

The reference has no tests and validates against OpenLORIS rosbags
(readme.md:33-39).  This module replaces dataset playback for CI and
benchmarking: a 2D world of wall segments, a piecewise-twist wheel
trajectory, and exact sensor models that produce the same stream format the
OpenLORIS loader emits:

- wheel odometry: absolute planar poses of the wheel frame,
- IMU: specific force + body rates in the IMU frame (gravity included),
  derived by exact central differencing of the analytic pose track,
- laser: 2D raycasts against the wall segments from the laser extrinsic
  pose, optional per-ray motion skew and range noise.

Everything here is host-side float64 numpy (this is data generation, not
the compute path).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

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


@dataclass
class MovingBox:
    """A dynamic obstacle (a person or a cart): an axis-aligned box
    ping-ponging along ``velocity``, ``period`` seconds each way.  Passed
    to :func:`simulate` as one of its ``movers``."""

    center: tuple  # (x, y) at t=0
    size: tuple = (0.5, 0.5)
    velocity: tuple = (0.4, 0.0)  # m/s
    period: float = 4.0  # seconds one way before reversing

    def segments_at(self, t: float) -> np.ndarray:
        phase = t % (2 * self.period)
        tt = phase if phase < self.period else 2 * self.period - phase
        cx = self.center[0] + self.velocity[0] * tt
        cy = self.center[1] + self.velocity[1] * tt
        hw, hh = self.size[0] / 2, self.size[1] / 2
        x1, y1, x2, y2 = cx - hw, cy - hh, cx + hw, cy + hh
        return np.asarray(
            [
                (x1, y1, x2, y1),
                (x2, y1, x2, y2),
                (x2, y2, x1, y2),
                (x1, y2, x1, y1),
            ],
            np.float64,
        )


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


@dataclass
class SimStreams:
    """Packed sensor streams; all times are int64 microseconds from t=0."""

    imu_t_us: np.ndarray  # (Ni,)
    imu_acc: np.ndarray  # (Ni,3) f32
    imu_gyro: np.ndarray  # (Ni,3) f32
    wheel_t_us: np.ndarray  # (Nw,)
    wheel_pose: np.ndarray  # (Nw,4,4) f32
    laser_t_us: np.ndarray  # (Nl,)
    laser_points: np.ndarray  # (Nl,B,3) f32  (laser frame)
    laser_times_rel: np.ndarray  # (Nl,B) f32 per-ray offset from stamp
    laser_valid: np.ndarray  # (Nl,B) bool
    gt_t_us: np.ndarray  # (Nl,)
    gt_T_w_imu: np.ndarray  # (Nl,4,4) f64
    gt_T_w_wheel: np.ndarray  # (Nl,4,4) f64
    # monocular camera (empty unless simulate(..., camera_hz>0) or the
    # loader provides images) — grayscale [0,1] f32
    cam_t_us: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    cam_images: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 1, 1), np.float32)
    )


def wall_landmarks(segments, spacing=0.6, heights=(0.3, 0.9, 1.5), seed=0):
    """3D visual landmarks on the wall segments: points every ``spacing``
    meters along each wall at a few heights, jittered so no two project to
    the same pixel column.  These are what the synthetic camera sees."""
    rng = np.random.default_rng(seed)
    pts = []
    for x1, y1, x2, y2 in np.asarray(segments, np.float64):
        a = np.asarray([x1, y1])
        b = np.asarray([x2, y2])
        L = np.linalg.norm(b - a)
        n = max(2, int(L / spacing) + 1)
        for t in np.linspace(0.0, 1.0, n):
            xy = a * (1 - t) + b * t
            h = rng.choice(heights) + rng.uniform(-0.15, 0.15)
            pts.append([xy[0], xy[1], h])
    return np.asarray(pts, np.float64)


def render_camera(T_w_c, landmarks, intensities, K, w, h, blob_sigma=1.0):
    """Splat 3D landmarks into a grayscale image seen from camera pose
    ``T_w_c`` (4x4 camera-to-world).  Gaussian blobs give the Shi-Tomasi /
    LK tracker well-defined corners to latch onto.  No occlusion model —
    the synthetic camera path validates the tracking/triangulation/factor
    machinery, not photo-realism."""
    T_c_w = np.linalg.inv(T_w_c)
    cam = (T_c_w[:3, :3] @ landmarks.T).T + T_c_w[:3, 3]
    z = cam[:, 2]
    vis = z > 0.2
    u = K[0, 0] * cam[:, 0] / np.where(vis, z, 1.0) + K[0, 2]
    v = K[1, 1] * cam[:, 1] / np.where(vis, z, 1.0) + K[1, 2]
    m = 3  # blob support margin
    vis &= (u >= m) & (u < w - m) & (v >= m) & (v < h - m)
    img = np.zeros((h, w), np.float32)
    r = 3
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    for ui, vi, ii in zip(u[vis], v[vis], intensities[vis]):
        x0, y0 = int(np.floor(ui)), int(np.floor(vi))
        gx = x0 + dx
        gy = y0 + dy
        g = np.exp(
            -(((gx - ui) ** 2 + (gy - vi) ** 2) / (2 * blob_sigma**2))
        )
        img[gy, gx] = np.maximum(img[gy, gx], (ii * g).astype(np.float32))
    return img


def synthetic_camera_K(w, h, hfov_deg=70.0):
    """Pinhole intrinsics for a synthetic camera of the given size."""
    fx = (w / 2) / np.tan(np.radians(hfov_deg) / 2)
    return (fx, 0.0, w / 2, 0.0, fx, h / 2, 0.0, 0.0, 1.0)


def simulate(
    track: TwistTrack,
    segments: np.ndarray,
    params,
    *,
    imu_hz=200.0,
    wheel_hz=20.0,
    laser_hz=10.0,
    n_beams=720,
    fov=2 * np.pi,
    max_range=25.0,
    scan_duration=0.025,
    skew=False,
    noise=False,
    camera_hz=0.0,
    camera_wh=(160, 120),
    movers=(),
    seed=0,
) -> SimStreams:
    rng = np.random.default_rng(seed)
    T_iw = params.mat_T_imu_to_wheel()  # wheel->imu
    T_il = params.mat_T_imu_to_laser()  # laser->imu
    T_wi_inv = np.linalg.inv(T_iw)
    total = track.total_time()

    def T_w_imu(t):
        return track.pose(t) @ T_wi_inv  # world_from_wheel @ wheel_from_imu

    # --- IMU: analytic from the piecewise-constant body twist -----------
    # Finite differencing would produce huge spurious spikes at segment
    # boundaries (velocity steps -> Dirac accelerations); the constant-twist
    # kinematics are closed form instead:
    #   p_imu(t) = T_w_wheel(t) r,  v = R (v_b + w x r),
    #   a = R (w x (v_b + w x r)),  specific force f = R_imu_w^T (a - g_w).
    r_imu = np.linalg.inv(T_iw)[:3, 3]  # imu origin in wheel coords
    R_iw3 = T_iw[:3, :3]  # wheel -> imu coords
    imu_ts = np.arange(0.0, total, 1.0 / imu_hz)
    acc = np.zeros((len(imu_ts), 3))
    gyro = np.zeros((len(imu_ts), 3))
    for i, t in enumerate(imu_ts):
        v_b, w_b = track.twist(t)
        Tw = track.pose(t)
        Rw = Tw[:3, :3]
        vel_pt = v_b + np.cross(w_b, r_imu)
        a_w = Rw @ np.cross(w_b, vel_pt)
        R_w_imu = (Tw @ T_wi_inv)[:3, :3]
        acc[i] = R_w_imu.T @ (a_w - G_W)
        gyro[i] = R_iw3 @ w_b
    if noise:
        acc += rng.normal(0, 0.02, acc.shape)
        gyro += rng.normal(0, 0.002, gyro.shape)

    # --- wheel odometry ---------------------------------------------------
    # phase offset: real sensors are unsynchronized; exactly-tied stamps
    # would be dropped by the dispatcher (dispatch.h:228 keeps only the
    # first message of a tied pair)
    wheel_ts = np.arange(0.0, total, 1.0 / wheel_hz) + 0.0031
    wheel_poses = track.poses(wheel_ts)
    if noise:
        for i in range(len(wheel_poses)):
            wheel_poses[i] = wheel_poses[i] @ make_tf_np(
                rng.normal(0, 0.0005, 2), rng.normal(0, 0.0005)
            )

    # --- laser -------------------------------------------------------------
    laser_ts = np.arange(0.1, total, 1.0 / laser_hz) + 0.0007
    beams = np.linspace(-fov / 2, fov / 2, n_beams, endpoint=False)
    ray_rel = (np.arange(n_beams) / n_beams) * scan_duration
    pts = np.zeros((len(laser_ts), n_beams, 3), np.float32)
    valid = np.zeros((len(laser_ts), n_beams), bool)
    for i, t in enumerate(laser_ts):
        segs_t = (
            segments
            if not movers
            else np.concatenate(
                [segments] + [m.segments_at(float(t)) for m in movers]
            )
        )
        if skew:
            # per-ray pose, vectorized: within a constant-twist segment
            # T(t + dt) = T(t) @ exp(twist * dt) exactly
            v_b, w_b = track.twist(t)
            Tw0 = track.pose(t)
            Tws = np.stack(
                [
                    Tw0 @ _exp_twist2d(v_b[0], v_b[1], w_b[2], max(dt, 1e-9))
                    for dt in ray_rel
                ]
            )
            Twl_all = Tws @ T_wi_inv @ T_il  # (B,4,4) laser poses per ray
            d_l = np.stack([np.cos(beams), np.sin(beams), np.zeros(n_beams)], -1)
            d_w = np.einsum("bij,bj->bi", Twl_all[:, :3, :3], d_l)
            n2 = np.linalg.norm(d_w[:, :2], axis=-1)
            r2 = raycast(Twl_all[:, :2, 3], d_w[:, :2] / n2[:, None], segs_t, max_range)
            rngs = r2 / n2
            Twl0 = T_w_imu(t) @ T_il
        else:
            Twl0 = T_w_imu(t) @ T_il
            d_l = np.stack([np.cos(beams), np.sin(beams), np.zeros(n_beams)], -1)
            d_w = (Twl0[:3, :3] @ d_l.T).T
            n2 = np.linalg.norm(d_w[:, :2], axis=-1)
            r2 = raycast(Twl0[:2, 3], d_w[:, :2] / n2[:, None], segs_t, max_range)
            rngs = r2 / n2
        if noise:
            rngs = rngs + rng.normal(0, 0.005, rngs.shape)
        ok = np.isfinite(rngs) & (rngs > 0.1)
        # points expressed in the laser frame at each ray's own time (what
        # a real scan message contains); deskew is the pipeline's job
        d_l = np.stack([np.cos(beams), np.sin(beams), np.zeros(n_beams)], -1)
        pts[i] = (np.where(ok, rngs, 0.0)[:, None] * d_l).astype(np.float32)
        valid[i] = ok

    gt = np.stack([T_w_imu(t) for t in laser_ts])
    gtw = track.poses(laser_ts)

    us = lambda x: np.round(np.asarray(x) * 1e6).astype(np.int64)

    # --- monocular camera (enable_camera capability; sensor.h:126-146) ----
    cam_ts = np.zeros(0)
    cam_imgs = np.zeros((0, 1, 1), np.float32)
    if camera_hz > 0:
        T_ic = params.mat_T_imu_to_camera()
        K = params.mat_camera_K()
        w_px, h_px = camera_wh
        lms = wall_landmarks(segments, seed=seed)
        lm_int = rng.uniform(0.45, 1.0, len(lms)).astype(np.float32)
        # phase offset like the other sensors (ties are dropped by dispatch)
        cam_ts = np.arange(0.05, total, 1.0 / camera_hz) + 0.0013
        cam_imgs = np.zeros((len(cam_ts), h_px, w_px), np.float32)
        for i, t in enumerate(cam_ts):
            T_w_c = T_w_imu(t) @ T_ic
            cam_imgs[i] = render_camera(T_w_c, lms, lm_int, K, w_px, h_px)
        if noise:
            cam_imgs += rng.normal(0, 0.01, cam_imgs.shape).astype(np.float32)
            cam_imgs = np.clip(cam_imgs, 0.0, 1.0)
    return SimStreams(
        imu_t_us=us(imu_ts),
        imu_acc=acc.astype(np.float32),
        imu_gyro=gyro.astype(np.float32),
        wheel_t_us=us(wheel_ts),
        wheel_pose=wheel_poses.astype(np.float32),
        laser_t_us=us(laser_ts),
        laser_points=pts,
        # unskewed scans carry zero per-ray offsets so the pipeline's
        # de-skew is a no-op on them (it must only undo real skew)
        laser_times_rel=np.tile(
            (ray_rel if skew else np.zeros_like(ray_rel)).astype(np.float32),
            (len(laser_ts), 1),
        ),
        laser_valid=valid,
        gt_t_us=us(laser_ts),
        gt_T_w_imu=gt,
        gt_T_w_wheel=gtw,
        cam_t_us=us(cam_ts),
        cam_images=cam_imgs,
    )


def default_track(kind="loop") -> TwistTrack:
    """Canonical test tracks.  'loop' returns to the start (loop closure);
    'L' is a simple two-leg run; 'static_start' begins with a pause."""
    if kind == "loop":
        return TwistTrack(
            [
                (2.0, 0.0, 0.0, 0.0),  # static start (init gate)
                (6.0, 0.4, 0.0, 0.0),
                (3.5, 0.3, 0.0, np.pi / 2 / 3.5),
                (6.0, 0.4, 0.0, 0.0),
                (3.5, 0.3, 0.0, np.pi / 2 / 3.5),
                (6.0, 0.4, 0.0, 0.0),
                (3.5, 0.3, 0.0, np.pi / 2 / 3.5),
                (6.0, 0.4, 0.0, 0.0),
                (3.5, 0.3, 0.0, np.pi / 2 / 3.5),
            ]
        )
    if kind == "smallloop":
        # compact square circuit (~20 s): fits CI budgets, still closes
        leg = [(3.5, 0.35, 0.0, 0.0), (2.6, 0.25, 0.0, np.pi / 2 / 2.6)]
        return TwistTrack([(2.0, 0.0, 0.0, 0.0)] + leg * 4)
    if kind == "L":
        return TwistTrack(
            [
                (2.0, 0.0, 0.0, 0.0),
                (5.0, 0.3, 0.0, 0.0),
                (2.0, 0.2, 0.0, np.pi / 2 / 2.0),
                (5.0, 0.3, 0.0, 0.0),
            ]
        )
    raise ValueError(kind)
