"""The fleet: S distinct tracks simulated from the seed, each packed and its
init window solved once by the program, and B sequences that replay them
with noise of their own.

Every cell builds its traffic here, from three files: the configuration
(``configs/<config>.json``: the world, the tracks, the sensors and their
noise, the program's parameters), the traffic mix (``traffic/<mix>.json``:
B, S, frames, the chunk) and the seed.  The same seed gives the
same tracks, the same init frames and the same replicas' noise.

- Tracks: ``track.kind`` ``"loop"`` is laps of the port's simulator's loop
  track (a static start, four legs and four quarter turns), its speeds
  scaled by a factor drawn from ``track.speed_scale`` and its turns left or
  right; ``"shuttle"`` runs a corridor's length at a speed drawn from
  ``track.speed``, from a start drawn along it, with a U-turn at each end.
- Packing: the laser frames' intervals get the IMU and wheel samples
  stamped in them, padded to the configuration's widths (the port's
  ``Frontend.pack_frames`` for offline streams).
- Noise: :func:`add_noise` draws the simulator's noise model on packed
  frames, on the device, with a ``torch.Generator`` seeded from the seed:
  once for each track's init window, and once for each of the B sequences
  after it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.harness import sim

FIELDS = (
    "dt_us", "imu_acc", "imu_gyro", "imu_t_us", "imu_mask", "wheel_pose", "wheel_t_us", "wheel_mask",
    "points", "point_valid", "ray_t",
)


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one stream of draws, from the run's seed and the
    stream's path (track s, replica block, ...)."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), *[int(p) for p in path]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


# ---------------------------------------------------------------- tracks ----


def make_track(cfg: dict, rng: np.random.Generator, duration: float) -> sim.TwistTrack:
    """One distinct track of at least ``duration`` seconds, drawn by ``rng``
    from the configuration's ``track`` block."""
    tk = cfg["track"]
    static = float(tk["static_s"])
    if tk["kind"] == "loop":
        u = rng.uniform(*tk["speed_scale"])
        turn = 1.0 if rng.random() < 0.5 else -1.0
        lap = [(6.0, 0.4 * u, 0.0, 0.0), (3.5, 0.3 * u, 0.0, turn * np.pi / 2 / 3.5)] * 4
        segs = [(static, 0.0, 0.0, 0.0)]
        while sum(s[0] for s in segs) < duration:
            segs += lap
        return sim.TwistTrack(segs)
    if tk["kind"] == "shuttle":
        length, width = cfg["world"]["length"], cfg["world"]["width"]
        v = rng.uniform(*tk["speed"])
        r = float(tk["turn_radius"])
        margin = float(tk["end_margin"])
        # the two legs lie r either side of the track's centre line; a
        # left U-turn at each end joins them
        y_c = rng.uniform(-tk["lateral"], tk["lateral"])
        if abs(y_c) + r > width / 2 - 0.3 or margin < r + 0.5:
            raise ValueError("track: a U-turn leaves the corridor; lower turn_radius or lateral")
        x0 = rng.uniform(*tk["start_x"])
        T0 = sim.make_tf_np([x0, y_c - r], 0.0)
        turn = (np.pi * r / v, v, 0.0, v / r)
        full = length - 2 * margin
        segs = [(static, 0.0, 0.0, 0.0), ((length - margin - x0) / v, v, 0.0, 0.0), turn]
        while sum(s[0] for s in segs) < duration:
            segs += [(full / v, v, 0.0, 0.0), turn]
        return sim.TwistTrack(segs, T0=T0)
    raise ValueError(f"track kind {tk['kind']!r}")


def make_world(cfg: dict) -> np.ndarray:
    w = cfg["world"]
    if w["kind"] == "square_room":
        return sim.square_room(w["size"], obstacles=w["obstacles"], rich=w["rich"])
    if w["kind"] == "corridor":
        return sim.corridor_world(w["length"], w["width"])
    raise ValueError(f"world kind {w['kind']!r}")


# --------------------------------------------------------------- packing ----


def pack(streams: dict, prm) -> dict:
    """Clean streams -> packed frames: a dict of numpy arrays with a leading
    frame dim (``FIELDS``; ``point_valid`` is the raycast's hit mask, which
    :func:`add_noise` turns into the scan's valid points) and ``stamps``
    (F,) int64."""
    lt = streams["laser_t_us"]
    it, wt = streams["imu_t_us"], streams["wheel_t_us"]
    I, Wh, N = prm["max_imu_per_frame"], prm["max_wheel_per_frame"], prm["max_points"]
    F, beams = len(lt), streams["laser_points"].shape[1]
    if beams > N:
        raise ValueError(f"{beams} beams > max_points {N}")
    out = {
        "dt_us": np.zeros(F, np.int32),
        "imu_acc": np.zeros((F, I, 3), np.float32),
        "imu_gyro": np.zeros((F, I, 3), np.float32),
        "imu_t_us": np.zeros((F, I), np.int32),
        "imu_mask": np.zeros((F, I), bool),
        "wheel_pose": np.tile(np.eye(4, dtype=np.float32), (F, Wh, 1, 1)),
        "wheel_t_us": np.zeros((F, Wh), np.int32),
        "wheel_mask": np.zeros((F, Wh), bool),
        "points": np.zeros((F, N, 3), np.float32),
        "point_valid": np.zeros((F, N), bool),
        "ray_t": np.zeros((F, N), np.float32),
    }
    prev = 0
    for k in range(F):
        t0, t1 = prev, int(lt[k])
        si = np.flatnonzero((it > t0) & (it <= t1))
        sw = np.flatnonzero((wt > t0) & (wt <= t1))
        if len(si) > I or len(sw) > Wh:
            raise ValueError(f"frame {k}: {len(si)} IMU / {len(sw)} wheel samples exceed {I} / {Wh}")
        out["dt_us"][k] = t1 - t0
        out["imu_acc"][k, : len(si)] = streams["imu_acc"][si]
        out["imu_gyro"][k, : len(si)] = streams["imu_gyro"][si]
        out["imu_t_us"][k, : len(si)] = it[si] - t0
        out["imu_mask"][k, : len(si)] = True
        out["wheel_pose"][k, : len(sw)] = streams["wheel_pose"][sw]
        out["wheel_t_us"][k, : len(sw)] = wt[sw] - t0
        out["wheel_mask"][k, : len(sw)] = True
        prev = t1
    out["points"][:, :beams] = streams["laser_points"]
    out["point_valid"][:, :beams] = streams["laser_hit"]
    out["stamps"] = np.asarray(lt, np.int64)
    return out


# ----------------------------------------------------------------- noise ----


def add_noise(frames: dict, noise: dict, gen: torch.Generator) -> dict:
    """The simulator's noise model drawn on packed clean frames (tensors
    with any leading dims, on ``gen``'s device): IMU acc and gyro white
    noise, each wheel pose moved by a planar (x, y, yaw) draw, each ray's
    range moved along the ray; then the scan's valid points as the port's
    packer keeps them (``frontend.driver.clean_scan``: a range of at least 0.1 m and
    no point within 1 cm of its predecessor).  Returns new tensors."""
    out = dict(frames)
    normal = lambda like, s: torch.randn(like.shape, generator=gen, device=like.device, dtype=like.dtype) * s
    im = frames["imu_mask"][..., None]
    out["imu_acc"] = frames["imu_acc"] + normal(frames["imu_acc"], noise["acc"]) * im
    out["imu_gyro"] = frames["imu_gyro"] + normal(frames["imu_gyro"], noise["gyro"]) * im
    wp = frames["wheel_pose"]
    wm = frames["wheel_mask"].to(wp.dtype)
    dx = normal(wp[..., 0, 3], noise["wheel_xy"]) * wm
    dy = normal(wp[..., 0, 3], noise["wheel_xy"]) * wm
    dth = normal(wp[..., 0, 3], noise["wheel_yaw"]) * wm
    c, s = torch.cos(dth), torch.sin(dth)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    dT = torch.stack(
        [torch.stack(r, -1) for r in ((c, -s, z, dx), (s, c, z, dy), (z, z, o, z), (z, z, z, o))], -2
    )
    out["wheel_pose"] = torch.sum(wp[..., :, :, None] * dT[..., None, :, :], -2)
    pts, hit = frames["points"], frames["point_valid"]
    r = torch.linalg.norm(pts[..., :2], dim=-1)
    rn = r + normal(r, noise["range"])
    scale = torch.where(hit, rn / torch.clamp(r, min=1e-6), 0.0)
    pts = pts * scale[..., None]
    ok = hit & (rn >= 0.1)
    gap = torch.linalg.norm(pts[..., 1:, :2] - pts[..., :-1, :2], dim=-1)
    ok = torch.cat([ok[..., :1], ok[..., 1:] & ((gap >= 0.01) | ~ok[..., :-1])], -1)
    out["points"] = torch.where(ok[..., None], pts, 0.0)
    out["point_valid"] = ok
    return out


# ----------------------------------------------------------------- fleet ----


@dataclass
class Track:
    """One distinct track: its packed clean frames (numpy), the noisy frames
    its init window ran on (numpy), and the program's init result."""

    clean: dict
    init_frames: dict
    first: int  # first tracked frame
    state: object  # the program's TrackState after the init window (device)


def simulate_tracks(cfg: dict, mix: dict, seed: int, n_frames: int) -> list:
    """The mix's S distinct tracks, simulated and packed: each long enough
    for its init window (``mix["init_frames_max"]`` frames at most) and
    ``n_frames`` tracked frames after it."""
    prm, sens = cfg["params"], cfg["sensors"]
    world = make_world(cfg)
    T_iw = np.asarray(prm["T_imu_to_wheel"], np.float64).reshape(4, 4)
    T_il = np.asarray(prm["T_imu_to_laser"], np.float64).reshape(4, 4)
    duration = (n_frames + mix["init_frames_max"]) / sens["laser_hz"] + 0.5
    out = []
    for s in range(mix["tracks"]):
        rng = np.random.default_rng(sub_seed(seed, 1, s))
        track = make_track(cfg, rng, duration)
        streams = sim.simulate_clean(
            track, world, T_iw, T_il, imu_hz=sens["imu_hz"], wheel_hz=sens["wheel_hz"],
            laser_hz=sens["laser_hz"], n_beams=sens["n_beams"], duration=duration,
        )
        out.append(pack(streams, prm))
    return out


def to_tensors(frames: dict, device) -> dict:
    return {k: torch.as_tensor(frames[k]).to(device) for k in FIELDS}


def noisy_init_frames(clean: dict, cfg: dict, seed: int, s: int, device) -> dict:
    """Track s's frames with the noise its init window runs on (numpy)."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2, s))
    noisy = add_noise(to_tensors(clean, device), cfg["noise"], gen)
    return {k: noisy[k].cpu().numpy() for k in FIELDS}


def frame_list(frames: dict, input_type) -> list:
    """Packed frames (numpy, leading frame dim) as a list of ``input_type``
    (a ``FrameInput``) of numpy arrays, one a frame."""
    n = len(frames["dt_us"])
    return [input_type(*[frames[k][i] for k in FIELDS]) for i in range(n)]


def replica_inputs(tracks: list, B: int, n_frames: int, offset: int, cfg: dict, seed: int, device) -> dict:
    """B sequences' inputs (tensors of (B, n_frames, ...), on ``device``):
    sequence b replays track b mod S from its frame ``first + offset``,
    with noise of its own.  Noise is drawn in blocks of sequences, each
    block from a generator of its own."""
    S = len(tracks)
    src = {}
    for k in FIELDS:
        rows = [torch.as_tensor(t.clean[k][t.first + offset :][:n_frames]) for t in tracks]
        if any(r.shape[0] < n_frames for r in rows):
            raise ValueError(f"a track has fewer than {n_frames} frames after its init window")
        src[k] = torch.stack(rows).to(device)
    out = {k: torch.empty((B,) + v.shape[1:], dtype=v.dtype, device=device) for k, v in src.items()}
    block = 256
    for b0 in range(0, B, block):
        idx = torch.arange(b0, min(B, b0 + block), device=device) % S
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 3, b0))
        noisy = add_noise({k: v.index_select(0, idx) for k, v in src.items()}, cfg["noise"], gen)
        for k in FIELDS:
            out[k][b0 : b0 + len(idx)] = noisy[k]
    return out
