"""Occupancy-grid map construction from laser keyframes.

The port's own copy of ``liwslam/eval/occupancy.py`` (numpy only).

Reference counterpart: ``visualization::update_occupancy_grid``
(``src/utilies/visualization.cpp:50-75,369-451``): per-ray raycast from
each submap pose marking free cells along the beam and an occupied cell at
the hit.  The reference walks Bresenham steps per ray on the CPU; here the
free-space walk is vectorized as (rays x steps) sample points splatted
into the grid — the same visual artifact, built in one shot.

Output: int8 grid (-1 unknown / 0 free / 100 occupied, ROS
nav_msgs/OccupancyGrid convention) + PGM export for eyeballing.
"""

from __future__ import annotations

import numpy as np


def build_occupancy(
    scans_xy: list,
    origins_xy: np.ndarray,
    resolution: float = 0.05,
    step_fraction: float = 0.9,
    max_range: float = 30.0,
):
    """scans_xy: list of (Ni,2) world-frame hit points per keyframe;
    origins_xy: (K,2) world-frame sensor origins."""
    all_pts = np.concatenate([s for s in scans_xy if len(s)]) if scans_xy else np.zeros((0, 2))
    if len(all_pts) == 0:
        return np.full((1, 1), -1, np.int8), (0.0, 0.0)
    lo = np.minimum(all_pts.min(0), origins_xy.min(0)) - 1.0
    hi = np.maximum(all_pts.max(0), origins_xy.max(0)) + 1.0
    W = int(np.ceil((hi[0] - lo[0]) / resolution)) + 1
    H = int(np.ceil((hi[1] - lo[1]) / resolution)) + 1
    hits = np.zeros((H, W), np.int32)
    passes = np.zeros((H, W), np.int32)

    def to_cell(xy):
        c = np.floor((xy - lo) / resolution).astype(np.int64)
        c[:, 0] = np.clip(c[:, 0], 0, W - 1)
        c[:, 1] = np.clip(c[:, 1], 0, H - 1)
        return c

    for pts, o in zip(scans_xy, origins_xy):
        if len(pts) == 0:
            continue
        d = pts - o
        rng = np.linalg.norm(d, axis=1)
        ok = (rng > 0.05) & (rng < max_range)
        pts = pts[ok]
        d = d[ok]
        rng = rng[ok]
        # free-space samples along each beam at sub-cell spacing
        n_steps = int(np.ceil(rng.max() / (resolution * step_fraction))) if len(rng) else 0
        if n_steps > 0:
            ts = (np.arange(n_steps) + 0.5) / n_steps  # (S,)
            sample = o[None, None, :] + d[:, None, :] * (
                ts[None, :, None] * (rng[:, None, None] - resolution) / rng[:, None, None]
            )
            cells = to_cell(sample.reshape(-1, 2))
            np.add.at(passes, (cells[:, 1], cells[:, 0]), 1)
        hc = to_cell(pts)
        np.add.at(hits, (hc[:, 1], hc[:, 0]), 1)

    grid = np.full((H, W), -1, np.int8)
    seen = (hits + passes) > 0
    occ = hits.astype(np.float64) / np.maximum(hits + passes, 1)
    grid[seen & (occ >= 0.25)] = 100
    grid[seen & (occ < 0.25)] = 0
    return grid, (float(lo[0]), float(lo[1]))


def write_pgm(path, grid):
    """P5 PGM: unknown gray, free white, occupied black."""
    img = np.where(grid < 0, 127, np.where(grid >= 50, 0, 255)).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img[::-1].tobytes())  # y-up
