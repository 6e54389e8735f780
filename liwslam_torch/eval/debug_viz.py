"""Debug rendering for real-data bring-up (the reference's rviz/OpenCV
overlays, file-based).

Reference counterparts: per-frame matched-line markers and camera feature
overlays (``src/trajectory/trajectory.cpp:625-687``), merged keyframe-scan
renderings around loop candidates (``src/trajectory/keyframe_manager.cpp:
114-338``), and the rviz marker suite (``src/utilies/visualization.cpp``).
The port has no ROS; these render straight to PNG (PIL) / PPM (fallback) so
a real-sequence failure can be debugged frame by frame from files.

All rasterization is plain numpy (host-side debug path, not device code).
The port's own copy of ``liwslam/eval/debug_viz.py``.
"""

from __future__ import annotations

import os

import numpy as np

# color palette (RGB uint8)
C_SCAN = (90, 90, 90)
C_LINE = (0, 160, 255)
C_REF = (0, 220, 120)
C_MATCH = (255, 80, 80)
C_CORNER = (255, 200, 0)
C_TRAJ_A = (120, 120, 255)
C_TRAJ_B = (255, 120, 120)
C_LOOP = (255, 0, 255)


def save_image(path, img):
    """img: (H,W,3) uint8.  PNG via PIL; PPM if PIL is unavailable."""
    try:
        from PIL import Image

        Image.fromarray(img).save(path)
    except ImportError:  # pragma: no cover
        root, _ = os.path.splitext(path)
        with open(root + ".ppm", "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
            f.write(img.tobytes())


class Canvas:
    """World-frame raster: meters -> pixels, y-up."""

    def __init__(self, xy_min, xy_max, resolution=0.02, pad=1.0):
        self.res = float(resolution)
        self.x0 = float(xy_min[0]) - pad
        self.y0 = float(xy_min[1]) - pad
        w = int((float(xy_max[0]) + pad - self.x0) / self.res) + 1
        h = int((float(xy_max[1]) + pad - self.y0) / self.res) + 1
        w = min(max(w, 8), 4096)
        h = min(max(h, 8), 4096)
        self.img = np.full((h, w, 3), 20, np.uint8)

    @classmethod
    def fit(cls, pts_list, resolution=0.02, pad=1.0):
        allp = np.concatenate([np.asarray(p).reshape(-1, 2) for p in pts_list if len(p)])
        return cls(allp.min(0), allp.max(0), resolution, pad)

    def _px(self, xy):
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        u = ((xy[:, 0] - self.x0) / self.res).astype(np.int64)
        v = self.img.shape[0] - 1 - ((xy[:, 1] - self.y0) / self.res).astype(np.int64)
        return u, v

    def points(self, xy, color, size=0):
        if len(xy) == 0:
            return
        u, v = self._px(xy)
        H, W = self.img.shape[:2]
        for du in range(-size, size + 1):
            for dv in range(-size, size + 1):
                uu = np.clip(u + du, 0, W - 1)
                vv = np.clip(v + dv, 0, H - 1)
                self.img[vv, uu] = color

    def lines(self, p1, p2, color):
        """Draw segments by dense sampling (vectorized; debug fidelity)."""
        p1 = np.asarray(p1, np.float64).reshape(-1, 2)
        p2 = np.asarray(p2, np.float64).reshape(-1, 2)
        if len(p1) == 0:
            return
        L = np.linalg.norm(p2 - p1, axis=-1)
        n = np.maximum(2, (L / self.res * 1.5).astype(np.int64))
        for a, b, k in zip(p1, p2, n):
            t = np.linspace(0.0, 1.0, min(int(k), 4000))[:, None]
            self.points(a[None] * (1 - t) + b[None] * t, color)


def transform_lines(p1, p2, T):
    """Apply a (4,4) pose to (n,3)/(n,2) line endpoints; returns 2D."""
    def ap(p):
        p = np.asarray(p, np.float64)
        if p.shape[-1] == 2:
            p = np.concatenate([p, np.zeros_like(p[:, :1])], -1)
        return (T[:3, :3] @ p.T).T[:, :2] + T[:2, 3]

    return ap(p1), ap(p2)


def render_frame_matches(
    path,
    scan_pts_xy,
    line_p1,
    line_p2,
    corners_xy,
    ref_p1,
    ref_p2,
    match_new_p1,
    match_new_p2,
    match_ref_p1,
    match_ref_p2,
    resolution=0.02,
):
    """Per-frame extraction + matching overlay (trajectory.cpp:625-687
    equivalent): raw scan (grey), extracted lines (blue), corners
    (yellow), reference submap lines (green), matched pairs connected by
    red midpoint segments.  All inputs in ONE common frame."""
    cv = Canvas.fit(
        [scan_pts_xy, line_p1, line_p2, ref_p1, ref_p2], resolution=resolution
    )
    cv.points(scan_pts_xy, C_SCAN)
    cv.lines(ref_p1, ref_p2, C_REF)
    cv.lines(line_p1, line_p2, C_LINE)
    if len(match_new_p1):
        mid_new = 0.5 * (np.asarray(match_new_p1) + np.asarray(match_new_p2))
        mid_ref = 0.5 * (np.asarray(match_ref_p1) + np.asarray(match_ref_p2))
        cv.lines(mid_new[:, :2], mid_ref[:, :2], C_MATCH)
    cv.points(corners_xy, C_CORNER, size=2)
    save_image(path, cv.img)
    return cv.img


def render_merged_scans(path, kf_scans_world, colors=None, resolution=0.03):
    """Merged keyframe scans (keyframe_manager.cpp:114-338 equivalent):
    each entry is (p1 (n,2), p2 (n,2)) already in the world frame."""
    allp = []
    for p1, p2 in kf_scans_world:
        allp += [p1, p2]
    if not allp:
        return None
    cv = Canvas.fit(allp, resolution=resolution)
    for k, (p1, p2) in enumerate(kf_scans_world):
        c = colors[k] if colors is not None else C_LINE
        cv.lines(p1, p2, c)
    save_image(path, cv.img)
    return cv.img


def render_trajectories(path, trajs, loop_pairs=None, resolution=0.03):
    """Trajectory map: ``trajs`` = list of ((n,2) xy, color); optional
    loop edges as ((2,) xy, (2,) xy) pairs in magenta."""
    cv = Canvas.fit([t for t, _ in trajs], resolution=resolution)
    for xy, c in trajs:
        xy = np.asarray(xy)
        if len(xy) > 1:
            cv.lines(xy[:-1], xy[1:], c)
    if loop_pairs:
        a = np.stack([p[0] for p in loop_pairs])
        b = np.stack([p[1] for p in loop_pairs])
        cv.lines(a, b, C_LOOP)
    save_image(path, cv.img)
    return cv.img


def render_camera_tracks(path, img_gray, px, live, reproj_px=None, reproj_ok=None):
    """Camera feature overlay (show_lastest_image, trajectory.cpp:625-687):
    tracked features as red squares, landmark reprojections green."""
    g = np.clip(np.asarray(img_gray) * 255, 0, 255).astype(np.uint8)
    img = np.stack([g, g, g], -1)
    H, W = g.shape

    def mark(uv, ok, color, size):
        uv = np.asarray(uv)
        for (u, v), m in zip(uv, np.asarray(ok)):
            if not m:
                continue
            u0, v0 = int(round(u)), int(round(v))
            if 0 <= u0 < W and 0 <= v0 < H:
                img[
                    max(v0 - size, 0) : v0 + size + 1,
                    max(u0 - size, 0) : u0 + size + 1,
                ] = color

    mark(px, live, (255, 80, 80), 2)
    if reproj_px is not None:
        mark(reproj_px, reproj_ok, (0, 220, 120), 1)
    save_image(path, img)
    return img
