"""Laser line/corner extraction and de-skew on torch tensors.

Port of ``liwslam/frontend/scan.py`` (the reference's ``spawn_scan``,
laser_manager.cpp:350-422, and the corner spawning of ``scan::add_line``,
laser_manager.cpp:137-191).  The benchmark's frozen reference
copy of the port's ``frontend/scan``: the line stages are the plain
``extract`` module; corner pairing runs here on the compacted
``(max_lines,)`` outputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference import geometry as geo
from benchmark.reference import extract as ext

_EPS = 1e-8


class ScanFeatures(NamedTuple):
    """Lines + corners extracted from one laser sweep (laser_type.h)."""

    p1: torch.Tensor  # (L,3) line start points (laser frame, z=0)
    p2: torch.Tensor  # (L,3) line end points
    line_valid: torch.Tensor  # (L,) bool
    corners: torch.Tensor  # (C,3)
    corner_valid: torch.Tensor  # (C,) bool

    @property
    def n_lines(self):
        return torch.sum(self.line_valid.to(torch.int32))

    @property
    def n_corners(self):
        return torch.sum(self.corner_valid.to(torch.int32))


def extract_features(
    points,
    valid,
    *,
    continuous_threshold: float,
    min_len: float,
    max_dis: float,
    tolerance_angle_rad: float,
    resolution: float,
    max_lines: int,
    max_corners: int,
) -> ScanFeatures:
    """points (N,3) ordered scan points (z ignored); valid (N,) bool."""
    e1, e2, lv, lgap = ext.extract_lines(
        points,
        valid,
        continuous_threshold=continuous_threshold,
        min_len=min_len,
        max_dis=max_dis,
        tolerance_angle_rad=tolerance_angle_rad,
        max_lines=max_lines,
    )
    z = torch.zeros((max_lines, 1), dtype=points.dtype, device=points.device)
    corners, corner_valid = _find_corners(
        e1, e2, lv, resolution, max_corners, end_gap=lgap
    )
    cz = torch.zeros((max_corners, 1), dtype=points.dtype, device=points.device)
    return ScanFeatures(
        p1=torch.cat([e1, z], 1),
        p2=torch.cat([e2, z], 1),
        line_valid=lv,
        corners=torch.cat([corners, cz], 1),
        corner_valid=corner_valid,
    )


def _point_segment_dist(p, a, b):
    """Distance from points p (...,2) to segments (a,b) (...,2)."""
    ab = b - a
    t = torch.sum((p - a) * ab, -1) / torch.clamp(torch.sum(ab * ab, -1), min=_EPS)
    t = torch.clamp(t, 0.0, 1.0)
    proj = a + t[..., None] * ab
    return torch.linalg.norm(p - proj, dim=-1)


def _find_corners(p1, p2, valid, resolution, max_corners, end_gap=None):
    """Intersections of line pairs meeting at 30-150 deg with both segments
    passing near the intersection (scan::add_line corner logic).  The
    nearness gate scales with the beam spacing ``end_gap`` (L,) at each
    line's ends."""
    L = p1.shape[0]
    dev, dtype = p1.device, p1.dtype
    d = p2 - p1
    length = torch.linalg.norm(d, dim=-1)
    dirs = d / torch.clamp(length, min=_EPS)[:, None]
    ang = torch.arccos(torch.clamp(geo.matmul(dirs, dirs.T), -1.0, 1.0))
    ang_ok = (ang > math.radians(30.0)) & (ang < math.radians(150.0))

    # infinite-line intersection via 2x2 solve: n_i . x = n_i . p_i
    nvec = torch.stack([-dirs[:, 1], dirs[:, 0]], -1)
    bvals = torch.sum(nvec * p1, -1)
    A00 = nvec[:, None, 0]
    A01 = nvec[:, None, 1]
    A10 = nvec[None, :, 0]
    A11 = nvec[None, :, 1]
    detA = A00 * A11 - A01 * A10
    b0 = bvals[:, None].expand(L, L)
    b1 = bvals[None, :].expand(L, L)
    safe_det = torch.where(torch.abs(detA) < _EPS, 1.0, detA)
    xi = (b0 * A11 - b1 * A01) / safe_det
    yi = (A00 * b1 - A10 * b0) / safe_det
    X = torch.stack([xi, yi], -1)  # (L,L,2)

    if end_gap is None:
        end_gap = torch.zeros(L, dtype=dtype, device=dev)
    gate = torch.clamp(
        1.6 * torch.maximum(end_gap[:, None], end_gap[None, :]), min=2.0 * resolution
    )
    near_i = _point_segment_dist(X, p1[:, None, :], p2[:, None, :]) <= gate
    near_j = _point_segment_dist(X, p1[None, :, :], p2[None, :, :]) <= gate
    long_ok = (length[:, None] > 0.1) & (length[None, :] > 0.1)
    ar = torch.arange(L, device=dev)
    pair_ok = (
        ang_ok
        & near_i
        & near_j
        & long_ok
        & valid[:, None]
        & valid[None, :]
        & (torch.abs(detA) > _EPS)
        & (ar[:, None] < ar[None, :])
    )
    cv, cpts = ext.compact(pair_ok.reshape(-1), max_corners, X.reshape(-1, 2))
    return cpts, cv


def deskew(points, times_rel, linear, angular):
    """Motion de-skew (sensor::laser::correct, sensor.h:51-94): rotate each
    ray by its per-point time offset under the current twist estimate.
    points (N,3); times_rel (N,) seconds; linear/angular (3,) laser frame."""
    dt = times_rel[:, None]
    w = dt * angular[None, :]
    v = dt * linear[None, :]
    th2 = torch.sum(w * w, -1, keepdim=True)
    th = torch.sqrt(torch.clamp(th2, min=1e-24))
    k = w / th
    c = torch.cos(th)
    s = torch.sin(th)
    kxp = torch.cross(k, points, dim=-1)
    kdp = torch.sum(k * points, -1, keepdim=True)
    rot = points * c + kxp * s + k * kdp * (1.0 - c)
    # tiny angles: first order (matches exp_so3's small-angle guard)
    rot = torch.where(th2 < 1e-12, points + torch.cross(w, points, dim=-1), rot)
    return rot + v
