"""Scan-to-submap line matching and the double-buffered reference submap.

The benchmark's frozen reference copy of the port's ``frontend/matching``.

Port of ``liwslam/frontend/matching.py`` (reference
``laser_manager.cpp:244-348`` ``do_match`` and ``:424-496`` ``add_scan``).
The submap is a fixed-capacity line array; candidate gathering is a dense
(new lines x reference lines) score matrix.  Appends are one scatter, all
branches are ``torch.where`` selects: no host sync.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference import geometry as geo
from benchmark.reference.scan import ScanFeatures

_EPS = 1e-8


class RefSubmap(NamedTuple):
    """Fixed-capacity line submap; lines in the LASER frame of the
    submap's keyframe, whose IMU-frame world pose is (pose_p, pose_q)."""

    p1: torch.Tensor  # (R,3)
    p2: torch.Tensor  # (R,3)
    valid: torch.Tensor  # (R,) bool
    n: torch.Tensor  # () int32 number of stored lines
    pose_p: torch.Tensor  # (3,)
    pose_q: torch.Tensor  # (3,)
    active: torch.Tensor  # () bool


def empty_submap(capacity: int, device="cpu", dtype=torch.float32) -> RefSubmap:
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return RefSubmap(
        p1=z(capacity, 3),
        p2=z(capacity, 3),
        valid=torch.zeros(capacity, dtype=torch.bool, device=device),
        n=torch.zeros((), dtype=torch.int32, device=device),
        pose_p=z(3),
        pose_q=z(3),
        active=torch.zeros((), dtype=torch.bool, device=device),
    )


def submap_from_scan(scan: ScanFeatures, pose_p, pose_q, capacity: int) -> RefSubmap:
    """A submap seeded with one scan's lines (in its own frame)."""
    sub = empty_submap(capacity, scan.p1.device, scan.p1.dtype)
    sub = sub._replace(
        pose_p=pose_p, pose_q=pose_q, active=torch.ones((), dtype=torch.bool, device=scan.p1.device)
    )
    return append_lines(sub, scan.p1, scan.p2, scan.line_valid)


def append_lines(sub: RefSubmap, p1, p2, valid) -> RefSubmap:
    """Append lines (already in the submap's laser frame); overflow drops."""
    cap = sub.p1.shape[0]
    offsets = torch.cumsum(valid.to(torch.int64), 0) - 1
    slot = torch.where(valid, sub.n.to(torch.int64) + offsets, cap)
    slot = torch.clamp(slot, max=cap)  # overflow and invalid rows -> trash
    payload = torch.cat([p1, p2, valid.to(p1.dtype)[:, None]], 1)
    placed = torch.zeros((cap + 1, 7), dtype=p1.dtype, device=p1.device)
    placed = placed.index_put((slot,), payload)[:cap]
    touched = placed[:, 6] > 0.5
    n_new = torch.clamp(sub.n + torch.sum(valid.to(torch.int32)), max=cap)
    return sub._replace(
        p1=torch.where(touched[:, None], placed[:, :3], sub.p1),
        p2=torch.where(touched[:, None], placed[:, 3:6], sub.p2),
        valid=sub.valid | touched,
        n=n_new.to(torch.int32),
    )


class LaserMatch(NamedTuple):
    """Per new line, the matched reference line's endpoints in the
    reference keyframe's laser frame (laser_match, laser_type.h)."""

    ref_p1: torch.Tensor  # (L,3)
    ref_p2: torch.Tensor  # (L,3)
    new_p1: torch.Tensor  # (L,3)
    new_p2: torch.Tensor  # (L,3)
    valid: torch.Tensor  # (L,)
    ref_pose_p: torch.Tensor  # (3,) frozen pose of the reference frame
    ref_pose_q: torch.Tensor  # (3,)

    @property
    def n(self):
        return torch.sum(self.valid.to(torch.int32))


def match_lines(
    ref: RefSubmap,
    scan: ScanFeatures,
    cur_p,
    cur_q,
    T_imu_to_laser,
    *,
    resolution: float,
    kk: int = 0,
    max_angle_deg: float = 10.0,
    mean_dist_k: float = 1.2,
) -> LaserMatch:
    """do_match (laser_manager.cpp:244-348) as a dense score matrix."""
    Til = T_imu_to_laser
    T1 = geo.tf_compose(geo.make_tf(ref.pose_p, ref.pose_q), Til)
    T2 = geo.tf_compose(geo.make_tf(cur_p, cur_q), Til)
    T_1_2 = geo.tf_compose(geo.tf_inv(T1), T2)

    # new lines in the reference laser frame
    q1 = geo.tf_apply(T_1_2, scan.p1)
    q2 = geo.tf_apply(T_1_2, scan.p2)
    mid = 0.5 * (q1 + q2)

    # candidate gate: midpoint near the reference segment (3x3(+kk) cells)
    gate = (1.0 + kk + 0.5) * resolution * math.sqrt(2.0)
    ax, ay = ref.p1[:, 0][None, :], ref.p1[:, 1][None, :]
    abx = (ref.p2[:, 0] - ref.p1[:, 0])[None, :]
    aby = (ref.p2[:, 1] - ref.p1[:, 1])[None, :]
    ab2 = torch.clamp(abx * abx + aby * aby, min=_EPS)
    mx, my = mid[:, 0][:, None], mid[:, 1][:, None]
    t = torch.clamp(((mx - ax) * abx + (my - ay) * aby) / ab2, 0.0, 1.0)
    dx = mx - ax - t * abx
    dy = my - ay - t * aby
    d2_mid = dx * dx + dy * dy
    cand = (d2_mid <= gate * gate) & ref.valid[None, :] & scan.line_valid[:, None]

    # direction angle, argmin over candidates
    v2 = (q2 - q1)[:, :2]
    v1 = (ref.p2 - ref.p1)[:, :2]
    v2n = v2 / torch.clamp(torch.linalg.norm(v2, dim=-1, keepdim=True), min=_EPS)
    v1n = v1 / torch.clamp(torch.linalg.norm(v1, dim=-1, keepdim=True), min=_EPS)
    cosang = torch.abs(geo.matmul(v2n, v1n.T))
    ang = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    ang = torch.where(cand, ang, math.pi)
    best_ang, best = torch.min(ang, 1)
    matched = best_ang < math.radians(max_angle_deg)
    bp1 = ref.p1[best]
    bp2 = ref.p2[best]

    # mean point-to-line distance filter (laser_manager.cpp:315-345)
    dis = 0.5 * (geo.dis_from_line(q1, bp1, bp2) + geo.dis_from_line(q2, bp1, bp2))
    nm = torch.clamp(torch.sum(matched.to(dis.dtype)), min=1.0)
    aver = torch.sum(torch.where(matched, dis, 0.0)) / nm
    # <= + eps: the reference's strict '<' drops all matches when every
    # distance is identical (exact re-observation)
    keep = matched & (dis <= aver * mean_dist_k + 1e-9)
    return LaserMatch(
        ref_p1=bp1,
        ref_p2=bp2,
        new_p1=scan.p1,
        new_p2=scan.p2,
        valid=keep & ref.active,
        ref_pose_p=ref.pose_p,
        ref_pose_q=ref.pose_q,
    )


class SubmapPair(NamedTuple):
    """Double-buffered reference accumulation state of laser_manager."""

    ref: RefSubmap
    spawning: RefSubmap
    count: torch.Tensor  # () int32
    last_add_T: torch.Tensor  # (4,4)


def empty_pair(capacity: int, device="cpu", dtype=torch.float32) -> SubmapPair:
    return SubmapPair(
        ref=empty_submap(capacity, device, dtype),
        spawning=empty_submap(capacity, device, dtype),
        count=torch.zeros((), dtype=torch.int32, device=device),
        last_add_T=torch.eye(4, dtype=dtype, device=device),
    )


def _where_tree(pred, a, b):
    """Field-wise torch.where over (nested) NamedTuples of tensors."""
    return type(a)(
        *[
            _where_tree(pred, x, y) if isinstance(x, tuple) else torch.where(pred, x, y)
            for x, y in zip(a, b)
        ]
    )


def add_scan(
    pair: SubmapPair,
    scan: ScanFeatures,
    cur_p,
    cur_q,
    T_imu_to_laser,
    *,
    ref_n_accumulation: int,
    motion_filter_p: float,
    motion_filter_q: float,
) -> SubmapPair:
    """add_scan (laser_manager.cpp:424-496), branch-free."""
    capacity = pair.ref.p1.shape[0]
    Til = T_imu_to_laser
    cur_T = geo.make_tf(cur_p, cur_q)
    one = torch.ones((), dtype=torch.int32, device=cur_T.device)

    # case A: no reference yet -> seed it with this scan
    fresh = submap_from_scan(scan, cur_p, cur_q, capacity)
    pair_seeded = SubmapPair(ref=fresh, spawning=pair.spawning, count=one, last_add_T=cur_T)

    # motion filter
    dp, dq = geo.log_SE3(geo.tf_compose(geo.tf_inv(pair.last_add_T), cur_T))
    still = (torch.linalg.norm(dp) < motion_filter_p) & (
        torch.linalg.norm(dq) < motion_filter_q
    )

    # case B: accumulate into ref (+ spawning)
    Til_inv = geo.tf_inv(Til)

    def lines_in(sub: RefSubmap):
        l_rel = geo.tf_compose(
            geo.tf_compose(geo.tf_compose(Til_inv, geo.tf_inv(geo.make_tf(sub.pose_p, sub.pose_q))), cur_T), Til
        )
        return geo.tf_apply(l_rel, scan.p1), geo.tf_apply(l_rel, scan.p2)

    a1, a2 = lines_in(pair.ref)
    ref_acc = append_lines(pair.ref, a1, a2, scan.line_valid)
    s1, s2 = lines_in(pair.spawning)
    spawn_acc = _where_tree(
        pair.spawning.active,
        append_lines(pair.spawning, s1, s2, scan.line_valid),
        pair.spawning,
    )
    count = pair.count + 1
    # spawn the half-phase buffer at count == n_acc/2
    spawn_now = ~pair.spawning.active & (count == ref_n_accumulation // 2)
    spawn_acc = _where_tree(spawn_now, fresh, spawn_acc)
    # promote at count == n_acc
    promote = count == ref_n_accumulation
    ref_out = _where_tree(promote, spawn_acc, ref_acc)
    spawn_out = _where_tree(promote, fresh, spawn_acc)
    count = torch.where(promote, ref_n_accumulation // 2, count).to(torch.int32)
    pair_acc = SubmapPair(ref=ref_out, spawning=spawn_out, count=count, last_add_T=cur_T)

    # select: seed / skip / accumulate
    out = _where_tree(pair.ref.active, pair_acc, pair_seeded)
    return _where_tree(pair.ref.active & still, pair, out)
