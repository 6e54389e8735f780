"""Corner-constellation loop detection (global feature-point matching).

Port of ``liwslam/backend/loop.py`` (the reference's ``laser_map_feature``
and loop-detection path, ``src/trajectory/keyframe_manager.cpp:898-1183``):

- each descriptor map collects the deduplicated accumulated corners of the
  last ``submap_count`` laser keyframes (dedup: merge closer than d_res/2,
  drop closer than 5*d_res — keyframe_manager.cpp:955-981),
- per corner i: the (angle a_ij, quantized distance d_ij) to every other
  corner, plus a bitmap over distance bins for a popcount prefilter
  (``quick_des``),
- match_des: distance-equality join with rotation-consistency voting into
  an angle-difference histogram; the largest consistent set wins, with at
  most one vote per left-hand neighbour and rotation bin,
- the winning correspondence set feeds a closed-form planar Kabsch fit.

Where the work runs:

- The dedup is a sequential scan whose every step depends on the first
  earlier kept corner within reach.  It runs on the host in float32 numpy
  with the operations and order of the reference's device scan
  (:func:`dedup_corners_device`), on every device: the corners come from
  the host anyway, and a scan of up to N = 512 steps on the card would be
  thousands of tiny launches and a host wait per keyframe.  Only the kept
  (P,3) corners cross to the device.
- The pairwise distances, angles and distance bitmap are built on the
  tensors' device (:func:`build_map_feature_device`).
- :func:`score_pairs` runs on the device: for each (probe i, candidate j)
  pair a (P,P) distance-equality mask and rotation bins, the distinct
  (neighbour, bin) votes scattered into a presence table, the histogram
  summed from it.  Pairs are processed in chunks sized so the
  intermediates stay within a fixed memory budget.
- Correspondence extraction, Kabsch and overlap verification are host
  numpy, as in the reference.

Bitmaps are int32 tensors holding the reference's uint32 bits; popcounts
are taken in int64 on the low 32 bits.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from liwslam_torch import resolve_device


class MapFeature(NamedTuple):
    """Fixed-capacity descriptor map (laser_map_feature); tensors on one
    device, with an optional leading batch dim (candidate maps)."""

    points: torch.Tensor  # (P,3) f32 corner positions (tracking frame)
    valid: torch.Tensor  # (P,) bool
    dist_q: torch.Tensor  # (P,P) int32 quantized pair distances
    ang: torch.Tensor  # (P,P) f32 pair angles in [0, 2pi)
    bitmap: torch.Tensor  # (P,NW) int32: the uint32 distance-bin bitmap's bits
    origin: torch.Tensor  # (4,4) f32 tracking pose of the newest laser keyframe
    index: int  # keyframe index of the newest laser keyframe


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _f32(v):
    """A Python float that float32 represents exactly: the value JAX's weak
    typing gives a Python constant against a float32 array."""
    return float(np.float32(v))


def _recip(v):
    """float32's 1 / float32(v) as a Python float.  The reference's jitted
    descriptor and scoring programs divide by a Python constant, which XLA
    compiles as a multiply by this reciprocal; multiplying by it gives the
    same float32 results on every device."""
    return float(np.float32(1) / np.float32(v))


def dedup_corners(corner_sets, d_res, capacity, seed=0):
    """Merge/drop near-duplicate corners (keyframe_manager.cpp:955-981),
    keep the first ``capacity`` in insertion order, then shuffle by
    ``seed``.  Host numpy, float64 (the host oracle)."""
    pts: list = []
    for cs in corner_sets:
        for c in np.asarray(cs).reshape(-1, 3):
            dup = False
            for k in range(len(pts)):
                d = np.linalg.norm((c - pts[k])[:2])
                if d < d_res / 2:
                    pts[k] = (pts[k] * 3 + c) / 4
                if d < d_res * 5:
                    dup = True
                    break
            if not dup:
                pts.append(c.astype(np.float64))
    pts = np.asarray(pts, np.float64).reshape(-1, 3)[:capacity]
    rng = np.random.default_rng(seed)
    return pts[rng.permutation(len(pts))]


def _pairwise(pad, valid, d_res, n_dist_bins):
    """(dist_q, ang, bitmap) of (P,3) corners on their device."""
    P = pad.shape[0]
    v = pad[None, :, :2] - pad[:, None, :2]  # (P,P,2)
    dist = torch.sqrt(torch.sum(v * v, -1) + 1e-20)
    dist_q = torch.floor(dist * _recip(d_res) + 0.5).to(torch.int32)
    ang = torch.atan2(v[..., 1], v[..., 0])
    ang = torch.where(ang < 0, ang + _f32(2 * math.pi), ang)
    NW = (n_dist_bins + 31) // 32
    eye = torch.eye(P, dtype=torch.bool, device=pad.device)
    pair_ok = valid[:, None] & valid[None, :] & ~eye & (dist_q < n_dist_bins)
    # presence of each distance bin in each row (a dummy column takes the
    # pairs that do not count), packed 32 bins a word
    col = torch.where(pair_ok, dist_q, NW * 32).to(torch.int64)
    present = torch.zeros((P, NW * 32 + 1), dtype=torch.bool, device=pad.device)
    present.scatter_(1, col, True)
    bits = present[:, : NW * 32].reshape(P, NW, 32).to(torch.int64)
    shifts = torch.arange(32, device=pad.device, dtype=torch.int64)
    words = torch.sum(bits << shifts, -1)
    bitmap = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return dist_q, ang, bitmap


def build_map_feature(corner_sets, origin, index, *, d_res, capacity, n_dist_bins, seed=0, device="cuda"):
    """Descriptor construction (keyframe_manager.cpp:985-1017), the host
    oracle: numpy throughout, then copied to ``device``."""
    pts = dedup_corners(corner_sets, d_res, capacity, seed)
    P = capacity
    n = len(pts)
    pad = np.zeros((P, 3), np.float32)
    pad[:n] = pts
    valid = np.arange(P) < n

    v = pad[None, :, :2] - pad[:, None, :2]  # (P,P,2)
    dist = np.linalg.norm(v, axis=-1)
    dist_q = np.floor(dist / d_res + 0.5).astype(np.int32)  # round() int cast
    # f(v_ij): angle from +x, in [0, 2pi) (keyframe_manager.cpp:933-940)
    ang = np.arctan2(v[..., 1], v[..., 0])
    ang = np.where(ang < 0, ang + 2 * np.pi, ang).astype(np.float32)

    NW = (n_dist_bins + 31) // 32
    bitmap = np.zeros((P, NW), np.uint32)
    pair_ok = valid[:, None] & valid[None, :] & ~np.eye(P, dtype=bool)
    for i in range(n):
        bins = dist_q[i][pair_ok[i]]
        bins = bins[bins < n_dist_bins]
        # unbuffered OR: fancy-index |= silently drops duplicate word indices
        np.bitwise_or.at(bitmap[i], bins // 32, np.uint32(1) << (bins % 32).astype(np.uint32))

    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    return MapFeature(
        points=t(pad), valid=t(valid), dist_q=t(dist_q), ang=t(ang), bitmap=t(bitmap.view(np.int32)),
        origin=t(np.asarray(origin, np.float32)), index=int(index),
    )


def dedup_corners_device(pts, mask, d_res, capacity):
    """The reference's device dedup (one ``lax.scan`` over candidates) with
    its exact float32 operations and order, run on the host: scan the
    corners in order; the FIRST kept corner within 5*d_res absorbs the
    candidate, blending 3:1 when within d_res/2; a corner that hits none is
    kept while fewer than ``capacity`` are.

    pts: (N,3); mask: (N,).  Returns (kept (capacity,3) float32 numpy,
    n_kept int)."""
    pts = np.asarray(pts, np.float32)
    mask = np.asarray(mask, bool)
    kept = np.zeros((capacity, 3), np.float32)
    reach, blend = np.float32(5.0 * d_res), np.float32(d_res / 2)
    three, four, tiny = np.float32(3), np.float32(4), np.float32(1e-20)
    n = 0
    for c, m in zip(pts, mask):
        if not m:
            continue
        dxy = kept[:n, :2] - c[None, :2]
        d = np.sqrt(np.sum(dxy * dxy, -1) + tiny)
        hit = np.flatnonzero(d < reach)
        if len(hit):
            k = hit[0]
            if d[k] < blend:
                kept[k] = (kept[k] * three + c) / four
        elif n < capacity:
            kept[n] = c
            n += 1
    return kept, n


def build_map_feature_device(pts, mask, origin, *, d_res, capacity, n_dist_bins, perm=None, device="cuda"):
    """Descriptor map of a keyframe's corner window: the host dedup
    (:func:`dedup_corners_device`), then :func:`map_feature_from_kept`
    (keyframe_manager.cpp:985-1017).  ``index`` is left at -1 for the
    caller to set."""
    kept, n = dedup_corners_device(pts, mask, d_res, capacity)
    return map_feature_from_kept(kept, n, origin, d_res=d_res, n_dist_bins=n_dist_bins, perm=perm, device=device)


def map_feature_from_kept(kept, n, origin, *, d_res, n_dist_bins, perm=None, device="cuda"):
    """MapFeature of the first ``n`` of the (P,3) deduplicated corners: one
    host-to-device copy, then the pairwise distances, angles and bitmap on
    ``device``.  ``perm`` (P,) random keys reproduce the reference's
    random_shuffle of the kept corners (valid slots sort by their key,
    invalid ones to the end); None keeps insertion order."""
    dev = resolve_device(device)
    capacity = len(kept)
    valid = np.arange(capacity) < n
    if perm is not None:
        keys = np.asarray(perm, np.int64) + np.where(valid, 0, 2 * capacity)
        order = np.argsort(keys, kind="stable")
        kept, valid = kept[order], valid[order]
    # one host-to-device copy: corners, valid flags and the origin
    host = np.zeros((capacity, 4 + 16), np.float32)
    host[:, :3] = np.where(valid[:, None], kept, np.float32(0))
    host[:, 3] = valid
    host[0, 4:] = np.asarray(origin, np.float32).reshape(16)
    buf = torch.as_tensor(host).to(dev)
    pad, valid_t = buf[:, :3].contiguous(), buf[:, 3] > 0
    dist_q, ang, bitmap = _pairwise(pad, valid_t, d_res, n_dist_bins)
    return MapFeature(
        points=pad, valid=valid_t, dist_q=dist_q, ang=ang, bitmap=bitmap, origin=buf[0, 4:].reshape(4, 4), index=-1
    )


def popcount32(x):
    """Set bits in each int32 word's 32 bits (int64 result)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


# bytes of intermediates per (k1, k2) element of one chunk of pairs in
# score_pairs (masks, float32 angle differences, int32 bins, int64 scatter
# keys and the temporaries between them), and the budget they share
_SCORE_BYTES_PER_ELEM = 40
SCORE_BUDGET_BYTES = 1 << 30


def score_pairs(m1: MapFeature, m2: MapFeature, probes, *, a_res: float, n_angle_bins: int, min_match_threshold: int):
    """For every (probe i, candidate corner j) pair: the best rotation bin
    and its unique-left-neighbour vote count (match_des semantics,
    keyframe_manager.cpp:1034-1123).

    ``m2`` may carry a leading batch dim of M candidate maps.  Returns
    (counts, bins) int32 of shape (NP,P), or (M,NP,P) for a batch.

    Each left neighbour k1 votes at most once per rotation bin: the
    (k1, bin) pairs of equal distance are scattered into a (P*A) presence
    table per pair and the histogram over bins is its sum over k1.  Ties
    of the histogram resolve to the lowest bin (the reference's biased
    argmax).  Angle differences are truncated toward zero into bins, with
    the float32 constants the reference's program uses."""
    single = m2.points.dim() == 2
    if single:
        m2 = MapFeature(*[f[None] if isinstance(f, torch.Tensor) else f for f in m2])
    dev = m1.points.device
    probes = torch.as_tensor(probes, dtype=torch.int64).to(dev)
    M, P = m2.points.shape[:2]
    NP = probes.shape[0]
    A = n_angle_bins
    orig = A // 2
    ar = torch.arange(P, device=dev)

    # every (candidate, probe, j) pair, flattened and taken in chunks
    n_pairs = M * NP * P
    chunk = max(1, SCORE_BUDGET_BYTES // (_SCORE_BYTES_PER_ELEM * P * (P + A)))
    pm = torch.arange(M, device=dev).repeat_interleave(NP * P)
    pi = torch.arange(NP, device=dev).repeat_interleave(P).repeat(M)
    pj = ar.repeat(M * NP)
    d1_all, a1_all, b1_all = m1.dist_q[probes], m1.ang[probes], m1.bitmap[probes]  # (NP,P), (NP,NW)
    v1_all = m1.valid[probes]
    k1v_all = m1.valid[None, :] & (ar[None, :] != probes[:, None])  # (NP,P)
    pi_t, two_pi = _f32(math.pi), _f32(2 * math.pi)
    inv_a_res = _recip(a_res)
    keys_k1 = (ar * A)[:, None]  # (P,1)
    counts, best_bin = [], []
    for lo in range(0, n_pairs, chunk):
        sl = slice(lo, min(lo + chunk, n_pairs))
        cm, ci, cj = pm[sl], pi[sl], pj[sl]
        d2 = m2.dist_q[cm, cj]  # (B,P)
        a2 = m2.ang[cm, cj]
        k2v = m2.valid[cm] & (ar[None, :] != cj[:, None])
        eq = (d1_all[ci][:, :, None] == d2[:, None, :]) & k1v_all[ci][:, :, None] & k2v[:, None, :]
        adiff = a1_all[ci][:, :, None] - a2[:, None, :]
        adiff = torch.where(adiff >= pi_t, adiff - two_pi, adiff)
        adiff = torch.where(adiff < -pi_t, adiff + two_pi, adiff)
        bins = (adiff * inv_a_res).to(torch.int32) + orig  # (B,P,P), truncated
        vote = eq & (bins >= 0) & (bins < A)
        key = torch.where(vote, keys_k1 + bins, P * A).reshape(bins.shape[0], P * P).to(torch.int64)
        present = torch.zeros((bins.shape[0], P * A + 1), dtype=torch.bool, device=dev)
        present.scatter_(1, key, True)
        hist = present[:, : P * A].reshape(-1, P, A).sum(1, dtype=torch.int32)  # (B,A)
        biased = hist * (A + 1) - torch.arange(A, device=dev, dtype=torch.int32)
        bb = torch.argmax(biased, -1)
        best_cnt = torch.gather(hist, 1, bb[:, None])[:, 0] + 1  # + the root pair
        # popcount prefilter on the distance-bin bitmaps, and both corners valid
        inter = torch.sum(popcount32(b1_all[ci] & m2.bitmap[cm, cj]), -1)
        ok = (inter >= min_match_threshold) & v1_all[ci] & m2.valid[cm, cj]
        counts.append(torch.where(ok, best_cnt, torch.zeros_like(best_cnt)))
        best_bin.append(bb.to(torch.int32))
    counts = torch.cat(counts).reshape(M, NP, P)
    best_bin = torch.cat(best_bin).reshape(M, NP, P)
    if single:
        return counts[0], best_bin[0]
    return counts, best_bin


def extract_correspondences(m1, m2, i, j, bin_idx, *, a_res, n_angle_bins):
    """The correspondence set of the winning (i, j, rotation bin): for each
    left corner k1, the FIRST right corner k2 whose distance bin matches and
    whose angle difference falls in the winning bin.  Host numpy."""
    d1, a1 = _np(m1.dist_q[i]), _np(m1.ang[i])
    d2, a2 = _np(m2.dist_q[j]), _np(m2.ang[j])
    v1, v2 = _np(m1.valid), _np(m2.valid)
    pts1, pts2 = _np(m1.points), _np(m2.points)
    P = len(d1)
    orig = n_angle_bins // 2
    ad = a1[:, None] - a2[None, :]
    ad = np.where(ad >= np.pi, ad - 2 * np.pi, ad)
    ad = np.where(ad < -np.pi, ad + 2 * np.pi, ad)
    # python int() truncates toward zero; match it exactly
    binm = np.trunc(ad / a_res).astype(np.int64) + orig == bin_idx
    m = (
        (d1[:, None] == d2[None, :])
        & binm
        & v1[:, None]
        & v2[None, :]
        & (np.arange(P) != i)[:, None]
        & (np.arange(P) != j)[None, :]
    )
    has = m.any(axis=1)
    k2 = np.argmax(m, axis=1)
    p1 = np.concatenate([pts1[i][None], pts1[has]])
    p2 = np.concatenate([pts2[j][None], pts2[k2[has]]])
    return p1, p2


def _extract_correspondences_ref(m1, m2, i, j, bin_idx, *, a_res, n_angle_bins):
    """Reference-shaped double loop (oracle for the vectorized form)."""
    d1, a1 = _np(m1.dist_q[i]), _np(m1.ang[i])
    d2, a2 = _np(m2.dist_q[j]), _np(m2.ang[j])
    v1, v2 = _np(m1.valid), _np(m2.valid)
    pts1, pts2 = _np(m1.points), _np(m2.points)
    P = len(d1)
    orig = n_angle_bins // 2
    p1, p2 = [pts1[i]], [pts2[j]]
    for k1 in range(P):
        if not v1[k1] or k1 == i:
            continue
        for k2 in range(P):
            if not v2[k2] or k2 == j or d1[k1] != d2[k2]:
                continue
            ad = a1[k1] - a2[k2]
            if ad >= np.pi:
                ad -= 2 * np.pi
            elif ad < -np.pi:
                ad += 2 * np.pi
            if int(ad / a_res) + orig == bin_idx:
                p1.append(pts1[k1])
                p2.append(pts2[k2])
                break
    return np.asarray(p1), np.asarray(p2)


def kabsch_2d(p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Closed-form planar T with p1 ~= T @ p2 (least squares): the exact
    optimum of the reference's ICP_solve_by_opt objective."""
    a = p2[:, :2]
    b = p1[:, :2]
    mu_a = a.mean(0)
    mu_b = b.mean(0)
    H = (a - mu_a).T @ (b - mu_b)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R2 = Vt.T @ np.diag([1.0, d]) @ U.T
    t2 = mu_b - R2 @ mu_a
    T = np.eye(4)
    T[:2, :2] = R2
    T[:2, 3] = t2
    return T


def densify_lines(p1, p2, step):
    """Sample points along line segments every ``step`` meters (endpoints
    included).  Host numpy."""
    p1 = np.asarray(p1, np.float64).reshape(-1, 3)
    p2 = np.asarray(p2, np.float64).reshape(-1, 3)
    if len(p1) == 0:
        return np.zeros((0, 3))
    out = []
    for a, b in zip(p1, p2):
        n = max(2, int(np.linalg.norm((b - a)[:2]) / step) + 1)
        t = np.linspace(0.0, 1.0, n)[:, None]
        out.append(a[None] * (1 - t) + b[None] * t)
    return np.concatenate(out)


def verify_loop_overlap(scan1_pts, scan2_pts, T12, resolution, rate):
    """Scan-overlap verification (the reference short-circuits it to true,
    keyframe_manager.cpp:52-54; ``Params.verify_loop_rate`` <= 0 keeps that
    stub).  Projected scan-2 points count as hits when their cell or one of
    its 8 neighbours is occupied by scan 1."""
    if len(scan1_pts) == 0 or len(scan2_pts) == 0:
        return False
    q = (T12[:2, :2] @ np.asarray(scan2_pts)[:, :2].T).T + T12[:2, 3]
    c1 = np.floor(np.asarray(scan1_pts)[:, :2] / resolution).astype(np.int64)
    cells1 = set()
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            cells1.update(map(tuple, c1 + np.asarray([dx, dy])))
    cells2 = list(map(tuple, np.floor(q / resolution).astype(np.int64)))
    hit = sum(1 for c in cells2 if c in cells1)
    return hit / len(cells2) >= rate
