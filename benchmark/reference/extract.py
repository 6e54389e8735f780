"""Laser line extraction, plain PyTorch: the benchmark's frozen reference.

A copy of the plain version of the port's line extraction (kernel B2's
twin, ``ops/extract.extract_lines_plain``), with no kernel and no
operator: the line stages of the reference's ``spawn_scan``
(laser_manager.cpp:350-422):

1. segmentation by the continuity gap,
2. corner response over a clamped +-3 window, strict NMS,
3. merge of near-collinear joints,
4. TLS line fits from centred prefix moments over the spans between kept
   breakpoints, max point-to-line distance per span, ``min_len`` /
   ``max_dis`` gates,
5. compaction of the first ``max_lines`` winners in scan order.
"""

from __future__ import annotations

import torch

_BIG = 1e9
_EPS = 1e-8
_STEP = 3  # corner-response half window (laser_manager.cpp:375-408)


def _rev_cummin(x):
    return torch.flip(torch.cummin(torch.flip(x, [0]), 0).values, [0])


def _gather_rows(tbl, ix):
    """tbl[ix] with zero rows where ix is outside [0, len(tbl))."""
    n = tbl.shape[0]
    inside = (ix >= 0) & (ix < n)
    rows = tbl[torch.clamp(ix, 0, n - 1)]
    return torch.where(inside[:, None], rows, torch.zeros_like(rows)), inside


def compact(valid, cap, payload):
    """First ``cap`` rows of ``payload`` (N,k) where ``valid`` (scan order),
    zero-filled; returns (out_valid (cap,), rows (cap,k)).  A scatter into
    ``cap + 1`` slots (the last one takes the overflow): no host sync."""
    vi = valid.to(torch.int64)
    rank_incl = torch.cumsum(vi, 0)
    rank = rank_incl - vi
    slot = torch.where(valid & (rank < cap), rank, torch.full_like(rank, cap))
    out = torch.zeros((cap + 1, payload.shape[1]), dtype=payload.dtype, device=payload.device)
    out = out.index_put((slot,), payload)
    n = rank_incl[-1] if valid.numel() else torch.zeros((), dtype=torch.int64)
    lane = torch.arange(cap, device=valid.device)
    return lane < n, out[:cap]


def extract_lines_plain(
    points,
    valid,
    *,
    continuous_threshold: float,
    min_len: float,
    max_dis: float,
    tolerance_angle_rad: float,
    max_lines: int,
):
    """points (N,3) or (N,2) f32, valid (N,) bool -> (e1 (L,2), e2 (L,2),
    line_valid (L,) bool, end_gap (L,)).  Eager PyTorch, plain gathers; the
    same math as the reference package's XLA chain (scan.py:154-409)."""
    N = points.shape[0]
    dev, dtype = points.device, points.dtype
    xy = points[:, :2]
    idx = torch.arange(N, device=dev)

    # --- 1. segmentation --------------------------------------------------
    gap = torch.linalg.norm(xy[1:] - xy[:-1], dim=-1)
    cont = torch.cat(
        [
            torch.zeros(1, dtype=torch.bool, device=dev),
            (gap <= continuous_threshold) & valid[1:] & valid[:-1],
        ]
    )
    # moments about the scan centroid: f32 cancellation in the TLS
    # covariance is mm-scale on multi-metre coordinates otherwise
    m = valid.to(dtype)[:, None]
    n_all = torch.clamp(torch.sum(m), min=1.0)
    ref_c = torch.sum(xy * m, 0) / n_all
    xyc = xy - ref_c[None, :]
    x = xyc[:, 0:1] * m
    y = xyc[:, 1:2] * m
    start_flag = ~cont
    seg_id = torch.cumsum(start_flag.to(torch.int32), 0, dtype=torch.int32)
    # prefix moments in float64: a span's sums are differences of prefixes
    # that grow to ~1e4 over a scan, and f32 rounding there moves the TLS
    # direction of short spans by millimetres (PyTorch's CPU cumsum already
    # accumulates in double, its CUDA cumsum does not; kernel B2 does the same)
    cols = torch.cat([x, y, x * x, x * y, y * y, m], 1).to(torch.float64)
    cs = torch.cat([torch.zeros((1, 6), dtype=torch.float64, device=dev), torch.cumsum(cols, 0)], 0)
    seg_start = torch.cummax(torch.where(start_flag, idx, -1), 0).values
    next_start = _rev_cummin(torch.where(start_flag, idx, 2 * N))
    next_start = torch.cat([next_start[1:], torch.full((1,), N, device=dev)])
    seg_end = torch.clamp(next_start - 1, max=N - 1)

    # --- 2. corner response (clamped +-step window) -------------------------
    pj = xy[torch.maximum(idx - _STEP, seg_start)]
    pk = xy[torch.minimum(idx + _STEP, seg_end)]
    v1 = pj - xy
    v2 = pk - xy
    n1 = torch.linalg.norm(v1, dim=-1)
    n2 = torch.linalg.norm(v2, dim=-1)
    resp = torch.sum(v1 * v2, -1) / torch.clamp(n1 * n2, min=_EPS)
    interior = (idx > seg_start) & (idx < seg_end) & valid
    resp = torch.where(interior & (n1 > _EPS) & (n2 > _EPS), resp, -1.0)

    # --- 3. strict NMS within +-step (same segment, interior votes) --------
    resp_vote = torch.where(interior, resp, -_BIG)
    rp = torch.nn.functional.pad(resp_vote, (_STEP, _STEP), value=-_BIG)
    sp = torch.nn.functional.pad(seg_id, (_STEP, _STEP), value=-1)
    neigh_max = torch.full((N,), -_BIG, dtype=dtype, device=dev)
    for d in range(1, _STEP + 1):
        for off in (_STEP - d, _STEP + d):
            r_sh = rp[off : off + N]
            s_sh = sp[off : off + N]
            neigh_max = torch.maximum(neigh_max, torch.where(s_sh == seg_id, r_sh, -_BIG))
    is_max = interior & (resp > neigh_max)
    is_endpoint = (idx == seg_start) | (idx == seg_end)
    is_bp = is_max | (is_endpoint & valid)

    # --- 3b. merge near-collinear joints -----------------------------------
    prev_bp = torch.cummax(torch.where(is_bp, idx, -1), 0).values
    next_bp = _rev_cummin(torch.where(is_bp, idx, N + 1))
    prev_of = torch.cat([torch.full((1,), -1, device=dev), prev_bp[:-1]])
    next_of = torch.cat([next_bp[1:], torch.full((1,), N + 1, device=dev)])
    seg_f = seg_id.to(dtype)
    tbl = torch.cat([xy, seg_f[:, None]], 1)
    gp, _ = _gather_rows(tbl, prev_of)
    gn_, _ = _gather_rows(tbl, next_of)
    has_prev = (prev_of >= 0) & (gp[:, 2] == seg_f)
    has_next = (next_of <= N - 1) & (gn_[:, 2] == seg_f)
    u1 = gp[:, :2] - xy
    u2 = gn_[:, :2] - xy
    joint_cos = torch.sum(u1 * u2, -1) / torch.clamp(
        torch.linalg.norm(u1, dim=-1) * torch.linalg.norm(u2, dim=-1), min=_EPS
    )
    joint_angle = torch.arccos(torch.clamp(joint_cos, -1.0, 1.0))
    survives = torch.abs(joint_angle) < tolerance_angle_rad
    keep_bp = is_bp & (is_endpoint | survives | ~(has_prev & has_next))

    # --- 4. candidate spans between consecutive kept breakpoints -----------
    kept_next = _rev_cummin(torch.where(keep_bp, idx, N + 1))
    span_end = torch.cat([kept_next[1:], torch.full((1,), N + 1, device=dev)])
    cand_valid = keep_bp & (span_end <= N - 1) & (span_end - idx >= 2)
    i2 = torch.clamp(span_end, 0, N - 1)
    gap_full = torch.cat([torch.zeros(1, dtype=dtype, device=dev), gap])
    cand_valid = cand_valid & (seg_f[i2] == seg_f) & valid

    S = (cs[i2 + 1] - cs[:N]).to(dtype)  # [sx sy sxx sxy syy n] over [i1, i2]
    n = torch.clamp(S[:, 5], min=1.0)
    mx, my = S[:, 0] / n, S[:, 1] / n
    cxx = S[:, 2] / n - mx * mx
    cxy = S[:, 3] / n - mx * my
    cyy = S[:, 4] / n - my * my
    # minor eigenvector of the 2x2 scatter = line normal (TLS fit)
    tr = cxx + cyy
    det = cxx * cyy - cxy * cxy
    disc = torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))
    lam_min = tr / 2 - disc
    ex1 = torch.stack([cxy, lam_min - cxx], -1)
    ex2 = torch.stack([lam_min - cyy, cxy], -1)
    use1 = torch.linalg.norm(ex1, dim=-1) > torch.linalg.norm(ex2, dim=-1)
    nvec = torch.where(use1[:, None], ex1, ex2)
    nvec = nvec / torch.clamp(torch.linalg.norm(nvec, dim=-1, keepdim=True), min=_EPS)
    cc = -(nvec[:, 0] * mx + nvec[:, 1] * my)

    def project(pt):
        d = torch.sum(pt * nvec, -1) + cc
        return pt - d[:, None] * nvec

    e1 = project(xyc) + ref_c[None, :]
    e2 = project(xyc[i2]) + ref_c[None, :]
    length = torch.linalg.norm(e2 - e1, dim=-1)

    # max |point-to-line distance| over each span [i1, i2): dense masked max
    in_span = (idx[None, :] >= idx[:, None]) & (idx[None, :] < i2[:, None]) & valid[None, :]
    d_all = torch.abs(nvec @ xyc.T + cc[:, None])  # (span, point)
    max_d = torch.amax(torch.where(in_span, d_all, 0.0), 1)

    line_ok = (
        cand_valid & (max_d <= max_dis) & (length >= min_len) & torch.isfinite(length)
    )
    # beam spacing at the span ends (scales the corner gate)
    gf_next = torch.cat([gap_full[1:], gap_full[-1:]])
    end_gap = torch.maximum(gf_next, gap_full[i2])

    lv, rows = compact(line_ok, max_lines, torch.cat([e1, e2, end_gap[:, None]], 1))
    return rows[:, 0:2], rows[:, 2:4], lv, rows[:, 4]


extract_lines = extract_lines_plain
