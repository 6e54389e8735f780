"""Monocular feature tracking: Shi-Tomasi corners and pyramidal LK.

Port of ``liwslam/camera/tracker.py`` (reference ``camera_manager``,
``src/trajectory/camera_manager.cpp:31-113``): corner selection with
minimum-distance replenishment, the image pyramid, and the plain version
of kernel B3 (pyramidal Lucas-Kanade, ``liwslam/ops/lk.py``).

The reference package samples patches with one-hot matmuls and box-filters
with band matmuls, both TPU workarounds.  Here a patch is a plain gather
with zero weight for taps outside the image (the same values as the one-hot
weights) and the box filter is a zero-padded convolution (the same clamped
window sums).  The pyramid is ``avg_pool2d`` (the reference package also
builds it outside its kernel).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

_BIG_NEG = -3.4e38


def _grad(img):
    """Central differences with wrap-around at the border (``jnp.roll``)."""
    gx = (torch.roll(img, -1, 1) - torch.roll(img, 1, 1)) * 0.5
    gy = (torch.roll(img, -1, 0) - torch.roll(img, 1, 0)) * 0.5
    return gx, gy


def _box(img, r):
    """Sum over the (2r+1)-square window clamped to the image."""
    k = torch.ones((1, 1, 2 * r + 1, 2 * r + 1), dtype=img.dtype, device=img.device)
    return Fn.conv2d(img[None, None], k, padding=r)[0, 0]


def shi_tomasi_response(img, window=2):
    """Min-eigenvalue corner response (goodFeaturesToTrack's score)."""
    gx, gy = _grad(img)
    Ixx = _box(gx * gx, window)
    Iyy = _box(gy * gy, window)
    Ixy = _box(gx * gy, window)
    tr = Ixx + Iyy
    det = Ixx * Iyy - Ixy * Ixy
    disc = torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))
    return tr / 2 - disc


def select_features(img, n_max, min_dis, existing_xy=None, existing_valid=None,
                    budget=None, cell_px=None):
    """Corner selection with a minimum distance to each other and to the
    existing tracks (camera_manager.cpp:93-113), by dense cell-grid
    non-max suppression: a cell's best response survives if it beats the
    8 neighbouring cells and the intensity-scaled gate; survivors far from
    every live track are ranked by response and the first ``budget`` (at
    most ``n_max``) taken.  Returns (xy (n_max,2), ok (n_max,) bool)."""
    H, W = img.shape
    cs = int(cell_px) if cell_px is not None else max(1, int(math.ceil(float(min_dis))))
    dev, dtype = img.device, img.dtype
    resp = shi_tomasi_response(img)
    # the Shi-Tomasi score is quadratic in intensity: gate scaled by max²
    resp_gate = 1e-4 * torch.clamp(torch.amax(img), min=1.0) ** 2

    Hc, Wc = -(-H // cs), -(-W // cs)
    rp = Fn.pad(resp, (0, Wc * cs - W, 0, Hc * cs - H), value=_BIG_NEG)
    cells = rp.reshape(Hc, cs, Wc, cs)
    cell_max = torch.amax(cells, dim=(1, 3))
    flat = cells.permute(0, 2, 1, 3).reshape(Hc, Wc, cs * cs)
    amax = torch.argmax(flat, -1)  # first maximum within the cell, row-major
    cy = torch.arange(Hc, device=dev, dtype=dtype)[:, None] * cs + (amax // cs).to(dtype)
    cx = torch.arange(Wc, device=dev, dtype=dtype)[None, :] * cs + (amax % cs).to(dtype)
    nb = Fn.pad(cell_max, (1, 1, 1, 1), value=_BIG_NEG)
    neigh = torch.stack(
        [
            nb[1 + dy : 1 + dy + Hc, 1 + dx : 1 + dx + Wc]
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if not (dy == 0 and dx == 0)
        ]
    ).amax(0)
    is_winner = (cell_max > neigh) & (cell_max > resp_gate)

    cands = torch.stack([cx.reshape(-1), cy.reshape(-1)], -1)  # (C,2)
    big_neg = torch.full_like(cell_max.reshape(-1), _BIG_NEG)
    score = torch.where(is_winner.reshape(-1), cell_max.reshape(-1), big_neg)
    if existing_xy is not None and existing_xy.shape[0]:
        dd = torch.linalg.norm(cands[:, None, :] - existing_xy[None, :, :], dim=-1)
        far = torch.all(~existing_valid[None, :] | (dd >= min_dis), 1)
        score = torch.where(far, score, big_neg)

    k = min(n_max, score.shape[0])
    top_v, top_i = torch.topk(score, k)
    n_take = torch.full((), n_max, dtype=torch.int64, device=dev)
    if budget is not None:
        n_take = torch.clamp(budget.to(torch.int64), max=n_max)
    ok = (top_v > _BIG_NEG * 0.5) & (torch.arange(k, device=dev) < n_take)
    out_xy = torch.where(ok[:, None], cands[top_i], torch.zeros_like(cands[top_i]))
    if k < n_max:
        out_xy = torch.cat([out_xy, torch.zeros((n_max - k, 2), dtype=dtype, device=dev)])
        ok = torch.cat([ok, torch.zeros(n_max - k, dtype=torch.bool, device=dev)])
    return out_xy, ok


def downsample2(img):
    """2x2 average-pool decimation (one pyramid level)."""
    return Fn.avg_pool2d(img[None, None], 2, 2)[0, 0]


def build_pyramid(img, levels):
    """[img, half, quarter, ...] with ``levels`` entries."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(downsample2(pyr[-1]))
    return pyr


def sample_patches(img, xy, r):
    """Bilinear (2r+1)x(2r+1) patches of ``img`` around centres ``xy`` (T,2)
    as (T, 2r+1, 2r+1) [track, row, column].  Taps at floor(c) + k with the
    fraction c - floor(c); a tap outside the image has weight 0."""
    H, W = img.shape
    ks = torch.arange(-r, r + 1, device=img.device)
    c0x, c0y = torch.floor(xy[:, 0]), torch.floor(xy[:, 1])
    fx = (xy[:, 0] - c0x)[:, None, None]
    fy = (xy[:, 1] - c0y)[:, None, None]
    ix = c0x.long()[:, None, None] + ks[None, None, :]  # (T,1,P)
    iy = c0y.long()[:, None, None] + ks[None, :, None]  # (T,P,1)
    flat = img.reshape(-1)
    out = 0.0
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            yy, xx = iy + dy, ix + dx
            inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            v = flat[(yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1))]
            out = out + torch.where(inb, v, torch.zeros_like(v)) * (wy * wx)
    return out


def lk_descent(pyr0, pyr1, pts, valid, gate, *, radius=7, iters=10):
    """The plain version of kernel B3: pyramidal Lucas-Kanade of ``pts``
    (T,2) from pyramid ``pyr0`` to ``pyr1``, coarse to fine, ``iters``
    Gauss-Newton steps a level on 2x2 normal equations of ±1 px gradients,
    each level's excursion clipped to ± the level's width / height; then the
    level-0 verification (mean |patch0 - patch1| < ``gate`` (1,), new
    position at least ``radius`` inside the image).  Returns (new_pts (T,2),
    ok (T,) bool); an invalid track keeps its position."""
    # unit offsets made on the device (a tensor from a list is a host copy)
    one = torch.ones((), dtype=pts.dtype, device=pts.device)
    ex, ey = torch.stack([one, one * 0]), torch.stack([one * 0, one])
    d = torch.zeros_like(pts)
    for lvl in range(len(pyr0) - 1, -1, -1):
        i0, i1 = pyr0[lvl], pyr1[lvl]
        Hl, Wl = i0.shape
        scale = 2.0**lvl
        base = pts / scale
        patch0 = sample_patches(i0, base, radius)
        gx = 0.5 * (sample_patches(i0, base + ex, radius) - sample_patches(i0, base - ex, radius))
        gy = 0.5 * (sample_patches(i0, base + ey, radius) - sample_patches(i0, base - ey, radius))
        gxx = torch.sum(gx * gx, (1, 2)) + 1e-4
        gxy = torch.sum(gx * gy, (1, 2))
        gyy = torch.sum(gy * gy, (1, 2)) + 1e-4
        det = torch.clamp(gxx * gyy - gxy * gxy, min=1e-12)
        dl = d / scale
        for _ in range(iters):
            e = patch0 - sample_patches(i1, base + dl, radius)
            bx = torch.sum(e * gx, (1, 2))
            by = torch.sum(e * gy, (1, 2))
            ux = (gyy * bx - gxy * by) / det
            uy = (gxx * by - gxy * bx) / det
            dl = torch.stack(
                [torch.clamp(dl[:, 0] + ux, -Wl, Wl), torch.clamp(dl[:, 1] + uy, -Hl, Hl)], -1
            )
        d = dl * scale

    p1 = pts + d
    err = torch.mean(
        torch.abs(sample_patches(pyr0[0], pts, radius) - sample_patches(pyr1[0], p1, radius)), (1, 2)
    )
    H, W = pyr0[0].shape
    inb = (p1[:, 0] >= radius) & (p1[:, 0] < W - radius) & (p1[:, 1] >= radius) & (p1[:, 1] < H - radius)
    return torch.where(valid[:, None], p1, pts), inb & (err < gate) & valid


def lk_track(img0, img1, pts, valid, *, radius=7, iters=10, levels=3, max_err=0.1):
    """Pyramidal LK from ``img0`` to ``img1`` in plain PyTorch (any device):
    pyramids, the gate ``max_err * max(max(img0), 1)`` (invariant to 8-bit
    vs [0,1] images) and :func:`lk_descent`."""
    gate = (max_err * torch.clamp(torch.amax(img0), min=1.0)).reshape(1)
    return lk_descent(
        build_pyramid(img0, levels), build_pyramid(img1, levels), pts, valid, gate,
        radius=radius, iters=iters,
    )
