"""Landmark-Schur LM for the camera sub-step's joint pose + landmark solve.

Port of ``liwslam/solve/cam_schur.py``: the 30-dim pose window [previous
frame frozen, camera frame free] plus F landmark blocks of 3, coupled only
through the current frame's reprojection rows (older observations use the
frozen ring poses, solver.cpp:641-666).  Base rows (IMU, wheel, ground,
prior) are linearized over 30 tangents, reprojection rows over 9 (6 pose +
3 landmark); the normal equations assemble into Hpp (30x30), the 3x3
landmark blocks Hll and the coupling Hpl; each damped step solves the
30-dim Schur complement and back-substitutes the landmarks through 3x3
inverses.  LM semantics (damping, freeze masks, ftol / xtol / stall exit)
are those of ``gn.lm_solve``.

This is the arithmetic of kernel B4 (``ops/cam_solve``); its plain version
runs this function.
"""

from __future__ import annotations

import torch

from liwslam_torch.solve import factors as fac
from liwslam_torch.solve import gn


def inv3_sym(Hd, Ho):
    """Inverses of symmetric 3x3 blocks from their diagonals Hd (...,3) and
    off-diagonals Ho (...,3) = (01, 02, 12) by the adjugate; |det| < 1e-30
    becomes 1e-30.  Returns (...,3,3)."""
    a, e, i = Hd[..., 0], Hd[..., 1], Hd[..., 2]
    b, c, f = Ho[..., 0], Ho[..., 1], Ho[..., 2]
    cA = e * i - f * f
    cB = -(b * i - f * c)
    cC = b * f - e * c
    det = a * cA + b * cB + c * cC
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    m01, m02 = cB / det, cC / det
    m12 = -(a * f - c * b) / det
    rows = [
        [cA / det, m01, m02],
        [m01, (a * i - c * c) / det, m12],
        [m02, m12, (a * e - b * b) / det],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def camera_rows(pq, world, obs, ring_p, ring_q, Tic, sqrt_info):
    """(F,Wc,2) whitened reprojection rows: window slot Wc-1 is the free
    current frame at pose ``pq`` (6,), older slots the frozen ring poses."""
    Wc = obs.shape[1]
    cur = (torch.arange(Wc, device=pq.device) == Wc - 1).to(pq.dtype)[:, None]
    p = cur * pq[:3] + (1.0 - cur) * ring_p
    q = cur * pq[3:6] + (1.0 - cur) * ring_q
    return fac.camera_residual(p[None], q[None], world[:, None, :], obs, Tic, sqrt_info)


def linearize_rows(pq, world, obs, use, lm_free, ring_p, ring_q, Tic, sqrt_info):
    """(r (F,Wc,2), Jp (F,Wc,2,6), Jw (F,Wc,2,3)) of the masked rows.  A
    row depends on one landmark only, so one tangent per landmark axis
    (the same delta on every landmark) gives every row's 3 columns."""
    F, Wc = use.shape

    def g(z):
        return camera_rows(pq + z[:6], world + z[6:9], obs, ring_p, ring_q, Tic, sqrt_info).reshape(-1)

    r, J = gn.linearize(g, torch.zeros(9, dtype=pq.dtype, device=pq.device))
    u = use.to(pq.dtype)[:, :, None]
    J = J.reshape(F, Wc, 2, 9) * u[..., None]
    return r.reshape(F, Wc, 2) * u, J[..., :6], J[..., 6:9] * lm_free.to(pq.dtype)[:, None, None, None]


def lm_solve_cam_schur(
    res30_fn,
    x0_30,
    free30,
    world0,  # (F,3)
    lm_free,  # (F,) bool
    obs,  # (F,Wc,2) normalized observations
    use,  # (F,Wc) bool row mask (obs_mask & ready & ring_valid)
    ring_p,  # (Wc,3) frozen camera-frame poses (slot Wc-1 unused)
    ring_q,  # (Wc,3)
    Tic,
    sqrt_info,
    cfg: gn.LMConfig = gn.LMConfig(),
    wrap30=None,
):
    """Returns (x30_opt, world_opt, cost, iterations run)."""
    dtype, dev = x0_30.dtype, x0_30.device
    free30 = free30.to(dtype)
    fm = free30 > 0
    lmf = lm_free.to(dtype)
    eye30 = torch.eye(30, dtype=torch.bool, device=dev)

    def lin(x, wld):
        r_b, J_b = gn.linearize(res30_fn, x)
        r_c, Jp, Jw = linearize_rows(x[15:21], wld, obs, use, lm_free, ring_p, ring_q, Tic, sqrt_info)
        return r_b, J_b * free30[None, :], r_c, Jp, Jw

    def cost_of(r_b, r_c):
        return 0.5 * (torch.sum(r_b * r_b) + torch.sum(r_c * r_c))

    def damped_step(lin, lam):
        r_b, J_b, r_c, Jp, Jw = lin
        Hpp = J_b.T @ J_b
        g30 = -(J_b.T @ r_b)
        Hpp = Hpp.clone()
        Hpp[15:21, 15:21] += torch.einsum("fwce,fwcg->eg", Jp, Jp)
        g30 = g30.clone()
        g30[15:21] -= torch.einsum("fwce,fwc->e", Jp, r_c)
        Hll = torch.einsum("fwca,fwcb->fab", Jw, Jw)
        Hpl = torch.einsum("fwce,fwcb->feb", Jp, Jw)
        gl = -torch.einsum("fwcb,fwc->fb", Jw, r_c)

        diag = torch.diagonal(Hpp)
        damped = diag + lam * torch.clamp(diag, min=1e-12)
        A = torch.where(fm[:, None] & fm[None, :], Hpp, torch.zeros_like(Hpp))
        A = torch.where(eye30, torch.where(fm, damped, torch.ones_like(damped))[:, None], A)
        dgl = torch.diagonal(Hll, dim1=1, dim2=2)
        act = lm_free[:, None]
        Hd = torch.where(act, dgl + lam * torch.clamp(dgl, min=1e-12), torch.ones_like(dgl))
        Ho = torch.where(act, torch.stack([Hll[:, 0, 1], Hll[:, 0, 2], Hll[:, 1, 2]], -1), torch.zeros_like(dgl))
        glA = torch.where(act, gl, torch.zeros_like(gl))
        HplA = Hpl * lmf[:, None, None]
        Hinv = inv3_sym(Hd, Ho)
        K = HplA @ Hinv  # (F,6,3)
        S = A.clone()
        S[15:21, 15:21] -= torch.einsum("feb,fgb->eg", K, HplA)
        b = torch.where(fm, g30, torch.zeros_like(g30))
        b[15:21] -= torch.einsum("feb,fb->e", K, glA)

        s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-20))
        L, _ = torch.linalg.cholesky_ex(S * s[:, None] * s[None, :])
        y = torch.linalg.solve_triangular(L, (s * b)[:, None], upper=False)
        y = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
        dxp = s * y
        dxp = torch.where(torch.all(torch.isfinite(dxp)), dxp, torch.zeros_like(dxp)) * free30
        rhs = glA - torch.einsum("feb,e->fb", HplA, dxp[15:21])
        dxl = (Hinv @ rhs[:, :, None])[:, :, 0] * lmf[:, None]
        dxl = torch.where(torch.isfinite(dxl), dxl, torch.zeros_like(dxl))
        return dxp, dxl

    x, wld = x0_30, world0
    cur = lin(x, wld)
    c = cost_of(cur[0], cur[2])
    lam = torch.full((), cfg.lam_init, dtype=dtype, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    it = 0
    while it < cfg.max_iters and not bool(done):
        dxp, dxl = damped_step(cur, lam)
        x_t = x + dxp
        if wrap30 is not None:
            x_t = wrap30(x_t)
        w_t = wld + dxl
        trial = lin(x_t, w_t)
        c_t = cost_of(trial[0], trial[2])
        accept = c_t < c
        x = torch.where(accept, x_t, x)
        wld = torch.where(accept, w_t, wld)
        cur = tuple(torch.where(accept, a, b) for a, b in zip(trial, cur))
        rel_change = torch.abs(c - c_t) / torch.clamp(c, min=1e-20)
        c = torch.where(accept, c_t, c)
        lam = torch.clamp(torch.where(accept, lam * cfg.lam_down, lam * cfg.lam_up), cfg.lam_min, cfg.lam_max)
        dxn = torch.maximum(torch.amax(torch.abs(dxp)), torch.amax(torch.abs(dxl)))
        xn = torch.maximum(torch.amax(torch.abs(x)), torch.amax(torch.abs(wld)))
        xtol_hit = dxn < cfg.xtol * (xn + cfg.xtol)
        stalled = ~accept & (lam >= cfg.lam_max)
        done = done | (rel_change < cfg.ftol) | xtol_hit | stalled
        it += 1
    return x, wld, c, it
