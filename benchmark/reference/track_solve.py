"""The per-frame tracking solve, plain PyTorch: the benchmark's frozen
reference of kernel B1.

A copy of the port's plain version (``ops/track_solve``'s eager twin of
kernel B1), with no kernel and no operator.  The tracking problem has
fixed structure (reference ``solver.cpp:631-820`` with the laser-only
two-frame window): window = [previous, current], previous pose frozen; one
IMU and one wheel factor between the frames; laser line factors of the
current frame against a frozen reference pose; ground factors on both
frames; the marginalization prior on frame 0.

Residual rows (165 at M = 64):
    0:15      imu           (imu_factor.h:75-87)
    15:18     wheel         (wheel_factor.h:39-70)
    18:18+M   laser, endpoint 1 of every match (laser_factor.h:31-88)
    18+M:18+2M laser, endpoint 2
    +0:4      ground [f0 p, f0 q, f1 p, f1 q] (ground_factor.h:25-89)
    +4:19     prior         (marginalization_factor.h)

One solve = LM with damping ``lam*max(diag,1e-12)``, Jacobi equilibration,
a Cholesky, a zero step when the step is non-finite, early exit on ftol /
xtol / stalled lambda, one linearization per iteration (at the trial
point), SO(3) wrap of both rotations; then the Schur reduction of frame 0
at the solution into the 15-dim (dH, dg) that ``gn.sqrt_prior`` turns into
the prior.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import geometry as geo
from benchmark.reference.gn import linearize

D = 30  # flat state dim (2 frames x 15)
_EPS = 1e-8
_LAM_INIT, _LAM_UP, _LAM_DOWN, _LAM_MIN, _LAM_MAX = 1e-4, 4.0, 0.33, 1e-10, 1e8
# frame-0 pose is always frozen in tracking; fast_mode also freezes the
# frame-0 biases (solver.cpp:744)
FROZEN_POSE = (0, 1, 2, 3, 4, 5)
FROZEN_FAST = FROZEN_POSE + (9, 10, 11, 12, 13, 14)


class TrackSolveInputs(NamedTuple):
    """Kernel B1's inputs for B systems (leading dim), all float32."""

    x0: torch.Tensor  # (B,30) [p0 q0 v0 bs0 | p1 q1 v1 bs1]
    free: torch.Tensor  # (B,30) 1 free / 0 frozen
    imu_J: torch.Tensor  # (B,15,15) bias Jacobian of the preintegration
    imu_sqrtP: torch.Tensor  # (B,15,15) whitener
    imu_X: torch.Tensor  # (B,15) preintegrated [alpha beta gamma ba bw]
    prior_J: torch.Tensor  # (B,15,15)
    prior_X: torch.Tensor  # (B,15)
    T_il: torch.Tensor  # (B,4,4) imu -> laser extrinsic
    T_iw: torch.Tensor  # (B,4,4) imu -> wheel extrinsic
    wheel: torch.Tensor  # (B,9) [log p (3), log q (3), diag whitener (3)]
    scal: torch.Tensor  # (B,6) [Dt, g, ground p info, ground q info, ground weight, prior valid]
    laser: torch.Tensor  # (B,M,11) [a1 xy, a2 xy (world), b1 xyz, b2 xyz (laser), weight]


def tracking_free_mask(fast_mode: bool):
    """The tracking window's free mask and statically frozen dims, built on
    the host once: frame 1 free, frame-0 velocity free, frame-0 biases free
    unless ``fast_mode``.  Checks that every frozen dim is not free (the
    kernel skips their factorization steps, which is exact only then)."""
    free = [0.0] * 6 + [1.0] * 3 + [0.0 if fast_mode else 1.0] * 6 + [1.0] * 15
    frozen = FROZEN_FAST if fast_mode else FROZEN_POSE
    check_frozen(free, frozen)
    return free, frozen


def check_frozen(free, frozen_dims):
    """Raise unless ``frozen_dims`` is a subset of {k: free[k] == 0}."""
    bad = [k for k in frozen_dims if float(free[k]) != 0.0]
    if bad:
        raise ValueError(f"frozen_dims {bad} are free; the solve would be wrong")


def pack_inputs(x0, free, data, consts) -> TrackSolveInputs:
    """Kernel inputs (B=1) from a tracking-layout ``solve.factors.
    FactorData`` (W=2, laser i_idx < 0)."""
    op, oq = geo.log_SE3(data.wheel_dT[1])
    wheel = torch.cat([op, oq, torch.diagonal(data.wheel_sqrt[1])])
    scal = torch.stack(
        [
            data.imu_Dt[1],
            consts.g,
            consts.ground_p_info,
            consts.ground_q_info,
            data.ground_weight.to(x0.dtype),
            data.prior_valid.to(x0.dtype),
        ]
    )
    # frozen reference-pose side of the laser factors -> world, z dropped
    T_w_i = geo.tf_compose(geo.make_tf(data.laser_ref_p[0], data.laser_ref_q[0]), consts.T_imu_to_laser)
    a1 = geo.tf_apply(T_w_i, data.laser_l1p1)[:, 0:2]
    a2 = geo.tf_apply(T_w_i, data.laser_l1p2)[:, 0:2]
    len1 = torch.linalg.norm(data.laser_l1p1 - data.laser_l1p2, dim=-1)
    len2 = torch.linalg.norm(data.laser_l2p1 - data.laser_l2p2, dim=-1)
    wsum = torch.sqrt(torch.clamp(torch.minimum(len1, len2) / 2.0 / 0.02, min=_EPS))
    lw = wsum * consts.laser_sqrt_info * data.laser_valid.to(x0.dtype)
    laser = torch.cat([a1, a2, data.laser_l2p1, data.laser_l2p2, lw[:, None]], 1)
    one = lambda t: t[None].contiguous()
    return TrackSolveInputs(
        x0=one(x0),
        free=one(free.to(x0.dtype)),
        imu_J=one(data.imu_J[1]),
        imu_sqrtP=one(data.imu_sqrtP[1]),
        imu_X=one(data.imu_X[1]),
        prior_J=one(data.prior_J),
        prior_X=one(data.prior_X),
        T_il=one(consts.T_imu_to_laser),
        T_iw=one(consts.T_imu_to_wheel),
        wheel=one(wheel),
        scal=one(scal),
        laser=one(laser),
    )


# --------------------------------------------------------------------------
# plain version


def _mv(A, v):
    """Batched matrix-vector product (..., n, k) x (..., k) -> (..., n)."""
    return (A @ v[..., None])[..., 0]


def residual(x, inp: TrackSolveInputs, b: int = 0):
    """Flat residual (18 + 2M + 19,) of system ``b`` at x (30,).

    Every intermediate keeps a leading dim of 1: ``torch.func.jvp`` gives a
    0-d tensor times a Python float a float64 tangent, which would break the
    float32 Jacobian."""
    x = x[None]
    scal = inp.scal[b : b + 1]
    Dt, g = scal[:, 0:1], scal[:, 1:2]
    gp_info, gq_info, g_weight, prior_valid = scal[:, 2], scal[:, 3], scal[:, 4], scal[:, 5]
    imu_J, imu_X = inp.imu_J[b : b + 1], inp.imu_X[b : b + 1]
    p0, q0, v0, bs0 = x[:, 0:3], x[:, 3:6], x[:, 6:9], x[:, 9:15]
    p1, q1, v1, bs1 = x[:, 15:18], x[:, 18:21], x[:, 21:24], x[:, 24:30]
    zero = torch.zeros_like(x[:, 0])
    ez = torch.stack([zero, zero, zero + 1.0], -1)

    # imu (imu_factor.h:75-87)
    dba = bs0[:, :3] - imu_X[:, 9:12]
    dbw = bs0[:, 3:] - imu_X[:, 12:15]
    alpha = imu_X[:, 0:3] + _mv(imu_J[:, 0:3, 9:12], dba) + _mv(imu_J[:, 0:3, 12:15], dbw)
    beta = imu_X[:, 3:6] + _mv(imu_J[:, 3:6, 9:12], dba) + _mv(imu_J[:, 3:6, 12:15], dbw)
    gamma = imu_X[:, 6:9] + _mv(imu_J[:, 6:9, 12:15], dbw)
    R_iw = geo.exp_so3(-q0)
    va = p1 - p0 - v0 * Dt + 0.5 * g * Dt * Dt * ez
    vb = v1 - v0 + g * Dt * ez
    r_gamma = geo.log_SO3(geo.exp_so3(-gamma) @ (R_iw @ geo.exp_so3(q1)))
    sca = torch.cat([alpha - _mv(R_iw, va), beta - _mv(R_iw, vb), r_gamma, bs1 - bs0], -1)
    r_imu = _mv(inp.imu_sqrtP[b : b + 1], sca)

    # wheel (wheel_factor.h:39-70)
    wh = inp.wheel[b : b + 1]
    op, oq, ww = wh[:, 0:3], wh[:, 3:6], wh[:, 6:9]
    Rw, pw = inp.T_iw[b : b + 1, :3, :3], inp.T_iw[b : b + 1, :3, 3]
    R0 = geo.exp_so3(q0)
    R1 = geo.exp_so3(q1)
    RiT = (R0 @ Rw).transpose(-1, -2)
    rel_R = RiT @ (R1 @ Rw)
    rel_p = _mv(RiT, _mv(R1, pw) + p1 - _mv(R0, pw) - p0)
    q_rel = geo.log_SO3(rel_R)
    o_len = torch.sqrt(op[:, 0] ** 2 + op[:, 1] ** 2 + _EPS)
    on = torch.sqrt(torch.clamp(op[:, 0] ** 2 + op[:, 1] ** 2, min=_EPS * _EPS))
    o_u = torch.stack([op[:, 0] / on, op[:, 1] / on, zero], -1)
    length = torch.sqrt(rel_p[:, 0] ** 2 + rel_p[:, 1] ** 2 + _EPS)
    ndir = torch.stack([rel_p[:, 0], rel_p[:, 1], zero], -1)
    nn = geo.safe_norm(ndir)
    both = (on > 1e-4) & (nn > 1e-4)
    sinn = geo.safe_norm(torch.cross(o_u, ndir / nn[:, None], dim=-1))
    angle = torch.where(both, torch.asin(torch.clamp(sinn, 0.0, 1.0 - 1e-6)), nn)
    r0w = torch.where((length < 1e-4) | (o_len < 1e-4), length, o_len - length)
    qn = geo.safe_norm(q_rel)
    oqn = geo.safe_norm(oq)
    r2w = torch.where((qn < 1e-3) | (oqn < 1e-3), qn, oqn - qn)
    r_wheel = ww * torch.stack([r0w, angle, r2w], -1)

    # laser (laser_factor.h:31-88), frozen reference side precomputed
    las = inp.laser[b : b + 1]  # (1,M,11)
    T_R = R1 @ inp.T_il[b : b + 1, :3, :3]
    T_t = (_mv(R1, inp.T_il[b : b + 1, :3, 3]) + p1)[:, :2]
    a2 = las[..., 2:4]
    dl = a2 - las[..., 0:2]
    dln = dl / torch.sqrt(torch.clamp(torch.sum(dl * dl, -1), min=_EPS * _EPS))[..., None]

    def pdist(bl):
        v = bl @ T_R[:, :2].transpose(-1, -2) + T_t[:, None, :] - a2
        t = torch.sum(dln * v, -1)
        perp = v - t[..., None] * dln
        return torch.sqrt(torch.clamp(torch.sum(perp * perp, -1), min=_EPS * _EPS))

    lw = las[..., 10]
    r_laser = torch.cat([pdist(las[..., 4:7]) * lw, pdist(las[..., 7:10]) * lw], -1)

    # ground (ground_factor.h:25-89), both frames
    def ground(p, R):
        z = _mv(R, pw)[:, 2] + p[:, 2]
        To_R = R @ Rw
        sg = torch.sqrt(torch.clamp(To_R[:, 0, 2] ** 2 + To_R[:, 1, 2] ** 2, min=_EPS * _EPS))
        ang = torch.asin(torch.clamp(sg, 0.0, 1.0 - 1e-6))
        return [gp_info * z * g_weight, gq_info * ang * g_weight]

    r_ground = torch.stack(ground(p0, R0) + ground(p1, R1), -1)
    r_prior = _mv(inp.prior_J[b : b + 1], x[:, 0:15] - inp.prior_X[b : b + 1]) * prior_valid[:, None]
    return torch.cat([r_imu, r_wheel, r_laser, r_ground, r_prior], -1)[0]


def _wrap(x):
    s = lambda w: geo.normalize_so3(w)
    return torch.cat([x[0:3], s(x[3:6]), x[6:18], s(x[18:21]), x[21:30]])


def _chol_solve(L, rhs):
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True)


def _solve_one(inp, b, max_iters, ftol, xtol, early_exit):
    x = inp.x0[b]
    free = inp.free[b]
    fm = free > 0
    eye = torch.eye(D, dtype=torch.bool, device=x.device)
    res = lambda y: residual(y, inp, b)
    r, J = linearize(res, x)
    c = 0.5 * torch.sum(r * r)
    lam = torch.as_tensor(_LAM_INIT, dtype=x.dtype, device=x.device)
    done = torch.zeros((), dtype=torch.bool, device=x.device)
    it = 0
    for it in range(max_iters + 1):
        if it == max_iters or (early_exit and bool(done)):
            break
        Jm = J * free[None, :]
        H = Jm.T @ Jm
        diag = torch.diagonal(H)
        damped = diag + lam * torch.clamp(diag, min=1e-12)
        A = torch.where(eye, torch.where(fm, damped, 1.0)[:, None], H * (free[:, None] * free[None, :]))
        rhs = torch.where(fm, -(Jm.T @ r), 0.0)
        s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(A), min=1e-20))
        L, _ = torch.linalg.cholesky_ex(A * s[:, None] * s[None, :])
        dx = s * _chol_solve(L, (s * rhs)[:, None])[:, 0] * free
        dx = torch.where(torch.all(torch.isfinite(dx)), dx, torch.zeros_like(dx))
        x_t = _wrap(x + dx)
        r_t, J_t = linearize(res, x_t)
        c_t = 0.5 * torch.sum(r_t * r_t)
        accept = (c_t < c) & ~done
        x = torch.where(accept, x_t, x)
        r = torch.where(accept, r_t, r)
        J = torch.where(accept, J_t, J)
        rel_change = torch.abs(c - c_t) / torch.clamp(c, min=1e-20)
        c = torch.where(accept, c_t, c)
        lam = torch.where(done, lam, torch.where(accept, lam * _LAM_DOWN, lam * _LAM_UP))
        lam = torch.clamp(lam, _LAM_MIN, _LAM_MAX)
        xtol_hit = torch.max(torch.abs(dx)) < xtol * (torch.max(torch.abs(x)) + xtol)
        stalled = ~accept & (lam >= _LAM_MAX)
        done = done | (rel_change < ftol) | xtol_hit | stalled

    dH, dg = schur_frame0(J, r)
    iters = torch.full((), it, dtype=torch.int32, device=x.device)
    return x, c, dH, dg, iters


def schur_frame0(J, r):
    """Schur reduction of frame 0 out of the normal equations of (J, r)
    (unmasked, 30 columns): Hmm + 1e-8 I, equilibrated Cholesky, the
    symmetrised 15x15 dH and dg (``gn.marginalize`` keep = 15)."""
    H = J.T @ J
    gm = -(J.T @ r)
    Hmm = H[0:15, 0:15] + 1e-8 * torch.eye(15, dtype=J.dtype, device=J.device)
    sm = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Hmm), min=1e-20))
    Lm, _ = torch.linalg.cholesky_ex(Hmm * sm[:, None] * sm[None, :])
    rhs = torch.cat([H[0:15, 15:30], gm[0:15, None]], 1) * sm[:, None]
    sol = sm[:, None] * _chol_solve(Lm, rhs)
    dH = H[15:30, 15:30] - H[15:30, 0:15] @ sol[:, :15]
    dg = gm[15:30] - H[15:30, 0:15] @ sol[:, 15]
    return 0.5 * (dH + dH.T), dg


def lm_solve_track_plain(
    inp: TrackSolveInputs, *, max_iters=10, ftol=3e-4, xtol=1e-7, early_exit=True
):
    """Eager-PyTorch twin of kernel B1 (Jacobians by ``torch.func.jacfwd``)
    over B systems.  Returns (x (B,30), cost (B,), dH (B,15,15), dg (B,15),
    iters (B,) int32: LM iterations run).  The frozen dims need no skip list
    here: their rows of the equilibrated system are identity, which a full
    Cholesky factors exactly."""
    outs = [
        _solve_one(inp, b, max_iters, ftol, xtol, early_exit)
        for b in range(inp.x0.shape[0])
    ]
    return tuple(torch.stack(o) for o in zip(*outs))


def lm_solve_track(
    x0, free, data, consts, *, max_iters=10, ftol=3e-4, xtol=1e-7, early_exit=True, frozen_dims=FROZEN_POSE,
):
    """One tracking solve.  Returns (x_opt (30,), cost (), dH (15,15), dg
    (15,), iters ()); feed dH/dg to ``gn.sqrt_prior`` for the prior."""
    inp = pack_inputs(x0, free, data, consts)
    x, cost, dH, dg, iters = lm_solve_track_plain(
        inp, max_iters=max_iters, ftol=ftol, xtol=xtol, early_exit=early_exit
    )
    return x[0], cost[0], dH[0], dg[0], iters[0]
