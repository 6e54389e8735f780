"""Masked Levenberg-Marquardt on a flat state vector: the benchmark's frozen
reference copy of the port's ``solve/gn``.

Originally a port of ``liwslam/solve/gn.py`` (the reference's ``ceres::Solve`` call
sites, solver.cpp:161-168 init and :795-802 tracking): trust-region LM with
one linearization per iteration (at the trial point, whose residual doubles
as the accept cost), Jacobians by ``torch.func.jacfwd``.

- ``method="qr"`` solves the augmented least squares problem
  ``[J; sqrt(lam) diag(colnorm)] dx = [-r; 0]`` (conditioning ~cond(J));
  ``method="chol"`` the Jacobi-equilibrated normal equations.
- Frozen parameters are zeroed J columns with unit augmentation.
- so3 components are re-wrapped after every step by ``wrap_fn``.

Host orchestration only: the loop reads ``done`` on the host each
iteration (the init window solve).  The per-frame tracking solve is
``ops/track_solve`` and makes no host sync.
"""

from __future__ import annotations

import threading
from typing import Callable, NamedTuple

import torch

# torch's forward-mode AD levels are process-wide state: two threads inside
# torch.func.jacfwd / jvp at once corrupt each other's levels.  Every
# forward-mode region of the package holds this lock (the online runner's
# back-end worker linearizes while the front end runs).
FORWARD_AD_LOCK = threading.RLock()


class LMConfig(NamedTuple):
    max_iters: int = 10
    lam_init: float = 1e-4
    lam_up: float = 4.0
    lam_down: float = 0.33
    lam_min: float = 1e-10
    lam_max: float = 1e8
    # function tolerance on the trial step's |cost change|: the f32 cost
    # noise floor is ~sqrt(eps_f32) = 3e-4 relative
    ftol: float = 3e-4
    xtol: float = 1e-7
    method: str = "qr"  # "qr" (augmented LSQ) or "chol" (normal equations)


def linearize(res_fn, x):
    """(r, J) of ``res_fn`` at ``x`` in one forward-mode pass."""

    def both(y):
        r = res_fn(y)
        return r, r

    with FORWARD_AD_LOCK:
        J, r = torch.func.jacfwd(both, has_aux=True)(x)
    return r, J


def _damped_step_qr(Jm, r, lam, free):
    D = Jm.shape[1]
    Jm = Jm * free[None, :]
    colnorm = torch.sqrt(torch.sum(Jm * Jm, 0))
    aug = torch.where(free > 0, torch.sqrt(lam) * torch.clamp(colnorm, min=1e-6), 1.0)
    A = torch.cat([Jm, torch.diag(aug)], 0)
    b = torch.cat([-r, torch.zeros(D, dtype=r.dtype, device=r.device)])
    Q, R = torch.linalg.qr(A)
    dx = torch.linalg.solve_triangular(R, (Q.T @ b)[:, None], upper=True)[:, 0]
    return dx * free


def _damped_step_chol(Jm, r, lam, free):
    """Normal equations + Cholesky, Jacobi-equilibrated; damping
    lam*diag(H) equals the QR form's sqrt(lam)*colnorm augmentation."""
    D = Jm.shape[1]
    Jm = Jm * free[None, :]
    H = Jm.T @ Jm
    g = Jm.T @ r
    diag = torch.diagonal(H)
    damped = diag + lam * torch.clamp(diag, min=1e-12)
    fm = free > 0
    A = torch.where(fm[:, None] & fm[None, :], H, 0.0)
    eye = torch.eye(D, dtype=torch.bool, device=H.device)
    A = torch.where(eye, torch.where(fm, damped, 1.0)[:, None], A)
    b = torch.where(fm, -g, 0.0)
    s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(A), min=1e-20))
    L, _ = torch.linalg.cholesky_ex(A * s[:, None] * s[None, :])
    y = torch.linalg.solve_triangular(L, (s * b)[:, None], upper=False)
    y = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    dx = s * y
    ok = torch.all(torch.isfinite(dx))
    return torch.where(ok, dx * free, torch.zeros_like(dx))


def lm_solve(
    res_fn: Callable,
    x0: torch.Tensor,
    free_mask: torch.Tensor,
    cfg: LMConfig = LMConfig(),
    wrap_fn: Callable = None,
):
    """Minimize |res_fn(x)|^2 over the free components of x.

    Returns (x_opt, final_cost, n_iters)."""
    free = free_mask.to(x0.dtype)
    step_fn = _damped_step_chol if cfg.method == "chol" else _damped_step_qr
    x = x0
    r, J = linearize(res_fn, x)
    c = 0.5 * torch.sum(r * r)
    lam = torch.as_tensor(cfg.lam_init, dtype=x0.dtype, device=x0.device)
    it = 0
    while it < cfg.max_iters:
        dx = step_fn(J, r, lam, free)
        x_t = x + dx
        if wrap_fn is not None:
            x_t = wrap_fn(x_t)
        r_t, J_t = linearize(res_fn, x_t)
        c_t = 0.5 * torch.sum(r_t * r_t)
        accept = c_t < c
        x = torch.where(accept, x_t, x)
        r = torch.where(accept, r_t, r)
        J = torch.where(accept, J_t, J)
        rel_change = torch.abs(c - c_t) / torch.clamp(c, min=1e-20)
        c = torch.where(accept, c_t, c)
        lam = torch.clamp(
            torch.where(accept, lam * cfg.lam_down, lam * cfg.lam_up), cfg.lam_min, cfg.lam_max
        )
        xtol_hit = torch.max(torch.abs(dx)) < cfg.xtol * (torch.max(torch.abs(x)) + cfg.xtol)
        stalled = ~accept & (lam >= cfg.lam_max)
        it += 1
        if bool((rel_change < cfg.ftol) | xtol_hit | stalled):
            break
    return x, c, it


def marginalize(res_fn: Callable, x: torch.Tensor, keep: int):
    """Schur-complement marginalization (solver.cpp:4-40, 257-442): keep the
    LAST ``keep`` entries of the flat state.  Returns (lin_J, lin_res,
    lin_X)."""
    r, Jm = linearize(res_fn, x)
    H = Jm.T @ Jm
    g = -(Jm.T @ r)
    m = x.shape[0] - keep
    Hmm = H[:m, :m] + 1e-8 * torch.eye(m, dtype=x.dtype, device=x.device)
    Hrm = H[m:, :m]
    # Jacobi equilibration keeps the f32 solve accurate at cond ~1e9
    s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Hmm), min=1e-20))
    sol = s[:, None] * torch.linalg.solve(
        Hmm * s[:, None] * s[None, :],
        s[:, None] * torch.cat([H[:m, m:], g[:m, None]], 1),
    )
    dH = H[m:, m:] - Hrm @ sol[:, :keep]
    dg = g[m:] - Hrm @ sol[:, keep]
    lin_J, lin_res = sqrt_prior(dH, dg)
    return lin_J, lin_res, x[m:]


def sqrt_prior(dH, dg):
    """Square-root prior from a Schur-reduced (information, gradient) pair:
    the eigendecomposition tail of ``marginalize`` (solver.cpp:390-405)."""
    dH = 0.5 * (dH + dH.T)
    eps = 1e-8
    S, V = torch.linalg.eigh(dH)
    S_cl = torch.where(S > eps, S, 0.0)
    S_inv = torch.where(S > eps, 1.0 / S, 0.0)
    lin_J = torch.sqrt(S_cl)[:, None] * V.T
    lin_res = -torch.sum(torch.sqrt(S_inv)[:, None] * V.T * dg, -1)
    return lin_J, lin_res
