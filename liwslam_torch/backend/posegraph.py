"""Pose-graph optimization over keyframe poses (the back-end solve).

Port of ``liwslam/backend/posegraph.py`` (``keyframe_manager::solve``,
``src/trajectory/keyframe_manager.cpp:722-838``): sequential edges (weight
1), loop edges (weight ``loop_edge_k``), optional per-keyframe ground
factors, first keyframe fixed, relative-pose residual
``log_SE3(tf_j^-1 tf_i tf12)`` with the loop-sigma diagonal information.

Two solvers over the same residuals, on the graph tensors' device:

- :func:`solve_dense`: all residuals stacked, LM with QR
  (``liwslam_torch.solve.gn``); for graphs up to a few hundred keyframes.
- :func:`solve_pcg`: matrix-free Gauss-Newton.  The Hessian-vector product
  is an edge-wise gather, 6x12 blocks and an ``index_add_`` scatter, solved
  by CG with 6x6 block-Jacobi preconditioning.  The host reads one flag a
  Gauss-Newton iteration (its exit test) and one every
  ``CG_CHECK_EVERY`` CG iterations; between reads, a CG whose residual
  reached its tolerance keeps its state frozen (``torch.where``), which
  gives the reference's early exit's answer.

Both work on fixed-capacity padded tensors (nodes K, edges E), as the
reference's do; the capacity picks the solver in the keyframe manager.

On CUDA, ``index_add_`` on float32 accumulates with atomics, so sums (and
the solve) are not bit-reproducible from run to run there; on the CPU they
are.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from liwslam_torch.core import geometry as geo
from liwslam_torch.solve import factors as fac
from liwslam_torch.solve import gn

# CG iterations between host reads of "every residual converged"
CG_CHECK_EVERY = 10


class PoseGraph(NamedTuple):
    """Fixed-capacity pose graph tensors."""

    p: torch.Tensor  # (K,3)
    q: torch.Tensor  # (K,3)
    node_valid: torch.Tensor  # (K,) bool
    e_i: torch.Tensor  # (E,) int64
    e_j: torch.Tensor  # (E,) int64
    e_tf: torch.Tensor  # (E,4,4) measured tf12 (pose_i^-1 pose_j at creation)
    e_weight: torch.Tensor  # (E,)
    e_valid: torch.Tensor  # (E,) bool
    n_nodes: int
    n_edges: int


def empty_graph(K: int, E: int, device="cpu", dtype=torch.float32) -> PoseGraph:
    return PoseGraph(
        p=torch.zeros((K, 3), dtype=dtype, device=device),
        q=torch.zeros((K, 3), dtype=dtype, device=device),
        node_valid=torch.zeros(K, dtype=torch.bool, device=device),
        e_i=torch.zeros(E, dtype=torch.int64, device=device),
        e_j=torch.zeros(E, dtype=torch.int64, device=device),
        e_tf=torch.eye(4, dtype=dtype, device=device).repeat(E, 1, 1),
        e_weight=torch.zeros(E, dtype=dtype, device=device),
        e_valid=torch.zeros(E, dtype=torch.bool, device=device),
        n_nodes=0,
        n_edges=0,
    )


def graph_from_numpy(p, q, n_nodes, e_i, e_j, e_tf, e_weight, n_edges, device) -> PoseGraph:
    """A PoseGraph on ``device`` from padded host arrays: (K,3) p and q,
    (E,) e_i / e_j / e_weight, (E,4,4) e_tf; the first ``n_nodes`` nodes and
    ``n_edges`` edges are valid.  Two host-to-device copies."""
    K, E = len(p), len(e_i)
    f = np.concatenate([np.asarray(p, np.float32).reshape(-1), np.asarray(q, np.float32).reshape(-1),
                        np.asarray(e_tf, np.float32).reshape(-1), np.asarray(e_weight, np.float32)])
    i = np.concatenate([np.asarray(e_i, np.int64), np.asarray(e_j, np.int64)])
    f, i = torch.as_tensor(f).to(device), torch.as_tensor(i).to(device)
    return PoseGraph(
        p=f[: 3 * K].reshape(K, 3),
        q=f[3 * K : 6 * K].reshape(K, 3),
        node_valid=torch.arange(K, device=device) < n_nodes,
        e_i=i[:E],
        e_j=i[E:],
        e_tf=f[6 * K : 6 * K + 16 * E].reshape(E, 4, 4),
        e_weight=f[6 * K + 16 * E :],
        e_valid=torch.arange(E, device=device) < n_edges,
        n_nodes=int(n_nodes),
        n_edges=int(n_edges),
    )


class PGConsts(NamedTuple):
    info6: torch.Tensor  # (6,) edge information diagonal
    T_imu_to_wheel: torch.Tensor  # (4,4)
    ground_p_info: float
    ground_q_info: float
    use_ground_p: bool
    use_ground_q: bool


def make_pg_consts(params, device="cpu") -> PGConsts:
    return PGConsts(
        info6=fac.edge_info6(params, device),
        T_imu_to_wheel=torch.as_tensor(params.mat_T_imu_to_wheel().astype(np.float32), device=device),
        ground_p_info=float(np.float32(1.0 / params.manifold_p_sigma)),
        ground_q_info=float(np.float32(1.0 / params.manifold_q_sigma)),
        use_ground_p=params.use_ground_p_factor,
        use_ground_q=params.use_ground_q_factor,
    )


def _ground_residual(p, q, c: PGConsts):
    """(...,2) wheel-frame height and tilt rows of poses (p, q)."""
    tf_w_o = geo.make_tf(p, q) @ c.T_imu_to_wheel
    rp = c.ground_p_info * tf_w_o[..., 2, 3] * (1.0 if c.use_ground_p else 0.0)
    ez = fac._ez(p)
    sinn = geo.safe_norm(torch.cross(tf_w_o[..., :3, 2], ez.expand_as(tf_w_o[..., :3, 2]), dim=-1))
    rq = c.ground_q_info * torch.arcsin(torch.clamp(sinn, 0.0, 1.0 - 1e-6)) * (1.0 if c.use_ground_q else 0.0)
    return torch.stack([rp, rq], -1)


def graph_residuals(g: PoseGraph, c: PGConsts):
    """All residual rows: edges (E,6) + ground (K,2)."""
    r_e = fac.edge_residual(g.p[g.e_i], g.q[g.e_i], g.p[g.e_j], g.q[g.e_j], g.e_tf, c.info6, g.e_weight)
    r_e = r_e * g.e_valid[:, None].to(r_e.dtype)
    r_g = _ground_residual(g.p, g.q, c) * g.node_valid[:, None].to(g.p.dtype)
    return r_e, r_g


# --------------------------------------------------------------------------
# dense path (small graphs)


def solve_dense(g: PoseGraph, c: PGConsts, max_iters=30):
    """LM (QR) over all free node poses.  Returns (graph, cost, iterations)."""
    K = g.p.shape[0]

    def res_fn(x):
        r_e, r_g = graph_residuals(g._replace(p=x[: K * 3].reshape(K, 3), q=x[K * 3 :].reshape(K, 3)), c)
        return torch.cat([r_e.reshape(-1), r_g.reshape(-1)])

    x0 = torch.cat([g.p.reshape(-1), g.q.reshape(-1)])
    node = g.node_valid[:, None].expand(K, 3).reshape(-1)
    free = torch.cat([node, node]).to(g.p.dtype)
    # first keyframe fixed (keyframe_manager.cpp:748-752)
    free[0:3] = 0.0
    free[K * 3 : K * 3 + 3] = 0.0

    def wrap(x):
        return torch.cat([x[: K * 3], geo.normalize_so3(x[K * 3 :].reshape(K, 3)).reshape(-1)])

    x, cost, iters = gn.lm_solve(res_fn, x0, free, gn.LMConfig(max_iters=max_iters), wrap)
    return g._replace(p=x[: K * 3].reshape(K, 3), q=x[K * 3 :].reshape(K, 3)), cost, iters


# --------------------------------------------------------------------------
# matrix-free PCG path (large graphs)


def _batched_jacobian(f, x):
    """(f(x), df_e/dx_e) of a function whose row e depends only on row e of
    x (E,D): forward mode along the D basis directions of every row at
    once, (E,R) and (E,R,D).  (A per-row ``vmap`` of ``jacfwd`` would run
    the rows' scalar intermediates as 0-d tensors, whose forward-mode
    tangents torch 2.13 promotes to float64 in ``torch.where``.)"""
    E, D = x.shape
    basis = torch.eye(D, dtype=x.dtype, device=x.device)[:, None, :].expand(D, E, D)
    with gn.FORWARD_AD_LOCK:
        r, J = torch.func.vmap(lambda t: torch.func.jvp(f, (x,), (t,)), out_dims=(None, 0))(basis)
    return r, J.permute(1, 2, 0)


def _edge_block_jacobians(g: PoseGraph, c: PGConsts):
    """Per-edge residual r (E,6) and Jacobian blocks w.r.t. (pi,qi) and
    (pj,qj), each (E,6,6)."""

    def f(x):
        return fac.edge_residual(x[:, :3], x[:, 3:6], x[:, 6:9], x[:, 9:], g.e_tf, c.info6, g.e_weight)

    x = torch.cat([g.p[g.e_i], g.q[g.e_i], g.p[g.e_j], g.q[g.e_j]], -1)
    r, J = _batched_jacobian(f, x)
    m = g.e_valid.to(g.p.dtype)
    return r * m[:, None], J[..., :6] * m[:, None, None], J[..., 6:] * m[:, None, None]


def _ground_block_jacobians(g: PoseGraph, c: PGConsts):
    r, J = _batched_jacobian(lambda x: _ground_residual(x[:, :3], x[:, 3:], c), torch.cat([g.p, g.q], -1))
    m = g.node_valid.to(g.p.dtype)
    return r * m[:, None], J * m[:, None, None]


def _gn_normal_products(g, c, free_mask, reduce=None, ground_w=1.0):
    """Return (rhs (K,6), Hmul: (K,6)->(K,6), diag (K,6), Hb (K,6,6), cost)
    of the masked Gauss-Newton normal equations at the current
    linearization; ``cost`` is 0.5 |r|^2 there.  ``Hb`` holds the 6x6
    node-diagonal blocks of H (the block-Jacobi preconditioner; cross
    blocks excluded).

    ``reduce`` (None on one device) sums a tensor in place over the ranks
    that hold the graph's other edges: rhs, Hb and the cost go through it
    as one fused (K,43) tensor, and every ``Hmul`` through one (K,6) call.
    ``ground_w`` weights the ground rows, which every rank holds whole
    (1/world on each rank, so their sum counts them once)."""
    K = g.p.shape[0]
    r_e, Ji, Jj = _edge_block_jacobians(g, c)
    r_g, Jg = _ground_block_jacobians(g, c)
    fm = free_mask  # (K,6)
    Ji = Ji * fm[g.e_i][:, None, :]
    Jj = Jj * fm[g.e_j][:, None, :]
    Jg = Jg * fm[:, None, :]

    # rhs = -J^T r
    rhs = -ground_w * torch.einsum("krd,kr->kd", Jg, r_g)
    rhs.index_add_(0, g.e_i, -torch.einsum("erd,er->ed", Ji, r_e))
    rhs.index_add_(0, g.e_j, -torch.einsum("erd,er->ed", Jj, r_e))

    Hb = ground_w * torch.einsum("krd,krc->kdc", Jg, Jg)
    Hb.index_add_(0, g.e_i, torch.einsum("erd,erc->edc", Ji, Ji))
    Hb.index_add_(0, g.e_j, torch.einsum("erd,erc->edc", Jj, Jj))
    cost = 0.5 * (torch.sum(r_e * r_e) + ground_w * torch.sum(r_g * r_g))
    if reduce is not None:
        # the current point's cost rides in lane [0, 42]
        payload = torch.cat([rhs, Hb.reshape(K, 36), torch.zeros_like(rhs[:, :1])], 1)
        payload[0, 42] = cost
        reduce(payload)
        rhs, Hb, cost = payload[:, 0:6], payload[:, 6:42].reshape(K, 6, 6), payload[0, 42]
    diag = torch.diagonal(Hb, dim1=1, dim2=2)

    def Hmul(x):  # x: (K,6)
        t = torch.einsum("erd,ed->er", Ji, x[g.e_i]) + torch.einsum("erd,ed->er", Jj, x[g.e_j])
        out = ground_w * torch.einsum("krd,kr->kd", Jg, torch.einsum("krd,kd->kr", Jg, x))
        out.index_add_(0, g.e_i, torch.einsum("erd,er->ed", Ji, t))
        out.index_add_(0, g.e_j, torch.einsum("erd,er->ed", Jj, t))
        if reduce is not None:
            reduce(out)
        return out

    return rhs, Hmul, diag, Hb, cost


def _block_jacobi_inv(Hb, lam_k, dscale):
    """Inverse 6x6 preconditioner blocks of A = H + lam*dscale*I.  Free
    nodes get their true damped diagonal block; fixed/invalid nodes (zero
    rows in Hb) collapse to a scaled identity, whose scale is irrelevant
    since their residual stays zero through CG.  ``inv_ex`` reports
    singular blocks in a tensor instead of checking on the host."""
    eye6 = torch.eye(6, dtype=Hb.dtype, device=Hb.device)
    M = Hb + (lam_k * dscale)[:, :, None] * eye6 + 1e-8 * eye6
    return torch.linalg.inv_ex(M)[0]


def _pcg_loop(rhs, Amul, Minv_apply, cg_iters, cg_rtol, stats=None):
    """Preconditioned CG to rz <= cg_rtol^2 * rz0 or ``cg_iters``
    iterations.  A converged system's state stays frozen until the host's
    next check, so the answer is the early exit's."""
    x = torch.zeros_like(rhs)
    r = rhs
    z = Minv_apply(rhs)
    p = z
    rz = torch.sum(rhs * z)
    thresh = cg_rtol**2 * rz + 1e-30
    for i in range(cg_iters):
        if i % CG_CHECK_EVERY == 0 and i > 0:
            if stats is not None:
                stats["syncs"] += 1
            if not bool(rz > thresh):
                break
        active = rz > thresh
        if stats is not None:
            stats["cg_iters"] = stats.get("cg_iters", 0) + 1
        Ap = Amul(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = Minv_apply(r_n)
        rz_n = torch.sum(r_n * z_n)
        beta = rz_n / torch.clamp(rz, min=1e-20)
        x = torch.where(active, x_n, x)
        r = torch.where(active, r_n, r)
        p = torch.where(active, z_n + beta * p, p)
        rz = torch.where(active, rz_n, rz)
    return x


def solve_pcg(g: PoseGraph, c: PGConsts, gn_iters=15, cg_iters=50, lam=1e-6, stats=None, *, reduce=None, ground_w=1.0):
    """Matrix-free damped Gauss-Newton with block-Jacobi-PCG inner solves:
    CG exit on relative residual, the current point's cost computed with
    the normal products, and exit once an accepted step stops improving
    or the trust region collapsed (the reference's rules).

    ``stats``, a dict, gets "gn_iters", "cg_iters" and "syncs" (host reads
    of a device value) added to.

    ``reduce`` and ``ground_w`` solve a graph whose edges are split over
    ranks (``parallel/posegraph_dist``), as in :func:`_gn_normal_products`;
    the trial cost takes one more (scalar) reduction.  Every branch the
    host takes then reads a reduced value or one computed from replicated
    vectors, so every rank takes the same one."""
    assert gn_iters >= 1  # the first iteration's products give the seed cost
    K = g.p.shape[0]
    fm = g.node_valid[:, None].expand(K, 6).to(g.p.dtype).clone()
    fm[0, :] = 0.0  # first keyframe fixed
    if stats is not None:
        stats.setdefault("syncs", 0)
        stats.setdefault("gn_iters", 0)

    def cost_of(g2):
        r_e, r_g = graph_residuals(g2, c)
        cost = 0.5 * (torch.sum(r_e * r_e) + ground_w * torch.sum(r_g * r_g))
        if reduce is not None:
            cost = cost.reshape(1)
            reduce(cost)
            cost = cost[0]
        return cost

    lam_k = torch.full((), lam, dtype=g.p.dtype, device=g.p.device)
    for _ in range(gn_iters):
        # the current point's cost: the last accepted one
        rhs, Hmul, diag, Hb, cost = _gn_normal_products(g, c, fm, reduce, ground_w)
        dscale = torch.clamp(diag, min=1e-8)
        Minv = _block_jacobi_inv(Hb, lam_k, dscale)
        dx = _pcg_loop(
            rhs,
            lambda x: Hmul(x) + lam_k * dscale * x,
            lambda r: torch.einsum("kdc,kc->kd", Minv, r),
            cg_iters,
            1e-2,
            stats,
        ) * fm
        g_new = g._replace(p=g.p + dx[:, :3], q=geo.normalize_so3(g.q + dx[:, 3:]))
        cost_new = cost_of(g_new)
        improved = cost_new < cost
        g = g._replace(p=torch.where(improved, g_new.p, g.p), q=torch.where(improved, g_new.q, g.q))
        rel = torch.abs(cost - cost_new) / torch.clamp(cost, min=1e-20)
        cost = torch.where(improved, cost_new, cost)
        lam_k = torch.clamp(torch.where(improved, lam_k * 0.5, lam_k * 8.0), 1e-9, 1e6)
        # exit on an accepted step that stopped improving, or when the
        # trust region collapsed (lam railed after rejects); a rejected
        # trial with a small change keeps iterating so lam can recover
        done = (improved & (rel < 1e-5)) | (~improved & (lam_k >= 1e6))
        if stats is not None:
            stats["syncs"] += 1
            stats["gn_iters"] += 1
        if bool(done):
            break
    return g, cost
