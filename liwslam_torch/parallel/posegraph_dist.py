"""Edge-sharded pose-graph Gauss-Newton over ``torch.distributed``.

Port of ``liwslam/parallel/posegraph_dist.py``.  The Gauss-Newton normal
products are sums over edges, so the edges split over the ranks of a
process group while the node state (K x 6, small) stays replicated:

    H x = sum_e  J_e^T (J_e x)        (each rank its edges; one all_reduce)
    rhs = -sum_e J_e^T r_e

The solver is ``backend/posegraph.solve_pcg`` itself, given a ``reduce`` hook
(``all_reduce`` with SUM) and the ground rows' weight 1/world (every rank
holds them whole).  The collective budget is the reference's:

- one fused (K,43) all_reduce a Gauss-Newton iteration: rhs, the 6x6
  node blocks of H and the current point's cost;
- one (K,6) all_reduce a CG iteration (``Hmul``; the CG dot products are
  local, their vectors replicated);
- one scalar all_reduce for the trial cost.

Every branch the host takes (CG's early exit, accept or reject, the
Gauss-Newton exit) reads a reduced value or one computed from replicated
vectors, so all ranks take the same branch and end with bit-equal poses.
A rank's partial sums alone need not be reproducible: on CUDA,
``index_add_`` accumulates with atomics.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from liwslam_torch.backend import posegraph as pg


def shard_edges(g: pg.PoseGraph, rank: int, world: int) -> pg.PoseGraph:
    """Rank ``rank``'s contiguous slice of the edges of ``g``; the nodes
    stay whole.  The edges are first padded to a multiple of ``world``
    with invalid, zero-weight edges, so any capacity splits."""
    E = g.e_i.shape[0]
    n = -(-E // world)
    pad = n * world - E
    if pad:
        z = lambda t, fill: torch.cat([t, torch.full((pad, *t.shape[1:]), fill, dtype=t.dtype, device=t.device)])
        e_tf = torch.cat([g.e_tf, torch.eye(4, dtype=g.e_tf.dtype, device=g.e_tf.device).repeat(pad, 1, 1)])
        g = g._replace(e_i=z(g.e_i, 0), e_j=z(g.e_j, 0), e_tf=e_tf, e_weight=z(g.e_weight, 0), e_valid=z(g.e_valid, False))
    sl = slice(rank * n, (rank + 1) * n)
    return g._replace(e_i=g.e_i[sl], e_j=g.e_j[sl], e_tf=g.e_tf[sl], e_weight=g.e_weight[sl], e_valid=g.e_valid[sl])


def solve_pcg_sharded(g_local: pg.PoseGraph, c: pg.PGConsts, group=None, gn_iters=15, cg_iters=50, lam=1e-6, stats=None):
    """:func:`liwslam_torch.backend.posegraph.solve_pcg` on this rank's
    slice of the edges (:func:`shard_edges`), every normal-equation
    product summed over ``group`` (the default group when None).  Returns
    (graph, cost), the same on every rank.

    ``stats``, a dict, gets solve_pcg's keys and "reductions": a count of
    the all_reduce calls by shape ("K,43", "K,6", "1")."""
    world = dist.get_world_size(group)
    if stats is not None:
        stats.setdefault("reductions", {})

    def reduce(t):
        if stats is not None:
            key = "1" if t.numel() == 1 else f"K,{t.shape[1]}"
            stats["reductions"][key] = stats["reductions"].get(key, 0) + 1
        buf = t if t.is_contiguous() else t.contiguous()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        if buf is not t:
            t.copy_(buf)

    return pg.solve_pcg(g_local, c, gn_iters, cg_iters, lam, stats, reduce=reduce, ground_w=1.0 / world)
