"""The port's ``solve_pcg`` against the reference's on chip_smoke.py's graphs, on the CPU.

    python3 tools/parity_pcg.py --load chiprun_out/bench_frontend.npz [--K 1024]

Builds, from a bench-track front-end result saved by
``tools/parity_backend.py --save``, the K-node pose graphs of
chip_smoke.py and solves each on the CPU as the manager calls the solve
(20 Gauss-Newton, 60 CG iterations):

- ``timing``: ``chip_smoke.pcg_graph``, the graph the card's PCG times
  are taken on (drifted odometry, loops from the true poses);
- ``first``: the graph of this check's first version, rebuilt from its
  description: every edge from the true poses and the initial poses a
  drifted copy (a random walk of 2 cm and 2 mrad a node);
- ``settled``: ``chip_smoke.settled_graph``, the graph the card's solve
  is held on.

For each it prints the port's float32 solve (Gauss-Newton iterations,
cost), the same solve with the edges in another order (how far the order
of the sums alone moves it, in position, rotation and cost), the
reference's float32 solve (``liwslam.backend.posegraph.solve_pcg``, its
Gauss-Newton iterations and its distance from the port's), and a float64
solve of the port run to its own exit (200 and 200 iterations at most),
with each float32 answer's distance from it and the correction it makes.

Like the tests, this script runs the reference package (JAX, on the CPU)
beside the port; the port itself imports neither.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def first_graph(res, K, dev, perm_seed=None):
    import chip_smoke as cs
    from liwslam_torch.core import geometry as geo

    n_fe = min(len(res.p), K)
    p = np.zeros((K, 3), np.float32)
    q = np.zeros((K, 3), np.float32)
    p[:n_fe], q[:n_fe] = res.p[:n_fe], res.q[:n_fe]
    p[n_fe:, 0] = p[n_fe - 1, 0] + 0.25 * np.arange(1, K - n_fe + 1)
    p[n_fe:, 1:] = p[n_fe - 1, 1:]
    q[n_fe:] = q[n_fe - 1]
    T = cs._poses(p, q)
    walk = np.random.default_rng(1)
    yaw = np.cumsum(walk.normal(0, 2e-3, K))
    dxy = np.cumsum(walk.normal(0, 2e-2, (K, 2)), 0)
    yaw[0], dxy[0] = 0.0, 0.0
    T0 = np.stack([geo.make_tf_np(np.zeros(3), [0.0, 0.0, yaw[k]]) @ T[k] for k in range(K)])
    T0[:, :2, 3] += dxy
    ei, ej, ew, a, b = cs._pcg_edges(T, K)
    etf = np.concatenate([np.linalg.inv(T[:-1]) @ T[1:], np.linalg.inv(T[a]) @ T[b]])
    return cs._padded_graph(T0, ei, ej, etf, ew, dev, perm_seed)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--load", required=True, help="a front-end result written by parity_backend.py --save")
    ap.add_argument("--K", type=int, default=1024)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import chip_smoke as cs
    from liwslam import config as jconfig
    from liwslam.backend import posegraph as jpg
    from liwslam_torch import config as tconfig
    from liwslam_torch.backend import posegraph as pg

    torch.set_num_threads(4)
    z = np.load(args.load)

    class Res:
        p, q = z["p"], z["q"]

    prm = cs.bench_params()
    c = pg.make_pg_consts(prm, "cpu")
    jc = jpg.make_pg_consts(jconfig.office().replace(**tconfig.BENCH_WIDTHS))
    jsolve = jax.jit(lambda g, n: jpg.solve_pcg(g, jc, gn_iters=n, cg_iters=60))

    def to_jax(g):
        return jpg.empty_graph(g.p.shape[0], g.e_i.shape[0])._replace(
            p=jnp.asarray(g.p.numpy()), q=jnp.asarray(g.q.numpy()), node_valid=jnp.asarray(g.node_valid.numpy()),
            e_i=jnp.asarray(g.e_i.numpy().astype(np.int32)), e_j=jnp.asarray(g.e_j.numpy().astype(np.int32)),
            e_tf=jnp.asarray(g.e_tf.numpy()), e_weight=jnp.asarray(g.e_weight.numpy()),
            e_valid=jnp.asarray(g.e_valid.numpy()), n_nodes=jnp.asarray(g.n_nodes, jnp.int32),
            n_edges=jnp.asarray(g.n_edges, jnp.int32),
        )

    def jax_iters(jg, full):
        """The reference's Gauss-Newton iterations: the fewest whose answer
        equals that of 20 (its while_loop keeps no count)."""
        lo, hi = 1, 20
        while lo < hi:
            mid = (lo + hi) // 2
            if np.array_equal(np.asarray(jsolve(jg, mid)[0].p), full):
                hi = mid
            else:
                lo = mid + 1
        return lo

    K = args.K
    settled = lambda r, K, dev, perm_seed=None: cs.settled_graph(prm, r, K, dev, perm_seed=perm_seed)
    for name, build in (("timing", cs.pcg_graph), ("first", first_graph), ("settled", settled)):
        g = build(Res, K, "cpu")
        st = {}
        t0 = time.perf_counter()
        g32, cost32 = pg.solve_pcg(g, c, gn_iters=20, cg_iters=60, stats=st)
        s32 = time.perf_counter() - t0
        gp, cost_p = pg.solve_pcg(build(Res, K, "cpu", perm_seed=1), c, gn_iters=20, cg_iters=60)
        jg = to_jax(g)
        jout, jcost = jsolve(jg, 20)
        jp = np.asarray(jout.p)
        jt = type("G", (), dict(p=torch.as_tensor(jp), q=torch.as_tensor(np.asarray(jout.q))))
        g64c, c64 = cs.graph_float64(g, c)
        st64 = {}
        g64, cost64 = pg.solve_pcg(g64c, c64, gn_iters=200, cg_iters=200, stats=st64)
        rel = lambda a, b: abs(float(a) - float(b)) / max(float(b), 1e-20)
        row = dict(
            graph=name, K=K,
            port_f32=dict(gn_iters=st["gn_iters"], cost=float(cost32), s=round(s32, 1)),
            reordered_vs_port=dict(zip(("dp_m", "dq_rad"), cs.pose_gap(gp, g32)), rel_cost=rel(cost_p, cost32)),
            reference_f32=dict(gn_iters=jax_iters(jg, jp), cost=float(jcost)),
            reference_vs_port=dict(zip(("dp_m", "dq_rad"), cs.pose_gap(jt, g32)), rel_cost=rel(jcost, cost32)),
            port_f64=dict(gn_iters=st64["gn_iters"], cost=float(cost64)),
            correction=dict(zip(("dp_m", "dq_rad"), cs.pose_gap(g64c, g64))),
            port_f32_vs_f64=dict(zip(("dp_m", "dq_rad"), cs.pose_gap(g32, g64))),
            reference_f32_vs_f64=dict(zip(("dp_m", "dq_rad"), cs.pose_gap(jt, g64))),
        )
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
