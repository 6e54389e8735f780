"""The port's pose graph against the reference package's, on the CPU.

The loop graph of tests/test_backend.py (a drifting square closed by one
loop edge, K = 24 of 32 node slots) through both packages: residuals, the
Gauss-Newton normal products (rhs, the 6x6 diagonal blocks and the
Hessian-vector product on a random vector) and both solvers; and the
keyframe manager's loop verification gate (``verify_loop_rate``) on
tests/test_knobs.py's scenario, through both managers.  Every pose
is rolled by 0.05 rad for the residual and product checks, so the ground
tilt rows sit away from the kink of |z x e_z| at a level pose, where their
Jacobian is float32 noise in both packages.  Tolerances: residuals within
1e-4 of their scale; normal products within 1e-4 relative to their
largest entry (float32 Jacobians of a 4000-weighted factor); solved poses
within 1e-4 (float32 solves to the same optimum)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from liwslam.backend import posegraph as jpg
from liwslam_torch import convert
from liwslam_torch.backend import posegraph as tpg
from tests.test_backend import prm_small
from tests.test_parallel import _build_square_graph


def _carry(g):
    return tpg.graph_from_numpy(
        np.asarray(g.p), np.asarray(g.q), int(g.n_nodes), np.asarray(g.e_i), np.asarray(g.e_j),
        np.asarray(g.e_tf), np.asarray(g.e_weight), int(g.n_edges), "cpu",
    )


@pytest.fixture(scope="module")
def graphs():
    g, _, K = _build_square_graph()
    prm = prm_small()
    jc = jpg.make_pg_consts(prm)
    tc = tpg.make_pg_consts(convert.params_from_reference(dataclasses.asdict(prm)), "cpu")
    return g, K, jc, tc


def test_residuals_and_normal_products_match_reference(graphs):
    g, K, jc, tc = graphs
    rng = np.random.default_rng(3)
    q = np.asarray(g.q).copy()
    q[:, 0] += 0.05  # roll every pose off the level kink
    g = g._replace(q=jnp.asarray(q))
    tg = _carry(g)
    for a, b in zip(jax.jit(lambda g: jpg.graph_residuals(g, jc))(g), tpg.graph_residuals(tg, tc)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-4 * max(1.0, np.abs(a).max()))
    fm = np.tile(np.asarray(g.node_valid)[:, None], (1, 6)).astype(np.float32)
    fm[0] = 0.0
    v = rng.normal(size=(g.p.shape[0], 6)).astype(np.float32)

    def jprod(g):
        rhs, Hmul, diag, Hb, _ = jpg._gn_normal_products(g, jc, jnp.asarray(fm))
        return rhs, diag, Hb, Hmul(jnp.asarray(v))

    rhs, Hmul, diag, Hb, _ = tpg._gn_normal_products(tg, tc, torch.as_tensor(fm))
    for a, b in zip(jax.jit(jprod)(g), (rhs, diag, Hb, Hmul(torch.as_tensor(v)))):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-4 * np.abs(a).max())


def test_solvers_match_reference(graphs):
    g, K, jc, tc = graphs
    tg = _carry(g)
    jd, jcost = jax.jit(lambda g: jpg.solve_dense(g, jc, max_iters=40))(g)
    td, tcost, iters = tpg.solve_dense(tg, tc, max_iters=40)
    jp, jcost_p = jax.jit(lambda g: jpg.solve_pcg(g, jc, gn_iters=25, cg_iters=80))(g)
    stats = {}
    tp, tcost_p = tpg.solve_pcg(tg, tc, gn_iters=25, cg_iters=80, stats=stats)
    for (a, ac), (b, bc) in (((jd, jcost), (td, tcost)), ((jp, jcost_p), (tp, tcost_p))):
        np.testing.assert_allclose(b.p.numpy()[:K], np.asarray(a.p)[:K], rtol=0, atol=1e-4)
        np.testing.assert_allclose(b.q.numpy()[:K], np.asarray(a.q)[:K], rtol=0, atol=1e-4)
        assert float(bc) == pytest.approx(float(ac), rel=1e-4)
        np.testing.assert_array_equal(b.p.numpy()[0], np.asarray(g.p)[0])  # first keyframe fixed
    assert 1 <= iters <= 40 and 1 <= stats["gn_iters"] <= 25 and stats["syncs"] >= stats["gn_iters"]


def test_verify_loop_rate_gates_manager_like_reference():
    """tests/test_knobs.py:86's scenario (a circle of 24 keyframes
    revisited, a stored square scan on each) through both managers at
    three ``verify_loop_rate`` values: the same loops and rejections in
    both; loops at 0.5 and at 0 (the reference's always-true stub), none
    at 1.01."""
    from liwslam.backend import manager as jkm
    from liwslam.core import geometry as jgeo
    from liwslam_torch.backend import manager as tkm
    from tests.test_backend import se2
    from tests.test_knobs import _square_scan
    from tests.test_torch_backend import _assert_managers_agree, _tprm

    prm = prm_small().replace(pose_graph_solve_interval_s=0.0)
    world = np.concatenate([np.random.default_rng(0).uniform(-5, 5, (16, 2)), np.zeros((16, 1))], axis=1)
    scan = _square_scan()
    n = 24
    found = {}
    for rate in (0.5, 1.01, 0.0):
        p = prm.replace(verify_loop_rate=rate)
        jm, tm = jkm.KeyframeManager(p), tkm.KeyframeManager(_tprm(p), device="cpu")
        for k in range(n + 3):
            th = 2 * np.pi * (k % n) / n
            T = se2(3 * np.cos(th), 3 * np.sin(th), th) @ np.linalg.inv(prm.mat_T_imu_to_wheel())
            vis = world[np.linalg.norm(world[:, :2] - T[:2, 3], axis=1) < 7.0]
            pp, qq = jgeo.log_SE3(jnp.asarray(T, jnp.float32))
            for m in (jm, tm):
                m.add_keyframe(t_us=int(k * 2e6), p=np.asarray(pp), q=np.asarray(qq), corners=vis, scan_lines=scan)
        _assert_managers_agree(jm, tm)
        found[rate] = len(tm.loops_found)
    assert found[0.5] >= 1 and found[1.01] == 0 and found[0.0] >= 1, found
