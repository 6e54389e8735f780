"""The port's pose graph against the reference package's, on the CPU.

The loop graph of tests/test_backend.py (a drifting square closed by one
loop edge, K = 24 of 32 node slots) through both packages: residuals, the
Gauss-Newton normal products (rhs, the 6x6 diagonal blocks and the
Hessian-vector product on a random vector) and both solvers.  Every pose
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
