"""The port's distributed modes on the CPU: the edge-sharded pose-graph
solve over ``torch.distributed`` (gloo ranks spawned by
``liwslam_torch.parallel.dist_runner``) against the port's single-process
solve and the reference package's sharded solve on the conftest's eight
virtual CPU devices, and the two-robot pipeline's exchange.

Bounds:

- float64, 2 ranks, on the runner's ring graph at K = 32 (where the solve
  settles, 9 Gauss-Newton iterations): poses within 1e-8 m of the
  single-process solve; both ranks' poses bit-equal; one (K,43) and one
  scalar all_reduce a Gauss-Newton iteration, one (K,6) a CG iteration;
- float32, against the reference: the reference's own bounds
  (tests/test_parallel.py: cost within 5%, loop error < 0.2x the drift's)
  and poses within 1e-3 m of each other;
- the pipeline's exchange (keyframes of the runner's two tracks with
  drift, no front end): at least one cross-session loop, max |dp| < 0.05 m
  (tests/test_distributed_mp.py) and bit-equal ranks."""


import numpy as np
import pytest
import torch

from liwslam_torch import config as tconfig
from liwslam_torch.backend import posegraph as tpg
from liwslam_torch.parallel import dist_runner as dr
from liwslam_torch.parallel import posegraph_dist as tpgd

K, E = 32, 64


@pytest.fixture(scope="module")
def solves():
    """2-rank gloo runs of the solve mode on the ring graph, float64 and
    float32 (one spawn each)."""
    run = lambda dtype: dr.launch(
        dr.RunConfig(mode="solve", num_processes=2, device="cpu", backend="gloo", dtype=dtype, nodes=K, edges=E,
                     gn_iters=100, cg_iters=100)
    )
    return {d: run(d) for d in ("float64", "float32")}


def test_shard_edges_pads_to_the_world_and_splits_contiguously():
    g = tpg.graph_from_numpy(**dr.build_graph(8, 10), device="cpu")
    parts = [tpgd.shard_edges(g, r, 3) for r in range(3)]
    assert [p.e_i.shape[0] for p in parts] == [4, 4, 4]
    cat = lambda f: torch.cat([getattr(p, f) for p in parts])
    for f in ("e_i", "e_j", "e_tf", "e_weight", "e_valid"):
        assert torch.equal(cat(f)[:10], getattr(g, f))
    assert not cat("e_valid")[10:].any() and not cat("e_weight")[10:].any()
    assert all(torch.equal(p.p, g.p) and torch.equal(p.q, g.q) for p in parts)


def test_world_of_one_is_the_single_process_solve(tmp_path):
    """One gloo rank in this process: the sharded solve is solve_pcg bit
    for bit (the reductions are identities, the ground weight 1)."""
    import torch.distributed as dist

    g = tpg.graph_from_numpy(**dr.build_graph(K, E), device="cpu")
    c = tpg.make_pg_consts(tconfig.office(), "cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", world_size=1, rank=0)
    try:
        st = {}
        gs, cs = tpgd.solve_pcg_sharded(tpgd.shard_edges(g, 0, 1), c, gn_iters=5, cg_iters=20, stats=st)
    finally:
        dist.destroy_process_group()
    gu, cu = tpg.solve_pcg(g, c, gn_iters=5, cg_iters=20)
    assert torch.equal(gs.p, gu.p) and torch.equal(gs.q, gu.q) and float(cs) == float(cu)
    assert st["reductions"] == {"K,43": st["gn_iters"], "K,6": st["cg_iters"], "1": st["gn_iters"]}


def test_sharded_solve_matches_the_single_process_solve(solves):
    v = solves["float64"]
    assert v["ok"], v
    assert v["max_dp"] < 1e-8 and v["max_dq"] < 1e-8, v
    assert v["ranks_equal"] and v["reference_modules_loaded"] == []
    n = v["gn_iters"]
    assert n < 100  # settled: exited on its own test
    assert v["reductions"] == {"K,43": n, "K,6": v["cg_iters"], "1": n}
    assert v["cost_multi"] < 1e-6 * v["cost_initial"]


def test_sharded_solve_matches_reference(solves):
    """The same graph through the reference's solve_pcg_sharded (8 virtual
    CPU devices) and solve_pcg, float32, with tests/test_parallel.py's
    bounds and the poses within 1e-3 m."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from liwslam import config as jconfig
    from liwslam.backend import posegraph as jpg
    from liwslam.parallel import posegraph_dist as jpgd

    a = dr.build_graph(K, E)
    g = jpg.empty_graph(K, E)._replace(
        p=jnp.asarray(a["p"]), q=jnp.asarray(a["q"]), node_valid=jnp.ones(K, bool),
        e_i=jnp.asarray(a["e_i"], jnp.int32), e_j=jnp.asarray(a["e_j"], jnp.int32),
        e_tf=jnp.asarray(a["e_tf"]), e_weight=jnp.asarray(a["e_weight"]),
        e_valid=jnp.arange(E) < a["n_edges"], n_nodes=jnp.asarray(K, jnp.int32),
        n_edges=jnp.asarray(a["n_edges"], jnp.int32),
    )
    jc = jpg.make_pg_consts(jconfig.office())
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8), ("pg",))
    g8, cost8 = jpgd.solve_pcg_sharded(jpgd.shard_edges(g, mesh, "pg"), jc, mesh, "pg", gn_iters=100, cg_iters=100)
    g1, cost1 = jax.jit(lambda g: jpg.solve_pcg(g, jc, gn_iters=100, cg_iters=100))(g)

    v = solves["float32"]
    assert v["ok"] and v["ranks_equal"], v
    p_port = np.asarray(v["p_multi"])
    # the ring's true IMU-frame positions (dist_runner.build_graph's) and
    # the drift of the start poses
    th = np.linspace(0, 2 * np.pi, K)
    off = np.linalg.inv(tconfig.office().mat_T_imu_to_wheel())[:2, 3]
    rot = np.stack([np.stack([-np.sin(th), -np.cos(th)], -1), np.stack([np.cos(th), -np.sin(th)], -1)], -2)
    gt = np.stack([10 * np.cos(th), 10 * np.sin(th)], -1) + rot @ off
    err = lambda p: np.linalg.norm(np.asarray(p)[:, :2] - gt, axis=1).max()
    err_before = err(a["p"])
    for cost, p in ((float(cost8), g8.p), (float(cost1), g1.p)):
        assert abs(v["cost_multi"] - cost) < 0.05 * cost + 1e-3, (v["cost_multi"], cost)
        assert err(p) < 0.2 * err_before
        np.testing.assert_allclose(p_port, np.asarray(p), rtol=0, atol=1e-3)
    assert err(p_port) < 0.2 * err_before


def test_pipeline_exchange_on_synthetic_keyframes():
    """The pipeline after the front ends, 2 gloo ranks: the keyframes of
    the runner's two tracks (drifting, in each robot's own frame) cross in
    one all_gather_object, rank 0's manager closes a cross-session loop,
    the graph goes out in two broadcasts and both ranks solve it
    edge-sharded."""
    v = dr.launch(dr.RunConfig(mode="pipeline", num_processes=2, device="cpu", backend="gloo", feed="synthetic"))
    assert v["ok"], v
    assert v["cross_session_loops"] >= 1 and v["max_dp"] < 0.05 and v["ranks_equal"]
    assert v["cost_multi"] <= v["cost_initial"]
    assert v["reductions"] == {"K,43": v["gn_iters"], "K,6": v["cg_iters"], "1": v["gn_iters"]}
    assert v["reference_modules_loaded"] == []


@pytest.mark.slow
def test_two_robot_pipeline_with_front_ends():
    """The whole two-robot runner on the CPU, each rank running its own
    front end at the runner's widths (the reference's
    test_two_process_full_pipeline)."""
    v = dr.launch(dr.RunConfig(mode="pipeline", num_processes=2, device="cpu", backend="gloo"))
    assert v["ok"], v
    assert v["cross_session_loops"] >= 1 and v["max_dp"] < 0.05 and v["ranks_equal"]
    assert all(r["frames"] > 0 for r in v["ranks"])
