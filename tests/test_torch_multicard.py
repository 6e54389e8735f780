"""B sequences split over ranks (``liwslam_torch.parallel.multiseq``'s dp
mode) feeding the edge-sharded pose-graph solve (``parallel/dist_runner``'s
``composed`` mode, the port's ``dryrun_multichip``), the port's entry
module, and the reference's last config and result helpers.

One 2-rank gloo run of the composed mode on the CPU (a module fixture,
started in a thread beside the tests that do not need it): B = 4
sequences at the reference entry's small widths (the L track of
tests/test_torch_multiseq.py, seeds 1-4, at rates the widths hold), two a
rank, one chunk of F = 8 frames, the gathered poses seeding a K = 1024 /
E = 4096 graph that both ranks solve edge-sharded.  Its verdict carries
the gathered poses.  Bounds:

(a) the gathered poses equal one process's batched run of all B, bit for
    bit (the step is batch-invariant; rank 0's check), and rank r holds
    sequences 2r, 2r+1;
(b) against the reference's ``multiseq.batched_chunk_fn`` sharded over a
    4-device ``"dp"`` mesh of conftest's virtual CPU devices, from the same
    sequences' states and inputs (simulated and initialized again here from
    the same seeds): every step's positions within 5e-3 m
    (tests/test_torch_multiseq.py's per-step bound);
(c) the composed float32 solve (20 Gauss-Newton, 60 CG iterations) against
    the reference's ``posegraph_dist.solve_pcg_sharded`` on a 2-device
    ``"pg"`` mesh on the same graph: positions within 1e-3 m and the costs
    within 5% + 1e-3 (tests/test_torch_parallel.py's bounds);
(d) the split refuses a B that is not a multiple of W;
(e) ``entry("cpu")``'s step against the reference's ``entry()`` on the
    same example frame: pose, velocity, biases and cost within 1e-3 of
    their size (see the test for why), the same match count and keyframe
    decision;
(f) ``Params.from_yaml``, ``grid_w`` / ``grid_h``, ``FrontendResult.
    tum_poses`` and ``factors.camera_sqrt_info`` against the reference's."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils._pytree import tree_map

from liwslam import config as jconfig
from liwslam.backend import posegraph as jpg
from liwslam.frontend import pipeline as jpl
from liwslam.parallel import multiseq as jms
from liwslam.parallel import posegraph_dist as jpgd
from liwslam.solve import factors as jfac
from liwslam_torch import config as tconfig
from liwslam_torch import entry as tentry
from liwslam_torch.frontend.driver import Frontend as TFrontend
from liwslam_torch.parallel import dist_runner as dr
from liwslam_torch.parallel import multiseq
from tests.test_torch_multiseq import _to_reference

B, F, W = 4, 8, 2


@pytest.fixture(scope="module", autouse=True)
def composed():
    """The composed run's verdict, to come: started in a thread when the
    module's first test starts, so that its ranks run in their processes
    while the tests that do not need it (placed first) run here."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(dr.launch, dr.RunConfig(mode="composed", num_processes=W, device="cpu", backend="gloo",
                                                  widths="tiny", sequences=B, frames=F))


def _gathered(v):
    return (np.asarray(v["gathered_p"], np.float32), np.asarray(v["gathered_q"], np.float32))


def test_split_refuses_b_not_a_multiple_of_w(monkeypatch):
    monkeypatch.setattr(multiseq.dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(multiseq.dist, "get_rank", lambda group=None: 1)
    assert multiseq.shard_sequences([1, 2, 3, 4], None) == [3, 4]
    tree = (torch.arange(4), torch.zeros(4, 8, 3))
    got = multiseq.shard_sequences(tree, None)
    assert torch.equal(got[0], torch.tensor([2, 3])) and got[1].shape == (2, 8, 3)
    _, shard = multiseq.batched_chunk_fn(None, None, None, group=object())
    with pytest.raises(ValueError, match="multiple of the process group"):
        shard((torch.zeros(3), torch.zeros(3, 8)))
    with pytest.raises(ValueError, match="multiple of the process group"):
        multiseq.shard_sequences([1, 2, 3], None)
    with pytest.raises(ValueError, match="split evenly"):
        dr.launch(dr.RunConfig(mode="composed", num_processes=2, device="cpu", backend="gloo", widths="tiny", sequences=3))


def test_entry_matches_reference_entry():
    """The example frame (a 3 m circle of points, gravity along the IMU's
    z, the wheel at rest) from the zero state: a free fall of 1.5 m that
    the 3 LM iterations weigh against the wheel, cost ~1e7, so float32
    reassociation moves the pose by ~2e-4 of its size: p, q, v and the
    biases within 1e-3 of it.  The circle makes every line break a tie (the
    reference's own extraction gives 16, 12 and 10 lines at radii 3.0003,
    3.0 and 2.9997 m), so ulp-level differences in the de-skew move the
    line count; the submap is empty (no match), so they do not move the
    pose: the counts are compared only as positive."""
    import __graft_entry__ as graft

    fn, args = tentry.entry("cpu")
    _, out = fn(*args)
    jfn, jargs = graft.entry()
    _, ref = jax.jit(jfn)(*jargs)
    for name in ("p", "q", "v", "bs", "solve_cost"):
        a, b = getattr(out, name).numpy().astype(np.float64), np.asarray(getattr(ref, name), np.float64)
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max(), (name, a, b)
    for name in ("n_match", "is_keyframe"):
        assert int(getattr(out, name)) == int(getattr(ref, name)), name
    assert int(out.n_match) == 0 and int(out.n_lines) > 0 and int(ref.n_lines) > 0
    assert all(torch.isfinite(t).all() for t in (out.p, out.q, out.v, out.bs))


def _yaml_params(tmp_path, cls):
    path = tmp_path / "params.yaml"
    path.write_text(
        "max_points: 512\nlaser_resolution: 0.1\nline_min_len: 0.25\nenable_camera: false\nFPS: 20.0\n"
        "T_imu_to_wheel: [1, 0, 0, 0.1, 0, 1, 0, 0, 0, 0, 1, 0.5, 0, 0, 0, 1]\nimu_topic: /imu\n"
    )
    return cls.from_yaml(str(path))


@pytest.mark.parametrize("helper", ["from_yaml", "grid", "tum_poses", "camera_sqrt_info"])
def test_helpers_match_reference(helper, tmp_path):
    if helper == "from_yaml":
        t, j = _yaml_params(tmp_path, tconfig.Params), _yaml_params(tmp_path, jconfig.Params)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.max_points == 512 and t.T_imu_to_wheel[3] == 0.1
    elif helper == "grid":
        for preset in ("base", "office", "corridor", "cafe", "market"):
            t, j = getattr(tconfig, preset)(), getattr(jconfig, preset)()
            assert (t.grid_w, t.grid_h) == (j.grid_w, j.grid_h), preset
    elif helper == "tum_poses":
        from liwslam.frontend.driver import FrontendResult as JResult
        from liwslam_torch.frontend.driver import FrontendResult as TResult

        rng = np.random.default_rng(0)
        kw = dict(t_us=np.arange(5), v=np.zeros((5, 3)), bs=np.zeros((5, 6)), is_keyframe=np.zeros(5, bool),
                  n_match=np.zeros(5), n_lines=np.zeros(5), kf_corners=[], kf_indices=np.zeros(0), kf_scans=[])
        p, q = rng.normal(size=(5, 3)).astype(np.float32), rng.normal(0, 0.5, (5, 3)).astype(np.float32)
        T_iw = tconfig.office().mat_T_imu_to_wheel()
        got = TResult(p=p, q=q, **kw).tum_poses(T_iw)
        assert got.shape == (5, 4, 4)
        np.testing.assert_allclose(got, JResult(p=p, q=q, **kw).tum_poses(T_iw), rtol=0, atol=1e-6)
    else:
        from liwslam_torch.frontend import camera_pipeline as tcpl
        from liwslam_torch.sim import world as tsim
        from liwslam_torch.solve import factors as tfac

        cam = dict(enable_camera=True, camera_K=tsim.synthetic_camera_K(848, 480), camera_sigma=(31.8, 25.0))
        t, j = tconfig.office().replace(**cam), jconfig.office().replace(**cam)
        got = tfac.camera_sqrt_info(t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jfac.camera_sqrt_info(j)))
        assert torch.equal(tcpl.make_cam_dyn_cfg(t).sqrt_info, got)
        assert tfac.camera_sqrt_info(t, torch.float64).dtype == torch.float64


def test_from_yaml_without_pyyaml_raises(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        _yaml_params(tmp_path, tconfig.Params)


def test_gathered_poses_match_reference_dp_mesh(composed):
    prm = dr.composed_params("tiny")
    fe = TFrontend(prm, device="cpu")
    seqs = fe.init_sequences([dr.composed_streams(1 + b, prm, "tiny") for b in range(B)])
    states, inputs = seqs.states, fe.stack_sequences(seqs, 0, F)
    jprm = jconfig.office().replace(**tconfig.TINY_WIDTHS, init_solver_max_iterations=8)
    mesh = Mesh(np.asarray(jax.devices()[:B]).reshape(B), ("dp",))
    run, shard = jms.batched_chunk_fn(jfac.make_consts(jprm), jpl.make_dyn_cfg(jprm), jpl.make_static_cfg(jprm), mesh, "dp")
    jin = jpl.FrameInput(*[jnp.asarray(x.numpy()) for x in inputs])
    _, out = run(shard(_to_reference(tree_map(lambda t: t.numpy(), states))), shard(jin))
    gap = np.abs(np.asarray(out.p) - _gathered(composed.result())[0]).max(axis=(0, 2))
    assert (gap <= 5e-3).all(), gap


def test_gathered_poses_equal_one_process_batched_run(composed):
    v = composed.result()
    assert v["ok"], v
    assert v["fe_bit_equal"] and v["fe_max_dp"] == 0.0 and v["fe_finite"] and v["ranks_equal"]
    assert v["reference_modules_loaded"] == []
    assert [r["seeds"] for r in v["ranks"]] == [[1, 2], [3, 4]]
    p, q = _gathered(v)
    assert p.shape == q.shape == (B, F, 3) and np.isfinite(p).all() and np.isfinite(q).all()


def test_composed_solve_matches_reference_sharded_solve(composed):
    v = composed.result()
    prm = dr.composed_params("tiny")
    gr = dr.composed_graph(*_gathered(v), prm.mat_T_imu_to_wheel())
    K, E = len(gr["p"]), len(gr["e_i"])
    g = jpg.empty_graph(K, E)._replace(
        p=jnp.asarray(gr["p"], jnp.float32), q=jnp.asarray(gr["q"], jnp.float32), node_valid=jnp.ones(K, bool),
        e_i=jnp.asarray(gr["e_i"], jnp.int32), e_j=jnp.asarray(gr["e_j"], jnp.int32),
        e_tf=jnp.asarray(gr["e_tf"], jnp.float32), e_weight=jnp.asarray(gr["e_weight"], jnp.float32),
        e_valid=jnp.arange(E) < gr["n_edges"], n_nodes=jnp.asarray(K, jnp.int32),
        n_edges=jnp.asarray(gr["n_edges"], jnp.int32),
    )
    jc = jpg.make_pg_consts(jconfig.office())
    mesh = Mesh(np.asarray(jax.devices()[:W]).reshape(W), ("pg",))
    g2, cost2 = jpgd.solve_pcg_sharded(jpgd.shard_edges(g, mesh, "pg"), jc, mesh, "pg", **dr.SOLVE_ITERS)
    assert (v["K"], v["E"]) == (dr.PG_NODES, gr["n_edges"]) and E == dr.PG_EDGES
    assert abs(v["cost_sharded"] - float(cost2)) < 0.05 * float(cost2) + 1e-3, (v["cost_sharded"], float(cost2))
    assert v["cost_sharded"] < 1e-6 * v["cost_initial"]
    np.testing.assert_allclose(np.asarray(v["p_multi"]), np.asarray(g2.p), rtol=0, atol=1e-3)
    # the graph's correction is far above the bound
    assert v["correction_dp"] > 10 * 1e-3
