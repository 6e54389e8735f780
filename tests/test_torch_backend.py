"""The port's back end (loop detection, keyframe manager, checkpoints)
against the reference package's, on the CPU.

Same seeded numpy inputs through both packages; the reference's device
functions run jitted, as its keyframe manager runs them (XLA compiles a
division by a Python constant as a multiply by its float32 reciprocal,
which the port reproduces).  Tolerances:

- descriptors: ``n`` and ``valid`` equal; kept corners, points and angles
  within 1e-6 (float32 rounding of the same operations; XLA may fuse a
  multiply-add); ``dist_q`` and the bitmap equal except where a distance
  lies within 1e-5 bins of a .5 rounding tie;
- ``score_pairs``: counts and bins exactly equal, on the reference's own
  descriptor arrays carried across;
- host functions (correspondences, Kabsch, overlap): identical outputs;
- managers on the same keyframe feed: the same loop pairs and rejections,
  trajectories and ``modify_delta_tf`` within 1e-4 (float32 solves);
- checkpoints: a reference checkpoint resumed in the port agrees with the
  reference's own continuation within 1e-4; the port's save/load resume is
  exact on the CPU."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from liwslam.backend import loop as jloop
from liwslam.backend import manager as jkm
from liwslam.core import geometry as jgeo
from liwslam.utils import checkpoint as jckpt
from liwslam_torch import convert
from liwslam_torch.backend import loop as tloop
from liwslam_torch.backend import manager as tkm
from liwslam_torch.utils import checkpoint as tckpt
from tests.test_backend import _drifting_square, make_constellation, prm_small, se2
from tests.test_backend_device import corner_soup

NP = 5  # probes, as the manager's loop_probe_count


def _tprm(prm):
    return convert.params_from_reference(dataclasses.asdict(prm))


def _carry(mf):
    """A reference MapFeature (leading batch dims allowed) as the port's,
    on the CPU; uint32 bitmaps keep their bits as int32."""
    t = lambda a: torch.as_tensor(np.array(a).view(np.int32) if np.asarray(a).dtype == np.uint32 else np.array(a))
    return tloop.MapFeature(*[t(getattr(mf, f)) for f in tloop.MapFeature._fields[:6]], index=-1)


def test_descriptor_build_matches_reference():
    prm = prm_small()
    P = prm.map_corner_capacity
    pts = corner_soup(np.random.default_rng(0))
    mask = np.ones(len(pts), bool)
    mask[::7] = False  # masked candidates are skipped
    kw = dict(d_res=prm.d_res, capacity=P, n_dist_bins=prm.n_dist_bins)

    jk, jn = jax.jit(lambda p, m: jloop.dedup_corners_device(p, m, prm.d_res, P))(jnp.asarray(pts), jnp.asarray(mask))
    tk, tn = tloop.dedup_corners_device(pts, mask, prm.d_res, P)
    assert tn == int(jn)
    np.testing.assert_allclose(tk[:tn], np.asarray(jk)[:tn], rtol=0, atol=1e-6)

    perm = np.random.default_rng(7).permutation(P).astype(np.int32)
    jm = jax.jit(lambda p, m: jloop.build_map_feature_device(p, m, jnp.eye(4), **kw, perm=jnp.asarray(perm)))(
        jnp.asarray(pts), jnp.asarray(mask)
    )
    tm = tloop.build_map_feature_device(pts, mask, np.eye(4), **kw, perm=perm, device="cpu")
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    np.testing.assert_allclose(tm.points.numpy(), np.asarray(jm.points), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.ang.numpy(), np.asarray(jm.ang), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tm.origin.numpy(), np.eye(4, dtype=np.float32))
    dq_t, dq_j = tm.dist_q.numpy(), np.asarray(jm.dist_q)
    pt = np.asarray(jm.points, np.float64)
    frac = np.linalg.norm(pt[None, :, :2] - pt[:, None, :2], axis=-1) / prm.d_res % 1.0
    flips = dq_t != dq_j
    assert np.all(np.abs(frac[flips] - 0.5) < 1e-5) and np.all(np.abs(dq_t - dq_j) <= 1)
    rows = ~flips.any(1)
    np.testing.assert_array_equal(tm.bitmap.numpy()[rows], np.asarray(jm.bitmap).view(np.int32)[rows])
    assert rows.sum() >= P - 2

    # the host oracles, numpy in both packages
    hj = jloop.build_map_feature([pts[:40], pts[40:]], np.eye(4), 3, seed=1, **kw)
    ht = tloop.build_map_feature([pts[:40], pts[40:]], np.eye(4), 3, seed=1, **kw, device="cpu")
    for f in tloop.MapFeature._fields[:6]:
        np.testing.assert_array_equal(getattr(ht, f).numpy(), np.asarray(_carry(hj)[tloop.MapFeature._fields.index(f)]))
    assert ht.index == hj.index == 3


def _constellations(P, M=8):
    """m1: a constellation seen moved by an SE(2) transform; M candidate
    maps: the world constellation under different shuffles and subsets,
    one moved again, and two unrelated ones."""
    prm = prm_small()
    rng = np.random.default_rng(P)
    world = make_constellation(rng, 14)
    T = se2(1.5, -2.0, 0.8)
    moved = (T[:3, :3] @ world.T).T + T[:3, 3]
    kw = dict(d_res=prm.d_res, capacity=P, n_dist_bins=prm.n_dist_bins)
    m1 = jloop.build_map_feature([moved], np.eye(4), 0, seed=1, **kw)
    T2 = se2(-0.7, 0.3, -2.2)
    sets = [[world], [world[:11]], [world[3:]], [(T2[:3, :3] @ world.T).T + T2[:3, 3]], [world[::-1]], [world[:9]]]
    sets += [[make_constellation(np.random.default_rng(99 + s), 12)] for s in range(M - len(sets))]
    m2 = [jloop.build_map_feature(c, np.eye(4), i + 1, seed=i + 2, **kw) for i, c in enumerate(sets)]
    stack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[m._replace(index=0) for m in m2])
    return prm, m1._replace(index=0), stack


@pytest.mark.parametrize("P", [32, 128])
def test_score_pairs_equals_reference(P):
    prm, m1, m2 = _constellations(P)
    kw = dict(a_res=prm.a_res, n_angle_bins=prm.n_angle_bins, min_match_threshold=prm.laser_loop_min_match_threshold)
    probes = jnp.arange(NP, dtype=jnp.int32)
    jc, jb = jax.jit(lambda a, b: jax.vmap(lambda m: jloop.score_pairs(a, m, probes, **kw))(b))(m1, m2)
    tc, tb = tloop.score_pairs(_carry(m1), _carry(m2), torch.arange(NP), **kw)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert tc.max() >= 10 and tc[6:].max() <= 6  # the moved world matches; unrelated maps do not
    # one candidate without the batch dim
    c1, b1 = tloop.score_pairs(_carry(m1), tloop.MapFeature(*[f[3] for f in _carry(m2)[:6]], -1), torch.arange(NP), **kw)
    np.testing.assert_array_equal(c1.numpy(), np.asarray(jc)[3])
    np.testing.assert_array_equal(b1.numpy(), np.asarray(jb)[3])


def test_host_functions_are_identical():
    prm, m1, m2 = _constellations(32)
    kw = dict(a_res=prm.a_res, n_angle_bins=prm.n_angle_bins)
    counts, bins = jax.jit(
        lambda a, b: jloop.score_pairs(a, b, jnp.arange(NP, dtype=jnp.int32), min_match_threshold=4, **kw)
    )(m1, jax.tree_util.tree_map(lambda x: x[0], m2))
    pi, pj = np.unravel_index(np.argmax(np.asarray(counts)), counts.shape)
    args = (int(pi), int(pj), int(np.asarray(bins)[pi, pj]))
    m2_0 = jax.tree_util.tree_map(lambda x: x[0], m2)
    t1, t2 = _carry(m1), tloop.MapFeature(*[f[0] for f in _carry(m2)[:6]], -1)
    for jfn, tfn in (
        (jloop.extract_correspondences, tloop.extract_correspondences),
        (jloop._extract_correspondences_ref, tloop._extract_correspondences_ref),
    ):
        a = jfn(m1, m2_0, *args, **kw)
        b = tfn(t1, t2, *args, **kw)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    p1, p2 = a
    assert len(p1) >= 10
    np.testing.assert_array_equal(tloop.kabsch_2d(p1, p2), jloop.kabsch_2d(p1, p2))
    rng = np.random.default_rng(4)
    l1, l2 = rng.uniform(-3, 3, (6, 3)), rng.uniform(-3, 3, (6, 3))
    np.testing.assert_array_equal(tloop.densify_lines(l1, l2, 0.1), jloop.densify_lines(l1, l2, 0.1))
    s1 = jloop.densify_lines(l1, l2, 0.1)
    for T, rate in ((se2(0.02, -0.01, 0.01), 0.5), (se2(1.0, 0.5, 0.4), 0.5), (np.eye(4), 1.0)):
        assert tloop.verify_loop_overlap(s1, s1[::2], T, 0.1, rate) == jloop.verify_loop_overlap(s1, s1[::2], T, 0.1, rate)
    assert tloop.verify_loop_overlap(s1, s1, np.eye(4), 0.1, 0.9)
    assert not tloop.verify_loop_overlap(s1, np.zeros((0, 3)), np.eye(4), 0.1, 0.5)


def _feed(mgr, true_T, odo_T, world, t0_us=0, session=0, ks=None, revisit=0):
    """The drifting-square feed of tests/test_backend.py (with ``revisit``
    keyframes near the start after the lap) and of
    tests/test_checkpoint_multisession.py (``ks``, ``session``)."""
    ks = range(len(true_T)) if ks is None else ks
    poses = [(true_T[k], odo_T[k]) for k in ks]
    poses += [(true_T[k], odo_T[-1] @ (np.linalg.inv(true_T[-1]) @ true_T[k])) for k in range(revisit)]
    for n, (T_true, T_odo) in enumerate(poses):
        T_drift = T_odo @ np.linalg.inv(T_true)
        vis = world[np.linalg.norm(world[:, :2] - T_true[:2, 3], axis=1) < 6.0]
        corners = (T_drift[:3, :3] @ vis.T).T + T_drift[:3, 3]
        pp, qq = jgeo.log_SE3(jnp.asarray(T_odo, jnp.float32))
        mgr.add_keyframe(
            t_us=t0_us + int(n * 2e6), p=np.asarray(pp), q=np.asarray(qq), corners=corners,
            scan_lines=(np.zeros((0, 3)), np.zeros((0, 3))), session=session,
        )


def _assert_managers_agree(jm, tm, atol=1e-4):
    pairs = lambda m: [(int(a), int(b)) for a, b, _ in m.loops_found]
    assert pairs(tm) == pairs(jm)
    assert tm.loop_rejections == jm.loop_rejections
    for (_, _, a), (_, _, b) in zip(jm.loops_found, tm.loops_found):
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)
    (jt, jT), (tt, tT) = jm.trajectory(), tm.trajectory()
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tT, jT, rtol=0, atol=atol)
    for s in {kf.session for kf in jm.keyframes}:
        np.testing.assert_allclose(tm.modify_delta_tf(s), jm.modify_delta_tf(s), rtol=0, atol=atol)


def test_manager_matches_reference():
    prm = prm_small().replace(pose_graph_solve_interval_s=0.0)
    world = make_constellation(np.random.default_rng(0), 16, scale=5.0)
    true_T, odo_T = _drifting_square(n_per_side=6, drift=0.015)
    jm, tm = jkm.KeyframeManager(prm), tkm.KeyframeManager(_tprm(prm), device="cpu")
    for m in (jm, tm):
        _feed(m, true_T, odo_T, world, revisit=3)
    assert len(tm.loops_found) >= 1 and len(tm.perf["solves"]) >= 1
    _assert_managers_agree(jm, tm)


def test_cross_session_matches_reference():
    """tests/test_checkpoint_multisession.py's two robots on one square:
    the second session aligns through a cross-session loop."""
    prm = prm_small().replace(pose_graph_solve_interval_s=0.0, loop_detect_min_interval=1000)
    world = make_constellation(np.random.default_rng(0), 16, scale=5.0)
    true_T, odo_T = _drifting_square(n_per_side=6, drift=0.0)
    odo1 = np.einsum("ij,kjl->kil", se2(0.7, -0.4, 0.15), true_T)
    jm, tm = jkm.KeyframeManager(prm), tkm.KeyframeManager(_tprm(prm), device="cpu")
    for m in (jm, tm):
        _feed(m, true_T, odo_T, world, session=0)
        _feed(m, true_T[:8], odo1[:8], world, t0_us=10**10, session=1)
    assert len(tm.loops_found) >= 1 and tm.sessions_coregistered(0, 1)
    _assert_managers_agree(jm, tm)


def test_checkpoints_resume_across_packages(tmp_path):
    """A reference save_manager checkpoint loads into the port's
    load_manager and both continue the feed alike; the port's own
    save/load resume continues bitwise like the uninterrupted port run."""
    prm = prm_small().replace(pose_graph_solve_interval_s=0.0)
    tprm = _tprm(prm)
    world = make_constellation(np.random.default_rng(1), 16, scale=5.0)
    true_T, odo_T = _drifting_square(n_per_side=6, drift=0.015)
    K = len(true_T)
    first, rest = range(K // 2), range(K // 2, K)

    jm = jkm.KeyframeManager(prm)
    _feed(jm, true_T, odo_T, world, ks=first)
    jckpt.save_manager(str(tmp_path / "ref"), jm)
    tm = tckpt.load_manager(str(tmp_path / "ref"), tprm, device="cpu")
    assert len(tm.keyframes) == len(jm.keyframes) and len(tm.seq_edges) == len(jm.seq_edges)
    for f in tm._POOL_FIELDS:
        a = np.asarray(jm._mf_pool[f])[: jm._mf_slots]
        np.testing.assert_array_equal(tm._mf_pool[f][: tm._mf_slots].numpy(), a.view(np.int32) if f == "bitmap" else a)

    # the port's own checkpoint of the loaded manager, and its resume
    tckpt.save_manager(str(tmp_path / "port"), tm)
    tm2 = tckpt.load_manager(str(tmp_path / "port"), tprm, device="cpu")
    for m in (jm, tm, tm2):
        _feed(m, true_T, odo_T, world, t0_us=10**9, ks=rest, revisit=3)
    assert len(jm.loops_found) >= 1
    _assert_managers_agree(jm, tm)
    assert [l[:2] for l in tm2.loops_found] == [l[:2] for l in tm.loops_found]
    np.testing.assert_array_equal(tm2.trajectory()[1], tm.trajectory()[1])
    # the port writes the reference's layout: the reference loads it back
    tckpt.save_manager(str(tmp_path / "port_end"), tm)
    jm2 = jckpt.load_manager(str(tmp_path / "port_end"), prm)
    np.testing.assert_array_equal(jm2.trajectory()[1], tm.trajectory()[1])
    np.testing.assert_array_equal(np.asarray(jm2._mf_pool["bitmap"])[: jm2._mf_slots].view(np.int32),
                                  tm._mf_pool["bitmap"][: tm._mf_slots].numpy())


def test_track_state_snapshot_loads_across_packages(tmp_path):
    """save_pytree / load_pytree: the reference's TrackState snapshot loads
    into the port's TrackState (the same leaves in the same order, each
    leaf's dtype kept) and the port's own round trip is exact."""
    from liwslam import config as jconfig
    from liwslam.frontend import pipeline as jpl
    from liwslam_torch import config as tconfig
    from liwslam_torch.frontend import pipeline as tpl

    rng = np.random.default_rng(6)
    p, q, v, bs = (rng.normal(size=n).astype(np.float32) for n in (3, 3, 3, 6))
    js = jpl.init_track_state(p, q, v, bs, jpl.make_static_cfg(jconfig.office()))
    js = js._replace(win=js.win._replace(p=js.win.p + 1.5))
    jckpt.save_pytree(str(tmp_path / "ref.npz"), js)
    T = lambda a: torch.as_tensor(a)
    template = tpl.init_track_state(T(p), T(q), T(v), T(bs), tpl.make_static_cfg(tconfig.office()))
    ts = tckpt.load_pytree(str(tmp_path / "ref.npz"), template)
    leaves_j = jax.tree_util.tree_leaves(js)
    leaves_t = tckpt._leaves(ts)
    assert len(leaves_t) == len(leaves_j) == len(tckpt._leaves(template))
    for a, b, t in zip(leaves_j, leaves_t, tckpt._leaves(template)):
        assert b.dtype == t.dtype and b.shape == t.shape
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(b.numpy().dtype))
    tckpt.save_pytree(str(tmp_path / "port.npz"), ts)
    back = tckpt.load_pytree(str(tmp_path / "port.npz"), template)
    for a, b in zip(tckpt._leaves(ts), tckpt._leaves(back)):
        assert torch.equal(a, b)
