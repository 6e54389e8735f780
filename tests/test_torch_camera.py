"""The port's camera modules against the reference package's.

Inputs are made with numpy and handed to both packages: the textured and
shifted images of tests/test_lk_kernel.py, the blob images of
tests/test_camera.py, and synthetic multi-view observations.  Bounds:
corner response and pyramid within 1e-5 (float32 box sums in another
order), the same corner picks on tie-free images, LK positions within
0.05 px where both trackers keep a track (tests/test_lk_kernel.py's bound)
and equal ``ok`` on interior tracks, triangulated points within 1e-4 m,
reprojection residuals within 1e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from liwslam import config as jconfig
from liwslam.camera import features as jft
from liwslam.camera import tracker as jtrk
from liwslam.camera import triangulation as jtri
from liwslam.core import geometry as jgeo
from liwslam.solve import factors as jfac
from liwslam_torch.camera import features as tft
from liwslam_torch.camera import tracker as ttrk
from liwslam_torch.camera import triangulation as ttri
from liwslam_torch.core import geometry as tgeo
from liwslam_torch.ops import cam_solve, lk
from liwslam_torch.solve import factors as tfac
from tests.test_camera import blob_image
from tests.test_lk_kernel import _shifted, _textured

T = lambda a: torch.as_tensor(np.array(a))


def test_corner_response_and_pyramid_match_reference():
    img = _textured(96, 128, seed=4)
    np.testing.assert_allclose(
        ttrk.shi_tomasi_response(T(img)).numpy(), np.asarray(jtrk.shi_tomasi_response(jnp.asarray(img))),
        rtol=1e-5, atol=1e-5,
    )
    for a, b in zip(ttrk.build_pyramid(T(img), 3), jtrk.build_pyramid(jnp.asarray(img), 3)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("with_tracks", [False, True])
def test_select_features_picks_like_reference(with_tracks):
    rng = np.random.default_rng(2)
    centers = [(x, y) for x, y in zip(rng.uniform(8, 120, 14), rng.uniform(8, 88, 14))]
    img = blob_image(centers) * rng.uniform(0.5, 1.0, (96, 128)).astype(np.float32) ** 0.01
    kw = dict(n_max=12, min_dis=10.0, cell_px=10)
    if with_tracks:
        ex = np.asarray(centers[:4], np.float32) + 0.5
        ev = np.asarray([True, False, True, True])
        kw_j = dict(existing_xy=jnp.asarray(ex), existing_valid=jnp.asarray(ev), budget=jnp.asarray(5, jnp.int32))
        kw_t = dict(existing_xy=T(ex), existing_valid=T(ev), budget=torch.tensor(5, dtype=torch.int32))
    else:
        kw_j = kw_t = {}
    pj, okj = jtrk.select_features(jnp.asarray(img), **kw, **kw_j)
    pt, okt = ttrk.select_features(T(img), **kw, **kw_t)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert okt.sum() >= (3 if with_tracks else 5)


def _lk_case(seed=1, T_=24, H=120, W=160):
    img0 = _textured(H, W)
    img1 = _shifted(img0, 3.6, -2.3)
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(25, W - 25, T_), rng.uniform(25, H - 25, T_)], -1).astype(np.float32)
    valid = np.ones(T_, bool)
    valid[3] = False
    return img0, img1, pts, valid


def test_lk_plain_matches_reference_and_recovers_shift():
    img0, img1, pts, valid = _lk_case()
    kw = dict(radius=7, iters=10, levels=3, max_err=0.1)
    pj, okj = jtrk.lk_track(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts), jnp.asarray(valid), **kw)
    pt, okt = ttrk.lk_track(T(img0), T(img1), T(pts), T(valid), **kw)
    pj, okj, pt, okt = np.asarray(pj), np.asarray(okj), pt.numpy(), okt.numpy()
    # interior tracks: the same decisions, the same positions
    np.testing.assert_array_equal(okt, okj)
    assert okt.sum() >= 0.8 * len(pts) and not okt[3]
    np.testing.assert_allclose(pt[okt], pj[okt], atol=0.05)
    np.testing.assert_allclose(np.median(pt[okt] - pts[okt], axis=0), [3.6, -2.3], atol=0.15)
    # the wrapper takes the plain version for CPU tensors
    pw, okw = lk.lk_track(T(img0), T(img1), T(pts), T(valid), **kw)
    np.testing.assert_array_equal(pw.numpy(), pt)
    np.testing.assert_array_equal(okw.numpy(), okt)


def test_lk_plain_kills_bad_tracks():
    """Unrelated images: most verification residuals fail the gate
    (tests/test_lk_kernel.py::test_lk_kernel_kills_bad_tracks)."""
    H, W = 96, 128
    img0 = _textured(H, W, seed=2)
    img1 = np.random.default_rng(9).standard_normal((H, W)).astype(np.float32)
    rng = np.random.default_rng(3)
    pts = np.stack([rng.uniform(20, W - 20, 16), rng.uniform(20, H - 20, 16)], -1).astype(np.float32)
    valid = np.ones(16, bool)
    valid[0] = False
    p, ok = lk.lk_track(T(img0), T(img1), T(pts), T(valid), radius=7, iters=10, levels=3, max_err=0.1)
    assert not ok[0] and int(ok.sum()) <= 8
    np.testing.assert_array_equal(p[0].numpy(), pts[0])


def test_kernel_wrappers_refuse_non_cuda_tensors():
    meta = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype, device="meta")
    pyr = [meta(8, 8)]
    with pytest.raises(ValueError):
        lk.lk_descent(pyr, pyr, meta(4, 2), meta(4, dtype=torch.bool), meta(1), radius=2, iters=1)
    with pytest.raises(ValueError):
        lk.lk_descent(pyr, pyr, meta(4, 2), meta(4, dtype=torch.bool), meta(1), radius=16, iters=1)
    from liwslam_torch.ops import track_solve as ts

    B, F, Wc = 1, 4, 3
    base = ts.TrackSolveInputs(
        x0=meta(B, 30), free=meta(B, 30), imu_J=meta(B, 15, 15), imu_sqrtP=meta(B, 15, 15),
        imu_X=meta(B, 15), prior_J=meta(B, 15, 15), prior_X=meta(B, 15), T_il=meta(B, 4, 4),
        T_iw=meta(B, 4, 4), wheel=meta(B, 9), scal=meta(B, 6), laser=meta(B, 0, 11),
    )
    inp = cam_solve.CamSolveInputs(
        base=base, Tic=meta(B, 4, 4), sqrt_info=meta(B, 2), world0=meta(B, F, 3), lm_free=meta(B, F),
        obs=meta(B, F, Wc, 2), use=meta(B, F, Wc), ring=meta(B, Wc, 6),
    )
    with pytest.raises(ValueError, match="CUDA"):
        cam_solve.lm_solve_cam_batched(inp)
    assert cam_solve.smem_bytes(48, 8) < cam_solve.SMEM_MAX < cam_solve.smem_bytes(256, 32)


def _views(rng, N=6):
    wp = np.asarray([0.8, -0.4, 3.0])
    Ts, obs = [], []
    for k in range(N):
        Tk = np.eye(4)
        Tk[:3, :3] = np.asarray(jgeo.exp_so3(jnp.asarray(rng.normal(0, 0.05, 3), jnp.float32)))
        Tk[:3, 3] = [0.2 * k, 0.05 * k, rng.normal(0, 0.05)]
        c = np.linalg.inv(Tk) @ np.append(wp, 1.0)
        Ts.append(Tk)
        obs.append(c[:3] / c[2] + np.r_[rng.normal(0, 1e-4, 2), 0.0])
    return wp, np.stack(Ts).astype(np.float32), np.stack(obs).astype(np.float32)


def test_triangulate_svd_matches_reference():
    rng = np.random.default_rng(7)
    wp, Ts, obs = _views(rng)
    valid = np.asarray([True, True, False, True, True, True])
    wj, ej = jtri.triangulate_svd(jnp.asarray(obs), jnp.asarray(Ts), jnp.asarray(valid))
    wt, et = ttri.triangulate_svd(T(obs), T(Ts), T(valid))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-4)
    np.testing.assert_allclose(wt.numpy(), wp, atol=2e-2)
    assert abs(float(et) - float(ej)) < 1e-5


def test_triangulate_ready_matches_reference():
    rng = np.random.default_rng(8)
    F, W = 10, 6
    Tic = np.asarray(jconfig.office().mat_T_imu_to_camera(), np.float32)
    win_p = np.stack([[0.15 * k, 0.02 * k, 0.0] for k in range(W)]).astype(np.float32)
    win_q = np.stack([[0.0, 0.0, 0.03 * k] for k in range(W)]).astype(np.float32)
    T_w_c = np.asarray(jgeo.make_tf(jnp.asarray(win_p), jnp.asarray(win_q))) @ Tic
    world = np.stack([T_w_c[-1] @ np.r_[rng.uniform(-1, 1, 2), rng.uniform(3, 6), 1.0] for _ in range(F)])[:, :3]
    obs = np.zeros((F, W, 2), np.float32)
    for f in range(F):
        for w in range(W):
            c = np.linalg.inv(T_w_c[w]) @ np.append(world[f], 1.0)
            obs[f, w] = c[:2] / c[2] + rng.normal(0, 2e-4, 2)
    mask = rng.random((F, W)) > 0.2
    ids = np.arange(F, dtype=np.int32)
    ids[1] = -1
    ready = np.zeros(F, bool)
    ready[2] = True
    mk = lambda m, a: m.FeatureWindow(
        ids=a(ids), obs=a(obs), obs_mask=a(mask), world=a(np.zeros((F, 3), np.float32)), ready=a(ready),
        next_id=a(np.int32(F)),
    )
    kw = dict(min_obs=4, min_parallax=0.01)
    fj = jft.triangulate_ready(mk(jft, jnp.asarray), jnp.asarray(win_p), jnp.asarray(win_q), jnp.asarray(Tic), **kw)
    ft_ = tft.triangulate_ready(mk(tft, T), T(win_p), T(win_q), T(Tic), **kw)
    np.testing.assert_array_equal(ft_.ready.numpy(), np.asarray(fj.ready))
    assert ft_.ready.sum() >= 5
    np.testing.assert_allclose(ft_.world.numpy(), np.asarray(fj.world), atol=1e-4)
    np.testing.assert_allclose(tft.parallax(mk(tft, T)).numpy(), np.asarray(jft.parallax(mk(jft, jnp.asarray))), atol=1e-6)


def test_camera_residual_matches_reference():
    rng = np.random.default_rng(9)
    prm = jconfig.office()
    Tic = np.asarray(prm.mat_T_imu_to_camera(), np.float32)
    si = np.asarray(jfac.camera_sqrt_info(prm))
    p, q = rng.normal(0, 0.5, (16, 3)).astype(np.float32), rng.normal(0, 0.3, (16, 3)).astype(np.float32)
    wpt = rng.normal(0, 3.0, (16, 3)).astype(np.float32)
    obs = rng.normal(0, 0.3, (16, 2)).astype(np.float32)
    rj = np.stack([
        np.asarray(jfac.camera_residual(*(jnp.asarray(a[i]) for a in (p, q, wpt, obs)), jnp.asarray(Tic), jnp.asarray(si)))
        for i in range(16)
    ])
    rt = tfac.camera_residual(T(p), T(q), T(wpt), T(obs), T(Tic), T(si)).numpy()
    scale = np.abs(rj).max(1, keepdims=True) + 1.0
    np.testing.assert_allclose(rt / scale, rj / scale, atol=1e-5)


def _feature_windows(drop_from=None):
    """tests/test_camera_features.py's scene (8 points, a camera sliding
    along x over W = 6 frames, F = 16 slots), fed frame by frame to both
    packages' shift + push_frame; the window poses (IMU = camera)."""
    from tests import test_camera_features as tcf

    pts, poses = tcf._make_scene()
    n = len(pts)
    jfw, tfw = jft.empty_window(tcf.F, tcf.W), tft.empty_window(tcf.F, tcf.W)
    for k in range(tcf.W):
        ids = np.full(n, -2, np.int32) if k == 0 else np.arange(n, dtype=np.int32)
        valid = np.ones(n, bool)
        if drop_from is not None and k >= drop_from:
            valid[0] = False
        obs = tcf._observe(pts, poses[k]).astype(np.float32)
        assert np.array_equal(np.asarray(jft.assigned_ids(jfw, jnp.asarray(ids), jnp.asarray(valid))),
                              tft.assigned_ids(tfw, T(ids), T(valid)).numpy())
        jfw = jft.push_frame(jft.shift(jfw), jnp.asarray(ids), jnp.asarray(obs), jnp.asarray(valid))
        tfw = tft.push_frame(tft.shift(tfw), T(ids), T(obs), T(valid))
    wp = np.stack([tgeo.log_SE3_np(P)[0] for P in poses]).astype(np.float32)
    wq = np.stack([tgeo.log_SE3_np(P)[1] for P in poses]).astype(np.float32)
    return pts, jfw, tfw, wp, wq


def _assert_windows_equal(tfw, jfw, atol=0.0):
    for name in ("ids", "obs_mask", "ready", "next_id"):
        np.testing.assert_array_equal(getattr(tfw, name).numpy(), np.asarray(getattr(jfw, name)), err_msg=name)
    for name in ("obs", "world"):
        np.testing.assert_allclose(getattr(tfw, name).numpy(), np.asarray(getattr(jfw, name)), rtol=0, atol=atol, err_msg=name)


def test_feature_window_bookkeeping_matches_reference():
    """push_frame / assigned_ids / shift (every frame of the scene), and
    pop_oldest freeing a lost track (landmark 0 seen once): equal."""
    _, jfw, tfw, _, _ = _feature_windows()
    _assert_windows_equal(tfw, jfw)
    _, jfw, tfw, _, _ = _feature_windows(drop_from=1)
    for _ in range(6):
        jfw, tfw = jft.pop_oldest(jfw), tft.pop_oldest(tfw)
        _assert_windows_equal(tfw, jfw)
    assert int(tfw.ids[0]) == -1 and not tfw.obs_mask.any()


def test_reprojection_filter_and_refinement_match_reference():
    """reproj_error, filter_outliers (one landmark moved 0.5 m), the
    residual rows (all frames and the latest only) and refine_window
    (landmark-only refinement of noisy points, tests/test_camera_features.py
    :116-147) against the reference: errors and rows within 1e-5, refined
    points within 1e-4 m, and the refinement's 5x gain."""
    pts, jfw, tfw, wp, wq = _feature_windows()
    Tic = np.eye(4, dtype=np.float32)
    jfw = jft.triangulate_ready(jfw, jnp.asarray(wp), jnp.asarray(wq), jnp.asarray(Tic))
    tfw = tft.triangulate_ready(tfw, T(wp), T(wq), T(Tic))
    _assert_windows_equal(tfw, jfw, atol=1e-4)
    tfw = tfw._replace(world=torch.as_tensor(np.asarray(jfw.world)))  # the same points from here on
    np.testing.assert_allclose(
        tft.reproj_error(tfw, T(wp), T(wq), T(Tic)).numpy(),
        np.asarray(jft.reproj_error(jfw, jnp.asarray(wp), jnp.asarray(wq), jnp.asarray(Tic))), rtol=0, atol=1e-5,
    )
    moved = np.asarray(jfw.world).copy()
    moved[2] += [0.5, 0.5, 0.0]
    jb, tb = jfw._replace(world=jnp.asarray(moved)), tfw._replace(world=T(moved))
    jf = jft.filter_outliers(jb, jnp.asarray(wp), jnp.asarray(wq), jnp.asarray(Tic), max_err=0.01)
    tf = tft.filter_outliers(tb, T(wp), T(wq), T(Tic), max_err=0.01)
    _assert_windows_equal(tf, jf)
    assert not bool(tf.ready[2]) and bool(tf.ready[3])

    W = wp.shape[0]
    jwin = jfac.WindowState(p=jnp.asarray(wp), q=jnp.asarray(wq), v=jnp.zeros((W, 3)), bs=jnp.zeros((W, 6)))
    twin = tfac.WindowState(p=T(wp), q=T(wq), v=torch.zeros(W, 3), bs=torch.zeros(W, 6))
    sq = np.asarray([100.0, 100.0], np.float32)
    noisy = moved.copy()
    noisy[:] = np.asarray(jfw.world) + np.random.default_rng(1).normal(0, 0.05, moved.shape).astype(np.float32) * np.asarray(jfw.ready)[:, None]
    jn, tn = jfw._replace(world=jnp.asarray(noisy)), tfw._replace(world=T(noisy))
    for latest in (False, True):
        np.testing.assert_allclose(
            tft.camera_residual_rows(tn, twin, T(Tic), T(sq), latest_only=latest).numpy(),
            np.asarray(jft.camera_residual_rows(jn, jwin, jnp.asarray(Tic), jnp.asarray(sq), latest_only=latest)),
            rtol=1e-5, atol=1e-4,
        )
    jr, _, jcost = jax.jit(lambda fw, win: jft.refine_window(fw, win, jnp.asarray(Tic), jnp.asarray(sq), free_frame_mask=jnp.zeros((W, 15))))(jn, jwin)
    tr, _, tcost = tft.refine_window(tn, twin, T(Tic), T(sq), free_frame_mask=torch.zeros(W, 15))
    n = len(pts)
    np.testing.assert_allclose(tr.world.numpy()[:n], np.asarray(jr.world)[:n], rtol=0, atol=1e-4)
    before = np.abs(noisy[:n] - pts).max()
    assert np.abs(tr.world.numpy()[:n] - pts).max() < 0.2 * before
    assert float(tcost) == pytest.approx(float(jcost), rel=1e-2, abs=1e-6)


def test_two_view_helpers_match_reference():
    """triangulate_two_view (tests/test_camera.py:49-62) and update_scale's
    epipolar gate with one corrupted match
    (tests/test_camera_features.py:150-170): depths within 1e-4 relative,
    the same inliers."""
    from tests import test_camera_features as tcf

    pts, poses = tcf._make_scene()
    h = lambda c: np.concatenate([c, np.ones((len(c), 1))], -1).astype(np.float32)
    h1, h2 = h(tcf._observe(pts, poses[0])), h(tcf._observe(pts, poses[1]))
    h2[4, :2] += 0.3
    tf12 = (np.linalg.inv(poses[0]) @ poses[1]).astype(np.float32)
    valid = np.ones(len(pts), bool)
    js, jok = jtri.update_scale(jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(valid), jnp.asarray(tf12))
    ts_, tok = ttri.update_scale(T(h1), T(h2), T(valid), T(tf12))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert not bool(tok[4]) and bool(tok[[0, 1, 2, 3, 5, 6, 7]].all())
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js), rtol=1e-4, atol=1e-5)

    wp = np.asarray([1.0, 0.5, 4.0])
    T2 = np.eye(4)
    T2[:3, 3] = [0.3, 0.0, 0.0]
    p2 = np.linalg.inv(T2) @ np.append(wp, 1.0)
    c1, c2 = (wp / wp[2]).astype(np.float32), (p2[:3] / p2[2]).astype(np.float32)
    s_t = float(ttri.triangulate_two_view(T(c1), T(c2), T(T2.astype(np.float32))))
    s_j = float(jtri.triangulate_two_view(jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(T2, jnp.float32)))
    assert s_t == pytest.approx(s_j, rel=1e-5) and s_t == pytest.approx(4.0, rel=1e-4)
