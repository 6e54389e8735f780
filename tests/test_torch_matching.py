"""The port's line matching and submap accumulation against liwslam's.

Features are extracted once by the reference package from simulator scans
and handed to both packages as numpy; ``match_lines`` must make the same
matches (same validity mask) with the same endpoints (1e-4 m), and a run
of ``add_scan`` calls must leave the same double-buffered submaps."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from liwslam import config
from liwslam.core import geometry as jgeo
from liwslam.frontend import matching as jmm
from liwslam.frontend import scan as jscan
from liwslam.sim import world as sim
from liwslam_torch.frontend import matching as tmm
from liwslam_torch.frontend import scan as tscan
from tests.test_extract_pallas import _kw

PRM = config.office().replace(max_points=512, max_lines=48, max_corners=16, ref_capacity=256)


@functools.lru_cache(maxsize=None)
def _scans():
    """(features, p, q) of 12 consecutive scans of the L track, extracted
    by the reference package, as numpy."""
    streams = sim.simulate(
        sim.default_track("L"), sim.square_room(obstacles=True), PRM,
        imu_hz=100, wheel_hz=20, laser_hz=5, n_beams=360, noise=True, seed=0,
    )
    ext = jax.jit(functools.partial(jscan.extract_features, **_kw(PRM)))
    out = []
    for k in range(10, 22):
        f = ext(jnp.asarray(streams.laser_points[k]), jnp.asarray(streams.laser_valid[k]))
        p, q = jgeo.log_SE3(jnp.asarray(streams.gt_T_w_imu[k], jnp.float32))
        out.append(([np.asarray(a) for a in f], np.asarray(p), np.asarray(q)))
    return out


def _t(tree):
    return type(tree)(*[_t(v) if isinstance(v, tuple) else torch.as_tensor(np.array(v)) for v in tree])


def _assert_same(t_tree, j_tree, atol):
    for name, tv, jv in zip(j_tree._fields, t_tree, j_tree):
        if isinstance(jv, tuple):
            _assert_same(tv, jv, atol)
        elif np.asarray(jv).dtype == bool or np.issubdtype(np.asarray(jv).dtype, np.integer):
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=name)
        else:
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=atol, err_msg=name)


def test_match_lines_matches_reference():
    Til = PRM.mat_T_imu_to_laser().astype(np.float32)
    scans = _scans()
    feats0, p0, q0 = scans[0]
    jsub = jmm.submap_from_scan(jscan.ScanFeatures(*map(jnp.asarray, feats0)), p0, q0, PRM.ref_capacity)
    tsub = _t(jsub)
    n_matched = 0
    for feats, p, q in scans[1:6]:
        # predicted pose a little off the truth, as dead reckoning gives
        p = p + np.asarray([0.01, -0.005, 0.0], np.float32)
        jm = jmm.match_lines(jsub, jscan.ScanFeatures(*map(jnp.asarray, feats)), p, q, Til, resolution=PRM.laser_resolution)
        tm = tmm.match_lines(
            tsub, tscan.ScanFeatures(*map(torch.as_tensor, feats)), torch.as_tensor(p), torch.as_tensor(q),
            torch.as_tensor(Til), resolution=PRM.laser_resolution,
        )
        valid = np.asarray(jm.valid)
        np.testing.assert_array_equal(tm.valid.numpy(), valid)
        np.testing.assert_allclose(tm.ref_p1.numpy()[valid], np.asarray(jm.ref_p1)[valid], atol=1e-4)
        np.testing.assert_allclose(tm.ref_p2.numpy()[valid], np.asarray(jm.ref_p2)[valid], atol=1e-4)
        n_matched += int(valid.sum())
    assert n_matched > 20


def test_add_scan_sequence_matches_reference():
    """Seed, accumulate, motion-filter skips, the half-phase spawn and the
    promotion (ref_n_accumulation = 4) over 11 scans."""
    Til = PRM.mat_T_imu_to_laser().astype(np.float32)
    kw = dict(ref_n_accumulation=4, motion_filter_p=0.02, motion_filter_q=0.02)
    jpair = jmm.empty_pair(PRM.ref_capacity)
    tpair = tmm.empty_pair(PRM.ref_capacity)
    add = jax.jit(lambda pair, f, p, q: jmm.add_scan(pair, f, p, q, Til, **kw))
    for feats, p, q in _scans()[:11]:
        jpair = add(jpair, jscan.ScanFeatures(*map(jnp.asarray, feats)), p, q)
        tpair = tmm.add_scan(
            tpair, tscan.ScanFeatures(*map(torch.as_tensor, feats)), torch.as_tensor(p), torch.as_tensor(q),
            torch.as_tensor(Til), **kw,
        )
        _assert_same(tpair, jpair, atol=1e-4)
    assert bool(tpair.spawning.active) and int(tpair.ref.n) > 0
