"""The port's de-skew and line/corner extraction against liwslam's.

``liwslam_torch.frontend.scan.extract_features`` (on CPU tensors: the
plain version of kernel B2, then corner pairing) against the reference
package's XLA chain ``liwslam.frontend.scan.extract_features`` on
simulator scans, with the alignment and miss budget of
tests/test_extract_pallas.py: f32 gate decisions at spans exactly on
``min_len`` / ``max_dis`` may flip, so lines and corners are aligned in scan
order and a small share of unmatched rows is allowed."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from liwslam import config
from liwslam.frontend import scan as jscan
from liwslam.sim import world as sim
from liwslam_torch.frontend import scan as tscan
from tests.test_extract_pallas import _greedy_align, _kw


@functools.lru_cache(maxsize=None)
def _reference(prm):
    # one jitted program per configuration: eager JAX compiles every op
    return jax.jit(functools.partial(jscan.extract_features, **_kw(prm)))


def _both(points, valid, prm):
    kw = _kw(prm)
    a = _reference(prm)(jnp.asarray(points), jnp.asarray(valid))
    b = tscan.extract_features(torch.as_tensor(points), torch.as_tensor(valid), **kw)
    a = [np.asarray(t) for t in a]
    b = [t.numpy() for t in b]
    return a, b


def _compare(frames, prm, atol, miss_frac):
    tot_lines = line_miss = tot_corners = corner_miss = 0
    for points, valid in frames:
        (ap1, ap2, alv, ac, acv), (bp1, bp2, blv, bc, bcv) = _both(points, valid, prm)
        assert abs(int(alv.sum()) - int(blv.sum())) <= 1
        assert abs(int(acv.sum()) - int(bcv.sum())) <= 2
        ra = np.concatenate([ap1[alv], ap2[alv]], 1)
        rb = np.concatenate([bp1[blv], bp2[blv]], 1)
        _, miss = _greedy_align(ra, rb, atol)
        tot_lines += max(len(ra), len(rb))
        line_miss += miss
        _, cmiss = _greedy_align(ac[acv], bc[bcv], atol)
        tot_corners += max(int(acv.sum()), int(bcv.sum()))
        corner_miss += cmiss
        # rows past the winners are zero in both packages
        np.testing.assert_array_equal(bp1[~blv], 0.0)
    assert tot_lines > 0
    assert line_miss <= max(2, miss_frac * tot_lines), (line_miss, tot_lines)
    assert corner_miss <= max(2, 0.05 * tot_corners), (corner_miss, tot_corners)


@pytest.mark.parametrize("noise", [False, True])
def test_extract_matches_reference_360_beams(noise):
    prm = config.office().replace(max_points=512, max_lines=48, max_corners=16)
    streams = sim.simulate(
        sim.default_track("L"), sim.square_room(obstacles=True), prm,
        imu_hz=100, wheel_hz=20, laser_hz=5, n_beams=360, noise=noise, seed=0,
    )
    frames = [(streams.laser_points[k], streams.laser_valid[k]) for k in range(0, len(streams.laser_t_us), 7)]
    assert len(frames) >= 5
    _compare(frames, prm, atol=2e-3, miss_frac=0.02)


def test_extract_matches_reference_1080_beams():
    """One bench-like frame: 1080 noisy beams in the rich 12 m room; atol
    1 cm (short spans' TLS directions are f32-rounding-dominated)."""
    prm = config.office().replace(max_points=1152, max_lines=64, max_corners=16)
    streams = sim.simulate(
        sim.TwistTrack([(4.0, 0.3, 0.0, 0.2)]), sim.square_room(size=12.0, obstacles=True, rich=True), prm,
        imu_hz=100, wheel_hz=20, laser_hz=5, n_beams=1080, noise=True, seed=3,
    )
    k = len(streams.laser_t_us) // 2
    _compare([(streams.laser_points[k], streams.laser_valid[k])], prm, atol=1e-2, miss_frac=0.03)


def test_degenerate_scans():
    prm = config.office().replace(max_points=256, max_lines=16, max_corners=8)
    (_, _, alv, _, acv), (_, _, blv, _, bcv) = _both(np.zeros((256, 3), np.float32), np.zeros(256, bool), prm)
    assert alv.sum() == blv.sum() == 0 and acv.sum() == bcv.sum() == 0
    # one clean straight wall: exactly one line, no corners, same endpoints
    x = np.linspace(0.0, 2.0, 256)
    wall = np.stack([x, np.ones_like(x), np.zeros_like(x)], -1).astype(np.float32)
    (ap1, ap2, alv, _, acv), (bp1, bp2, blv, _, bcv) = _both(wall, np.ones(256, bool), prm)
    assert alv.sum() == blv.sum() == 1 and bcv.sum() == 0
    np.testing.assert_allclose(bp1[blv], ap1[alv], atol=1e-5)
    np.testing.assert_allclose(bp2[blv], ap2[alv], atol=1e-5)


def test_deskew_matches_reference():
    rng = np.random.default_rng(4)
    pts = rng.normal(0, 3, (360, 3)).astype(np.float32)
    t = np.linspace(-0.025, 0.0, 360).astype(np.float32)
    for lin, ang in (([0.3, -0.1, 0.0], [0.0, 0.0, 0.8]), ([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])):
        lin, ang = np.asarray(lin, np.float32), np.asarray(ang, np.float32)
        a = np.asarray(jscan.deskew(*[jnp.asarray(v) for v in (pts, t, lin, ang)]))
        b = tscan.deskew(*[torch.as_tensor(v) for v in (pts, t, lin, ang)]).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
