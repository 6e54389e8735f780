"""The port's IMU and wheel preintegration against the reference package.

Seeded numpy samples through ``liwslam.ops.preint_parallel.
imu_interval_parallel`` / ``liwslam.frontend.preintegration.wheel_*`` and
their counterparts in ``liwslam_torch.frontend.preintegration``; agreement
to 1e-4 relative (the two log-depth trees multiply in another order; an
absolute floor covers entries that are zero up to round-off)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from liwslam import config as jcfg
from liwslam.frontend import preintegration as jpre
from liwslam.ops import preint_parallel as jpp
from liwslam_torch import config as tcfg
from liwslam_torch.frontend import preintegration as tpre

REL = 1e-4


def _close(t, j, floor):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=REL, atol=floor)


def _samples(rng, n, hz=200.0):
    t = (np.arange(1, n + 1) * 1e6 / hz).astype(np.int32)
    acc = (rng.normal(0, 0.5, (n, 3)) + [0.2, 0.0, 9.8]).astype(np.float32)
    gyro = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    return acc, gyro, t


@pytest.mark.parametrize("n_valid,primed", [(32, True), (19, True), (8, False), (0, True)])
def test_imu_interval_matches_reference(n_valid, primed):
    rng = np.random.default_rng(n_valid)
    acc, gyro, t = _samples(rng, 32)
    mask = np.arange(32) < n_valid
    t_end = int(t[max(n_valid - 1, 0)]) + 3000
    ba = np.asarray([0.05, -0.02, 0.01], np.float32)
    bw = np.asarray([0.002, 0.0, -0.001], np.float32)
    held = (np.asarray([0.1, 0.2, 9.8], np.float32), np.asarray([0.0, 0.01, 0.1], np.float32))

    jc = jpre.imu_reset(0, jnp.asarray(ba), jnp.asarray(bw))
    tc = tpre.imu_reset(0, torch.as_tensor(ba), torch.as_tensor(bw))
    if primed:
        jc = jc._replace(last_acc=jnp.asarray(held[0]), last_gyro=jnp.asarray(held[1]), has_sample=jnp.asarray(True))
        tc = tc._replace(
            last_acc=torch.as_tensor(held[0]), last_gyro=torch.as_tensor(held[1]),
            has_sample=torch.ones((), dtype=torch.bool),
        )
    jo = jpp.imu_interval_parallel(
        jc, jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(t), jnp.asarray(mask), t_end,
        jpre.imu_noise_Q(jcfg.base()),
    )
    to = tpre.imu_interval_parallel(
        tc, torch.as_tensor(acc), torch.as_tensor(gyro), torch.as_tensor(t), torch.as_tensor(mask),
        torch.tensor(t_end, dtype=torch.int32), tpre.imu_noise_Q(tcfg.base()),
    )
    _close(to.X, jo.X, 1e-6)
    _close(to.J, jo.J, 1e-6)
    _close(to.P, jo.P, 1e-9)
    _close(to.Dt, jo.Dt, 1e-7)
    assert int(to.last_t_us) == int(jo.last_t_us)
    assert bool(to.has_sample) == bool(jo.has_sample)
    np.testing.assert_array_equal(to.last_acc.numpy(), np.asarray(jo.last_acc))
    jr, tr = jpre.imu_result(jo), tpre.imu_result(to)
    # the whitener's entries reach ~1e4; its floor scales with them
    _close(tr.sqrt_inverse_P, jr.sqrt_inverse_P, 1e-4 * float(np.abs(np.asarray(jr.sqrt_inverse_P)).max()))
    rebased = tpre.imu_rebase(to, torch.tensor(t_end, dtype=torch.int32))
    assert int(rebased.last_t_us) == int(jpre.imu_rebase(jo, t_end).last_t_us)


def _wheel_stream(rng, n=8, hz=20.0):
    """Absolute odometry poses along a noisy planar arc (n samples)."""
    t = (np.arange(1, n + 1) * 1e6 / hz).astype(np.int32)
    t[3] = t[2] + 20000  # one pair closer than 50 ms: skipped by both
    yaw = np.cumsum(rng.normal(0.05, 0.02, n))
    xy = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw)], -1) * 0.03, 0)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, 0, 0], T[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    T[:, 1, 0], T[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    T[:, :2, 3] = xy
    return T, t


@pytest.mark.parametrize("n_valid", [8, 5, 0])
def test_wheel_interval_matches_reference(n_valid):
    rng = np.random.default_rng(10 + n_valid)
    T, t = _wheel_stream(rng)
    mask = np.arange(8) < n_valid
    t_end = int(t[-1]) + 10000
    sigma = np.asarray(tcfg.base().wheel_sigma, np.float32)
    # a carry that already holds a pose (the frame-to-frame case)
    jc = jpre.wheel_reset(0)._replace(last_pose=jnp.asarray(T[0]), has_sample=jnp.asarray(True))
    tc = tpre.wheel_reset(0)._replace(last_pose=torch.as_tensor(T[0]), has_sample=torch.ones((), dtype=torch.bool))
    jc = jpre.wheel_update_only_t(jpre.wheel_add_samples(jc, jnp.asarray(T), jnp.asarray(t), jnp.asarray(mask)), t_end)
    tc = tpre.wheel_update_only_t(
        tpre.wheel_add_samples(tc, torch.as_tensor(T), torch.as_tensor(t), torch.as_tensor(mask)),
        torch.tensor(t_end, dtype=torch.int32),
    )
    for f in ("delta_T", "v", "omega", "last_pose", "Dt"):
        _close(getattr(tc, f), getattr(jc, f), 1e-6)
    for f in ("last_pose_t_us", "last_update_t_us", "has_sample"):
        assert np.asarray(getattr(tc, f)) == np.asarray(getattr(jc, f)), f
    jr = jpre.wheel_result(jc, jcfg.base().wheel_sigma)
    tr = tpre.wheel_result(tc, torch.as_tensor(sigma))
    _close(tr.delta_T, jr.delta_T, 1e-6)
    _close(tr.sqrt_inverse_P, jr.sqrt_inverse_P, 1e-3)
    # frame-boundary reset keeps the pose track, zeroes the integral
    jn, tn = jpre.wheel_reset(jc), tpre.wheel_reset(tc)
    _close(tn.delta_T, jn.delta_T, 0.0)
    _close(tn.last_pose, jn.last_pose, 1e-6)


@pytest.mark.parametrize("n_valid,primed", [(32, True), (19, True), (8, False)])
def test_sequential_imu_matches_reference_and_the_parallel_form(n_valid, primed):
    """imu_add_samples + imu_update_only_t against the reference's
    sequential pair (to 1e-4 relative: the same Euler steps) and against
    the port's own imu_interval_parallel over the whole interval, with
    tests/test_preint_parallel.py's bounds; imu_result_update_bias against
    the reference's."""
    rng = np.random.default_rng(100 + n_valid)
    acc, gyro, t = _samples(rng, 32)
    mask = np.arange(32) < n_valid
    t_end = int(t[max(n_valid - 1, 0)]) + 4000
    ba = np.asarray([0.05, -0.02, 0.01], np.float32)
    bw = np.asarray([0.002, 0.0, -0.001], np.float32)
    jc = jpre.imu_reset(0, jnp.asarray(ba), jnp.asarray(bw))
    tc = tpre.imu_reset(0, torch.as_tensor(ba), torch.as_tensor(bw))
    if primed:
        held = (np.asarray([0.1, 0.2, 9.8], np.float32), np.asarray([0.0, 0.01, 0.1], np.float32))
        jc = jc._replace(last_acc=jnp.asarray(held[0]), last_gyro=jnp.asarray(held[1]), has_sample=jnp.asarray(True))
        tc = tc._replace(
            last_acc=torch.as_tensor(held[0]), last_gyro=torch.as_tensor(held[1]),
            has_sample=torch.ones((), dtype=torch.bool),
        )
    jQ, tQ = jpre.imu_noise_Q(jcfg.base()), tpre.imu_noise_Q(tcfg.base())
    jo = jpre.imu_update_only_t(jpre.imu_add_samples(jc, jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(t), jnp.asarray(mask), jQ), t_end, jQ)
    targs = (torch.as_tensor(acc), torch.as_tensor(gyro), torch.as_tensor(t), torch.as_tensor(mask))
    to = tpre.imu_update_only_t(tpre.imu_add_samples(tc, *targs, tQ), t_end, tQ)
    _close(to.X, jo.X, 1e-6)
    _close(to.J, jo.J, 1e-6)
    _close(to.P, jo.P, 1e-9)
    assert float(to.Dt) == pytest.approx(float(jo.Dt), rel=1e-6)
    assert int(to.last_t_us) == int(jo.last_t_us) and bool(to.has_sample) == bool(jo.has_sample)
    np.testing.assert_array_equal(to.last_acc.numpy(), np.asarray(jo.last_acc))

    par = tpre.imu_interval_parallel(tc, *targs, torch.tensor(t_end, dtype=torch.int32), tQ)
    np.testing.assert_allclose(par.X.numpy(), to.X.numpy(), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(par.J.numpy(), to.J.numpy(), atol=2e-4, rtol=1e-2)
    np.testing.assert_allclose(par.P.numpy(), to.P.numpy(), atol=1e-5, rtol=5e-2)
    assert float(par.Dt) == pytest.approx(float(to.Dt), abs=1e-6) and int(par.last_t_us) == int(to.last_t_us)
    np.testing.assert_array_equal(par.last_acc.numpy(), to.last_acc.numpy())

    dba = np.asarray([0.01, -0.02, 0.005], np.float32)
    dbw = np.asarray([-0.003, 0.001, 0.002], np.float32)
    jr = jpre.imu_result_update_bias(jpre.imu_result(jo), jnp.asarray(ba + dba), jnp.asarray(bw + dbw))
    tr = tpre.imu_result_update_bias(tpre.imu_result(to), torch.as_tensor(ba + dba), torch.as_tensor(bw + dbw))
    _close(tr.X, jr.X, 1e-6)
    np.testing.assert_array_equal(tr.linearized_ba.numpy(), np.asarray(jr.linearized_ba))
