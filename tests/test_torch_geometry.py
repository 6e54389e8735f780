"""The port's SO(3)/SE(3) primitives against liwslam.core.geometry.

Same numpy inputs (seeded) through both packages, float32 on the CPU;
agreement to 1e-5 (float32 round-off of the same closed forms), including
the zero-angle Taylor branch and angles near pi.  The port's primitives
must also give finite forward-mode Jacobians at exactly zero angle."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from liwslam.core import geometry as jgeo
from liwslam_torch.core import geometry as tgeo

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand_so3(rng, n, lo=0.0, hi=np.pi * 0.95):
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    return (axis * rng.uniform(lo, hi, size=(n, 1))).astype(np.float32)


def _cases(rng):
    w = _rand_so3(rng, 48)
    w[0] = 0.0  # exactly zero angle
    w[1] = [1e-6, -2e-6, 5e-7]  # Taylor branch
    w[2:10] = _rand_so3(rng, 8, np.pi - 1e-3, np.pi - 1e-4)  # near pi
    return w


def _both(fn_name, *args):
    j = np.asarray(getattr(jgeo, fn_name)(*[jnp.asarray(a) for a in args]))
    t = getattr(tgeo, fn_name)(*[torch.as_tensor(a) for a in args]).numpy()
    return j, t


@pytest.mark.parametrize("fn", ["exp_so3", "skew", "normalize_so3"])
def test_so3_vector_maps(fn):
    w = _cases(np.random.default_rng(0))
    if fn == "normalize_so3":
        w = w * 1.7  # some angles beyond pi get wrapped
    j, t = _both(fn, w)
    np.testing.assert_allclose(t, j, **TOL)


def test_log_so3_and_quaternion():
    R = np.asarray(jgeo.exp_so3(jnp.asarray(_cases(np.random.default_rng(1)))))
    for fn in ("quat_from_mat", "log_SO3"):
        j, t = _both(fn, R)
        np.testing.assert_allclose(t, j, **TOL)


def test_se3_make_log_inverse_compose_apply():
    rng = np.random.default_rng(2)
    w = _cases(rng)
    p = rng.normal(size=(len(w), 3)).astype(np.float32)
    jT, tT = _both("make_tf", p, w)
    np.testing.assert_allclose(tT, jT, **TOL)
    jp, jq = jgeo.log_SE3(jnp.asarray(jT))
    tp, tq = tgeo.log_SE3(torch.as_tensor(jT))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    j, t = _both("tf_inv", jT)
    np.testing.assert_allclose(t, j, **TOL)
    j, t = _both("tf_compose", jT, jT[::-1].copy())
    np.testing.assert_allclose(t, j, **TOL)
    pts = rng.normal(size=(len(w), 3)).astype(np.float32)
    j, t = _both("tf_apply", jT, pts)
    np.testing.assert_allclose(t, j, **TOL)
    a, b = rng.normal(size=(2, 16, 3)).astype(np.float32)
    j, t = _both("dis_from_line", pts[:16], a, b)
    np.testing.assert_allclose(t, j, **TOL)


def test_jacobians_finite_at_zero_and_match_reference():
    import jax

    for w in (np.zeros(3, np.float32), np.asarray([0.3, -0.2, 2.9], np.float32)):
        jJ = np.asarray(jax.jacfwd(lambda v: jgeo.log_SO3(jgeo.exp_so3(v) @ jgeo.exp_so3(v)))(jnp.asarray(w)))
        tJ = torch.func.jacfwd(
            lambda v: tgeo.log_SO3(tgeo.exp_so3(v[None]) @ tgeo.exp_so3(v[None]))[0]
        )(torch.as_tensor(w)).numpy()
        assert np.all(np.isfinite(tJ))
        np.testing.assert_allclose(tJ, jJ, rtol=1e-4, atol=1e-4)
    # safe_norm: value and tangent finite at exactly zero
    g = torch.func.jacfwd(lambda v: tgeo.safe_norm(v[None])[0])(torch.zeros(3))
    assert torch.all(torch.isfinite(g))


def test_quaternion_matrix_and_host_twins_match_reference():
    """mat_from_quat and normalize_tf (float32, 1e-5), and the back end's
    float64 numpy twins make_tf_np / log_SE3_np (to 1e-12: the same closed
    forms in float64), near pi and at zero angle too."""
    rng = np.random.default_rng(5)
    w = _cases(rng)
    q = np.asarray(jgeo.quat_from_mat(jgeo.exp_so3(jnp.asarray(w))))
    j, t = _both("mat_from_quat", q)
    np.testing.assert_allclose(t, j, **TOL)
    T = np.array(jgeo.make_tf(jnp.asarray(rng.normal(size=(len(w), 3)).astype(np.float32)), jnp.asarray(w)))
    T[:, :3, :3] += rng.normal(0, 1e-4, (len(w), 3, 3)).astype(np.float32)  # off the manifold
    j, t = _both("normalize_tf", T)
    np.testing.assert_allclose(t, j, **TOL)
    for p, v in zip(rng.normal(size=(len(w), 3)), w.astype(np.float64)):
        Tn = tgeo.make_tf_np(p, v)
        np.testing.assert_allclose(Tn, jgeo.make_tf_np(p, v), rtol=0, atol=1e-12)
        for a, b in zip(tgeo.log_SE3_np(Tn), jgeo.log_SE3_np(Tn)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def _helper_case(name, rng):
    """(reference value, port value) of one of the small helpers on seeded
    inputs: the factor scenarios of tests/test_solver.py:291-340 and the
    metric of tests/test_eval_utils.py:78."""
    from liwslam import config as jconfig
    from liwslam.eval import metrics as jmetrics
    from liwslam.solve import factors as jfac
    from liwslam_torch.eval import metrics as tmetrics
    from liwslam_torch.solve import factors as tfac

    j32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    both = lambda jf, tf, *a: (np.asarray(jf(*map(j32, a))), tf(*map(t32, a)).numpy())
    p, q = rng.normal(size=3), rng.normal(0, 0.3, 3)
    if name == "point_residual":
        return both(jfac.point_residual, tfac.point_residual, p, q, rng.normal(size=(5, 3)), rng.normal(size=(5, 3)))
    if name == "prior_factor_residual":
        A = rng.normal(size=(6, 6))
        d = rng.normal(0, 0.01, 6)
        return both(jfac.prior_factor_residual, tfac.prior_factor_residual, p + d[:3], q + d[3:], p, q, A @ A.T * 0.1 + np.eye(6))
    if name == "loop_edge_residual":
        Tiw = jconfig.office().mat_T_imu_to_wheel()
        info6 = [10.0, 10.0, 1.0, 1.0, 1.0, 25.0]
        pj, qj = rng.normal(size=3), rng.normal(0, 0.2, 3)
        tf_ij = np.linalg.inv(tgeo.make_tf_np(p, q)) @ tgeo.make_tf_np(pj, qj)
        w_tf12 = np.linalg.inv(Tiw) @ tf_ij @ Tiw @ tgeo.make_tf_np([0.05, -0.02, 0.0], [0.0, 0.0, 0.03])
        return both(jfac.loop_edge_residual, tfac.loop_edge_residual, p + 0.1, q, pj, qj, w_tf12, Tiw, info6)
    if name == "diag_sq":
        return both(jgeo.diag_sq, tgeo.diag_sq, rng.uniform(0.1, 2.0, (4, 3)))
    if name == "angle_wrap":
        a = np.concatenate([rng.uniform(-20, 20, 64), [-np.pi, np.pi, 0.0, 3 * np.pi]])
        return both(jgeo.angle_wrap, tgeo.angle_wrap, a)
    if name == "rpe":
        n = 30
        T = np.stack([tgeo.make_tf_np([0.1 * k, 0.02 * k * k, 0.0], [0.0, 0.0, 0.05 * k]) for k in range(n)])
        drift = T.copy()
        drift[:, 0, 3] += np.linspace(0, 0.5, n)
        drift[:, :3, :3] = drift[:, :3, :3] @ tgeo.make_tf_np(np.zeros(3), [0.0, 0.0, 0.01])[:3, :3]
        return np.asarray(jmetrics.rpe(drift, T, 2)), np.asarray(tmetrics.rpe(drift, T, 2))
    raise KeyError(name)


@pytest.mark.parametrize(
    "name", ["point_residual", "prior_factor_residual", "loop_edge_residual", "diag_sq", "angle_wrap", "rpe"]
)
def test_small_helpers_match_reference(name):
    """The factors, geometry helpers and RPE the reference's tests call,
    through both packages on the same inputs: within 1e-5 (float32
    round-off of the same closed forms; rpe is float64 numpy, equal)."""
    j, t = _helper_case(name, np.random.default_rng(7))
    assert j.shape == t.shape
    if name == "rpe":
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(j).max()))
    if name == "loop_edge_residual":
        assert np.all(t[3:] == 0.0) and np.abs(t[:3]).max() > 1e-3
