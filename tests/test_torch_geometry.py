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
