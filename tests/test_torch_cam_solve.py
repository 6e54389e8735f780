"""The plain version of kernel B4 (the camera sub-step's joint solve)
against the reference package's landmark-Schur LM.

Problems are tests/test_cam_solve.py's (IMU, wheel, ground and prior rows
between two simulator frames, no laser rows, synthetic reprojection rows
over 12 landmarks and 4 window slots), carried across as numpy.  The
reference is ``solve/cam_schur.lm_solve_cam_schur`` (XLA, not the Pallas
kernel) and, for the prior, the Schur reduction of the reference residual
at the port's solution.  Bounds are tests/test_cam_solve.py's: poses atol
1e-3, whole state atol 5e-3, free landmarks atol 5e-3, frozen landmarks
unchanged, cost within 2%, Schur quadratic forms within 10%, dg within
1e-4 of the dH scale.  Both window frames are rolled by 0.02 rad: the
problem's frames are level, and at a level solution the ground-tilt rows
sit at their kink, where the direction of their Jacobian is float32 noise
(the Schur forms of two correct implementations then differ by up to 30%;
at 0.02 rad by < 0.1%)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from liwslam.frontend import pipeline as jpl
from liwslam.solve import cam_schur as jcam_schur
from liwslam.solve import factors as jfac
from liwslam.solve import gn as jgn
from liwslam_torch.ops import cam_solve
from liwslam_torch.ops import track_solve as ts
from liwslam_torch.solve import factors as tfac
from tests.test_cam_solve import _camera_problem
from tests.test_solver import CONSTS

MAX_ITERS = 12
_t = lambda a: torch.as_tensor(np.array(a))
_res30 = lambda d: lambda x: jfac.stack_residuals(jfac.WindowState.from_flat(x, 2), d, CONSTS)
_wrap30 = lambda x: jpl._wrap_q(x, 2, jnp.float32)


@jax.jit
def _reference_solve(pr):
    """tests/test_cam_solve.py's reference (``cam_schur`` LM, method
    "chol"), traced once for every problem of this module's shapes."""
    return jcam_schur.lm_solve_cam_schur(
        _res30(pr["data"]), pr["x0"], pr["free30"], pr["world0"], pr["lm_free"], pr["obs"], pr["use"],
        pr["ring_p"], pr["ring_q"], pr["Tic"], pr["sqrt_info"],
        jgn.LMConfig(max_iters=MAX_ITERS, method="chol"), wrap30=_wrap30,
    )


@jax.jit
def _linearize_ref(d, x):
    return _res30(d)(x), jax.jacfwd(_res30(d))(x)


def _port_inputs(pr, use=None, lm_free=None):
    d = pr["data"]
    td = tfac.FactorData(*[_t(v) for v in d])
    tconsts = tfac.SolveConsts(*[_t(v) for v in CONSTS])
    free = _t(pr["free30"])
    ts.check_frozen(free.tolist(), ts.FROZEN_POSE)
    f32 = lambda a: _t(a).to(torch.float32)
    return cam_solve.pack_inputs(
        _t(pr["x0"]), free, _t(pr["world0"]),
        f32(pr["lm_free"] if lm_free is None else lm_free),
        _t(pr["obs"]), f32(pr["use"] if use is None else use), _t(pr["ring_p"]), _t(pr["ring_q"]),
        td, tconsts, _t(pr["Tic"]), _t(pr["sqrt_info"]),
    )


def _schur_at(pr, x):
    r, J = (np.asarray(a, np.float64) for a in _linearize_ref(pr["data"], jnp.asarray(x, jnp.float32)))
    H, g = J.T @ J, -(J.T @ r)
    sol = np.linalg.solve(H[:15, :15] + 1e-8 * np.eye(15), np.concatenate([H[:15, 15:], g[:15, None]], 1))
    dH = H[15:, 15:] - H[15:, :15] @ sol[:, :15]
    return 0.5 * (dH + dH.T), g[15:] - H[15:, :15] @ sol[:, 15]


def _tilted_problem(seed=0, rad=0.02):
    pr = _camera_problem(seed=seed)
    pr["x0"] = pr["x0"].at[3].add(rad).at[18].add(rad)
    return pr


@pytest.mark.parametrize("seed", [0, 1])
def test_cam_solve_plain_matches_reference(seed):
    pr = _tilted_problem(seed)
    x_ref, w_ref, c_ref = (np.asarray(a) for a in _reference_solve(pr))
    # the one-system entry point: packing, the wrapper, the plain version
    td = tfac.FactorData(*[_t(v) for v in pr["data"]])
    tconsts = tfac.SolveConsts(*[_t(v) for v in CONSTS])
    x, w, c, dH, dg = cam_solve.lm_solve_cam(
        _t(pr["x0"]), _t(pr["free30"]), _t(pr["world0"]), _t(pr["lm_free"]), _t(pr["obs"]), _t(pr["use"]),
        _t(pr["ring_p"]), _t(pr["ring_q"]), td, tconsts, _t(pr["Tic"]), _t(pr["sqrt_info"]), max_iters=MAX_ITERS,
    )
    x, w, c = x.numpy(), w.numpy(), float(c)
    np.testing.assert_allclose(x[15:21], x_ref[15:21], atol=1e-3)
    np.testing.assert_allclose(x, x_ref, atol=5e-3)
    lmf = np.asarray(pr["lm_free"])
    np.testing.assert_allclose(w[lmf], w_ref[lmf], atol=5e-3)
    np.testing.assert_array_equal(w[~lmf], np.asarray(pr["world0"])[~lmf])
    assert abs(c - float(c_ref)) < 0.02 * max(float(c_ref), 1e-3), (c, float(c_ref))

    dH_ref, dg_ref = _schur_at(pr, x)
    scale = np.abs(dH_ref).max()
    rng = np.random.default_rng(5)
    dH = dH.double().numpy()
    for _ in range(16):
        v = rng.normal(size=15)
        v /= np.linalg.norm(v)
        assert abs(v @ dH @ v - v @ dH_ref @ v) < 0.10 * max(abs(v @ dH_ref @ v), 1e-4 * scale)
    assert np.abs(dg.double().numpy() - dg_ref).max() < 1e-4 * scale


def test_cam_solve_plain_without_camera_rows():
    """Every reprojection row masked: the base-only problem of
    ``gn.lm_solve`` (the tracking solve without laser rows)."""
    pr = _tilted_problem()
    x_ref, c_ref, _ = jax.jit(
        lambda: jgn.lm_solve(
            _res30(pr["data"]), pr["x0"], pr["free30"], jgn.LMConfig(max_iters=MAX_ITERS, method="chol"),
            wrap_fn=_wrap30,
        )
    )()
    F, WC = np.asarray(pr["use"]).shape
    inp = _port_inputs(pr, use=np.zeros((F, WC), bool), lm_free=np.zeros(F, bool))
    x, w, c, _, _, iters = (a[0] for a in cam_solve.lm_solve_cam_plain(inp, max_iters=MAX_ITERS))
    assert 1 <= int(iters) <= MAX_ITERS
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=5e-3)
    np.testing.assert_array_equal(w.numpy(), np.asarray(pr["world0"]))
    assert abs(float(c) - float(c_ref)) < 0.02 * max(float(c_ref), 1e-3)
