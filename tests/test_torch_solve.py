"""The port's factors, LM solver, marginalization and the plain version of
kernel B1 against the reference package.

Problems come from tests/test_solver.py and tests/test_track_solve.py
(simulator preintegration between two scans plus 64 synthetic line
matches) and are carried across as numpy.  Bounds follow
tests/test_track_solve.py: residuals atol 3e-4; tracking solve poses atol
5e-4, whole state atol 2e-3, cost <= 1.02x the reference's, Schur
quadratic forms within 10%.

At one line match (M = 1) the Schur reduction cancels frame 0's prior
against the IMU's information, and a float32 linearization loses part of
the reduced form in both packages: the M = 1 test holds the port's plain
version to the reference's kernel (interpret mode), each against a float64
reduction at its own solution."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from liwslam.solve import factors as jfac
from liwslam.solve import gn as jgn
from liwslam_torch.core import geometry as tgeo
from liwslam_torch.ops import track_solve as tts
from liwslam_torch.solve import factors as tfac
from liwslam_torch.solve import gn as tgn
from tests.test_solver import CONSTS
from tests.test_track_solve import reference_solution, tracking_problem


@functools.lru_cache(maxsize=None)
def _problem(with_prior):
    """tests/test_track_solve.py's tracking problem and its reference
    solution (jitted LM, method "chol"), built once per module."""
    if with_prior:
        st, d, x0, free = tracking_problem(with_prior=True)
    else:
        # tracking_problem(with_prior=False) is the same problem with the
        # empty prior of empty_factor_data; skip rebuilding the simulator
        d, x0, free, _ = _problem(True)
        d = d._replace(prior_J=jnp.eye(15), prior_X=jnp.zeros(15), prior_valid=jnp.asarray(False))
    return d, x0, free, reference_solution(d, x0, free)


def _t(tree):
    return type(tree)(*[torch.as_tensor(np.array(v)) for v in tree])


def _port(d, x0, free):
    consts = tfac.SolveConsts(*[torch.as_tensor(np.array(v)) for v in CONSTS])
    return _t(d), torch.as_tensor(np.array(x0)), torch.as_tensor(np.array(free)), consts


def _res_fns(d, W=2):
    td, _, _, tconsts = _port(d, jnp.zeros(1), jnp.zeros(1))
    jres = lambda x: jfac.stack_residuals(jfac.WindowState.from_flat(x, W), d, CONSTS)
    tres = lambda x: tfac.stack_residuals(tfac.WindowState.from_flat(x, W), td, tconsts)
    return jres, tres


@jax.jit
def _linearize(x, d):
    """The reference residual (window of 2) and its Jacobian at x, the
    factor data an argument: every problem of the module shares one
    compile, where op-by-op dispatch would compile each operation."""
    f = lambda y: jfac.stack_residuals(jfac.WindowState.from_flat(y, 2), d, CONSTS)
    return f(x), jax.jacfwd(f)(x)


@pytest.mark.parametrize("with_prior", [True, False])
def test_stack_residuals_and_jacobian(with_prior):
    d, x0, free, _ = _problem(with_prior)
    _, tres = _res_fns(d)
    xt = torch.as_tensor(np.array(x0))
    r_ref, Jj = (np.asarray(a) for a in _linearize(x0, d))
    np.testing.assert_allclose(tres(xt).numpy(), r_ref, rtol=2e-4, atol=3e-4)
    r, J = tgn.linearize(tres, xt)
    assert J.dtype == torch.float32 and J.shape == (r.shape[0], 30)
    # a ground tilt row at a tilt below 1e-4 rad sits at the kink of
    # |z_axis x e_z|: its direction, and so its Jacobian, is float32 noise in
    # both packages (frame 0 of this problem is level to 2e-7 rad)
    M = d.laser_l1p1.shape[0]
    tilt_rows = [36 + 2 * M + 1, 36 + 2 * M + 3]
    tilt = np.abs(r_ref[tilt_rows]) / float(CONSTS.ground_q_info * d.ground_weight)
    rows = [i for i in range(len(r_ref)) if i not in [t for t, a in zip(tilt_rows, tilt) if a < 1e-4]]
    scale = np.abs(Jj[rows]).max(axis=1, keepdims=True) + 1.0
    np.testing.assert_allclose(J.numpy()[rows] / scale, Jj[rows] / scale, atol=3e-4)


@pytest.mark.parametrize("method", ["qr", "chol"])
def test_lm_solve_matches_reference(method):
    """gn.lm_solve on the tracking problem against the reference package's
    LM (method "chol"; its QR and Cholesky paths agree to 2e-4,
    tests/test_solver.py)."""
    d, x0, free, (x_ref, c_ref, _, _) = _problem(True)
    _, tres = _res_fns(d)
    wrap = lambda x: tfac.WindowState.from_flat(x, 2)._replace(q=tgeo.normalize_so3(tfac.WindowState.from_flat(x, 2).q)).flat()
    xt, ct, _ = tgn.lm_solve(
        tres, torch.as_tensor(np.array(x0)), torch.as_tensor(np.array(free)),
        tgn.LMConfig(max_iters=8, method=method), wrap_fn=wrap,
    )
    xt = xt.numpy()
    np.testing.assert_allclose(xt[15:21], x_ref[15:21], atol=5e-4)
    np.testing.assert_allclose(xt, x_ref, atol=2e-3)
    assert float(ct) <= c_ref * 1.02
    np.testing.assert_array_equal(xt[:6], np.asarray(x0)[:6])  # frozen pose


def test_marginalize_and_sqrt_prior():
    d, _, _, (x_ref, _, _, _) = _problem(True)
    jres, tres = _res_fns(d)
    x = jnp.asarray(x_ref)
    jJ, jr, jX = jax.jit(lambda y: jgn.marginalize(jres, y, keep=15))(x)
    tJ, tr, tX = tgn.marginalize(tres, torch.as_tensor(np.array(x)), keep=15)
    np.testing.assert_array_equal(tX.numpy(), np.asarray(jX))
    # eigenvectors are defined up to sign and order: compare J'J and J'r as
    # quadratic forms (dH spans ~1e9 with f32 cancellation in both paths)
    Hj = np.asarray(jJ, np.float64).T @ np.asarray(jJ, np.float64)
    Ht = (tJ.double().T @ tJ.double()).numpy()
    rng = np.random.default_rng(5)
    scale = np.abs(Hj).max()
    for _ in range(16):
        v = rng.normal(size=15)
        v /= np.linalg.norm(v)
        assert abs(v @ Ht @ v - v @ Hj @ v) < 0.10 * max(abs(v @ Hj @ v), 1e-4 * scale)
    gj = np.asarray(jJ, np.float64).T @ np.asarray(jr, np.float64)
    gt = (tJ.double().T @ tr.double()).numpy()
    assert np.abs(gt - gj).max() < 1e-4 * scale
    # sqrt_prior alone on a known SPD pair: J'J = dH, J'r = -dg
    A = rng.normal(size=(15, 15))
    dH = (A @ A.T + np.eye(15)).astype(np.float32)
    dg = rng.normal(size=15).astype(np.float32)
    J, r = tgn.sqrt_prior(torch.as_tensor(dH), torch.as_tensor(dg))
    np.testing.assert_allclose((J.T @ J).numpy(), dH, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose((J.T @ r).numpy(), -dg, rtol=1e-3, atol=1e-3)


def _schur_at(d, x):
    """(dH, dg) of the reference residual linearized at x, in float64."""
    r, J = (np.asarray(a, np.float64) for a in _linearize(jnp.asarray(x, jnp.float32), d))
    H, g = J.T @ J, -(J.T @ r)
    sol = np.linalg.solve(H[:15, :15] + 1e-8 * np.eye(15), np.concatenate([H[:15, 15:], g[:15, None]], 1))
    dH = H[15:, 15:] - H[15:, :15] @ sol[:, :15]
    return 0.5 * (dH + dH.T), g[15:] - H[15:, :15] @ sol[:, 15]


@pytest.mark.parametrize("with_prior", [True, False])
def test_track_solve_plain_matches_reference(with_prior):
    d, x0, free, (x_ref, c_ref, _, _) = _problem(with_prior)
    td, tx0, tfree, tconsts = _port(d, x0, free)
    _, frozen = tts.tracking_free_mask(fast_mode=False)
    tts.check_frozen(tfree.tolist(), frozen)
    inp = tts.pack_inputs(tx0, tfree, td, tconsts)
    # the kernel's flat residual equals the factor stack minus the
    # always-zero frame-0 IMU / wheel rows, laser rows blocked by endpoint
    r_ref = np.asarray(_linearize(x0, d)[0])
    M = d.laser_l1p1.shape[0]
    o = 36 + 2 * M
    want = np.concatenate([r_ref[15:30], r_ref[33:36], r_ref[36:o].reshape(M, 2).T.reshape(-1), r_ref[o:]])
    np.testing.assert_allclose(tts.residual(tx0, inp).numpy(), want, rtol=2e-4, atol=3e-4)

    x, c, dH, dg, iters = (a[0] for a in tts.lm_solve_track_plain(inp, max_iters=8))
    x = x.numpy()
    np.testing.assert_allclose(x[15:21], x_ref[15:21], atol=5e-4)
    np.testing.assert_allclose(x, x_ref, atol=2e-3)
    assert float(c) <= c_ref * 1.02, (float(c), c_ref)
    assert 1 <= int(iters) <= 8
    if with_prior:
        dH_at, dg_at = _schur_at(d, x)
        rng = np.random.default_rng(5)
        dH = dH.double().numpy()
        scale = np.abs(dH_at).max()
        for _ in range(16):
            v = rng.normal(size=15)
            v /= np.linalg.norm(v)
            assert abs(v @ dH @ v - v @ dH_at @ v) < 0.10 * max(abs(v @ dH_at @ v), 1e-4 * scale)
        assert np.abs(dg.double().numpy() - dg_at).max() < 1e-4 * scale
    # the one-system wrapper takes the same path on CPU tensors
    x1, c1, _, _ = tts.lm_solve_track(tx0, tfree, td, tconsts, max_iters=8)
    np.testing.assert_array_equal(x1.numpy(), x)


def test_frozen_dims_checked_on_host():
    free, frozen = tts.tracking_free_mask(fast_mode=True)
    assert frozen == tts.FROZEN_FAST and all(free[k] == 0.0 for k in frozen)
    with pytest.raises(ValueError):
        tts.check_frozen([1.0] * 30, tts.FROZEN_POSE)


def test_edge_residual_and_info_match_reference():
    """The pose graph's edge residual, batched over edges in the port and
    vmapped in the reference: float32, within 1e-4 of the residual scale
    (info6 weighs rotation rows by 1e3)."""
    from liwslam import config as jconfig
    from liwslam_torch import config as tconfig

    prm = jconfig.office()
    info_j = np.asarray(jfac.edge_info6(prm))
    info_t = tfac.edge_info6(tconfig.office())
    np.testing.assert_array_equal(info_t.numpy(), info_j)
    rng = np.random.default_rng(2)
    E = 64
    p_i, p_j = rng.normal(size=(2, E, 3)).astype(np.float32)
    q_i, q_j = (rng.normal(size=(2, E, 3)) * 0.5).astype(np.float32)
    Ti = tgeo.make_tf(torch.as_tensor(p_i), torch.as_tensor(q_i)).double().numpy()
    Tj = tgeo.make_tf(torch.as_tensor(p_j + 0.01), torch.as_tensor(q_j + 0.001)).double().numpy()
    tf12 = (np.linalg.inv(Ti) @ Tj).astype(np.float32)
    w = rng.uniform(1, 10, E).astype(np.float32)
    rj = np.asarray(
        jax.vmap(lambda a, b, c, d, t, ww: jfac.edge_residual(a, b, c, d, t, jnp.asarray(info_j), ww))(
            p_i, q_i, p_j, q_j, tf12, w
        )
    )
    T = lambda a: torch.as_tensor(a)
    rt = tfac.edge_residual(T(p_i), T(q_i), T(p_j), T(q_j), T(tf12), info_t, T(w)).numpy()
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-4 * np.abs(rj).max())
    assert np.abs(rj).max() > 1.0



M1_SEEDS = range(3, 11)


@functools.lru_cache(maxsize=None)
def _m1_case(seed):
    """chip_smoke's two-frame problem at one line match (bench.py's
    parameters, the tracking mode they choose) on the CPU: the port's
    packed inputs, and the same system for the reference as numpy."""
    import chip_smoke

    prm = chip_smoke.bench_params()
    x0, data, consts, _ = chip_smoke.two_frame_problem(prm, "cpu", M=1, seed=seed)
    free, frozen = tts.tracking_free_mask(prm.fast_mode)
    inp = tts.pack_inputs(x0, torch.as_tensor(free), data, consts)
    return prm, inp, x0.numpy(), [np.array(v) for v in data], np.asarray(free, np.float32), frozen


@jax.jit
def _lin64(y, d, c):
    f = lambda y: jfac.stack_residuals(jfac.WindowState.from_flat(y, 2), d, c)
    return f(y), jax.jacfwd(f)(y)


def _schur64_reference(data, x, jc):
    """(dH, dg) of the reference's residual linearized at x in float64
    (JAX with 64-bit types), reduced in float64."""
    with jax.enable_x64(True):
        d64 = jfac.FactorData(*[jnp.asarray(v, jnp.float64 if v.dtype == np.float32 else v.dtype) for v in data])
        c64 = jfac.SolveConsts(*[jnp.asarray(np.asarray(v), jnp.float64) for v in jc])
        r, J = (np.asarray(a) for a in _lin64(jnp.asarray(np.asarray(x, np.float64)), d64, c64))
    H, g = J.T @ J, -(J.T @ r)
    sol = np.linalg.solve(H[:15, :15] + 1e-8 * np.eye(15), np.concatenate([H[:15, 15:], g[:15, None]], 1))
    dH = H[15:, 15:] - H[15:, :15] @ sol[:, :15]
    return 0.5 * (dH + dH.T), g[15:] - H[15:, :15] @ sol[:, 15]


@pytest.mark.parametrize("seed", M1_SEEDS)
def test_m1_schur_loss_is_shared_with_the_reference(seed):
    """B1's Schur reduction at M = 1 over chip_smoke's eight seeds: the
    port's plain version (``lm_solve_track_plain``) lies from a float64
    reduction at its own solution (``chip_smoke.schur_float64``) at most
    max(2x the reference kernel's gap from its own float64 reduction, 10%)
    (``chip_smoke.schur_gap``; ``pytest -s`` prints both).  Measured on
    an x86 CPU: the port 0.8-50.1%, the reference 1.5-144.9% (seeds 6 and
    9 the worst in both), so the loss is float32's, shared by both
    packages, and not a fault of the port."""
    import chip_smoke
    from liwslam import config as jconfig
    from liwslam.ops import track_solve as jts
    from liwslam_torch import config as tconfig

    prm, inp, x0, data, free, frozen = _m1_case(seed)
    mi = prm.solver_max_iterations
    x, _, dH, _, _ = tts.lm_solve_track_plain(inp, max_iters=mi)
    dH64 = chip_smoke.schur_float64(inp, x)[0][0].numpy()
    port_gap = chip_smoke.schur_gap(dH[0].double().numpy(), dH64)

    jc = jfac.make_consts(jconfig.office().replace(**tconfig.BENCH_WIDTHS))
    jd = jfac.FactorData(*[jnp.asarray(v) for v in data])
    xr, _, dHr, _ = jts.lm_solve_track(
        jnp.asarray(x0), jnp.asarray(free), jd, jc, max_iters=mi, interpret=True, frozen_dims=frozen
    )
    ref_gap = chip_smoke.schur_gap(np.asarray(dHr, np.float64), _schur64_reference(data, np.asarray(xr), jc)[0])
    print(f"M=1 seed {seed}: Schur form from the float64 reduction, port {100 * port_gap:.1f}%, reference {100 * ref_gap:.1f}%")
    assert np.all(np.isfinite(np.asarray(xr))) and np.all(np.isfinite(x.numpy()))
    assert port_gap <= max(2 * ref_gap, 0.10), (seed, port_gap, ref_gap)
