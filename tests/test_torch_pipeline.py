"""The port's front end against the reference package's, step by step and
as a whole slice.

(a) The reference ``Frontend`` (XLA path on the CPU) runs its init window
on the noisy L track, then 8 frames of the reference's
``pipeline.tracking_step``.  Before each frame the reference's
``TrackState`` and the packed ``FrameInput`` are carried across with
``liwslam_torch.convert`` and one step of the port's ``tracking_step``
runs on them: position within 5e-3 m, line and match counts equal or off
by one on a knife-edge frame.  The state is carried across every frame
because the submaps would otherwise drift apart: the reference extracts
endpoints from float32 prefix moments, the port from float64 ones, the
~1e-4 m difference accumulates in the submap, and after a few frames the
1.2x-mean distance filter of ``match_lines`` flips two matches at once.

(b) Both packages' ``Frontend.run`` on the noise-free L track of
tests/test_frontend_e2e.py: the port reaches ATE < 0.1 m and its median
drift from the reference trajectory stays < 0.05 m, as the reference's
own solver paths are held to each other there."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from liwslam.frontend import pipeline as jpl
from liwslam.frontend.driver import Frontend as JFrontend
from liwslam.sim import world as jsim
from liwslam_torch import convert
from liwslam_torch.eval import metrics
from liwslam_torch.frontend import pipeline as tpl
from liwslam_torch.frontend.driver import Frontend as TFrontend
from liwslam_torch.sim import world as tsim
from tests.test_frontend_e2e import small_params

SIM = dict(imu_hz=100, wheel_hz=20, laser_hz=5, n_beams=360, seed=0)
N_STEPS = 8


def _reference(noise, fast_mode=False, seconds=None):
    """The reference front end on the L track (its first ``seconds`` when
    given): the packed frames, the index of the first tracked frame and
    the state after the init window."""
    prm = small_params().replace(fast_mode=fast_mode)
    streams = jsim.simulate(jsim.default_track("L"), jsim.square_room(obstacles=True), prm, noise=noise, **SIM)
    if seconds is not None:
        streams = _first_seconds(streams, seconds)
    fe = JFrontend(prm)
    frames, lt = fe.pack_frames(streams)
    track, k0, st_init, _, _ = fe.initialize(frames, lt)
    return prm, fe, frames, k0, track, st_init


def test_tracking_steps_match_reference():
    prm, jfe, frames, k0, jstate, _ = _reference(noise=True)
    jstep = jax.jit(lambda s, i: jpl.tracking_step(s, i, jfe.consts, jfe.dcfg, jfe.scfg))
    jstate = jax.tree_util.tree_map(jnp.asarray, jstate)
    fe = TFrontend(convert.params_from_reference(dataclasses.asdict(prm)), device="cpu")
    n_match = 0
    for i in range(N_STEPS):
        state = convert.track_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
        assert state.imu.last_t_us.dtype == torch.int32 and state.pair.ref.valid.dtype == torch.bool
        inp = convert.frame_input_from_numpy(frames[k0 + i], "cpu")
        _, out = tpl.tracking_step(state, inp, fe.consts, fe.dcfg, fe.scfg)
        jstate, ref = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, frames[k0 + i]))
        np.testing.assert_allclose(out.p.numpy(), np.asarray(ref.p), atol=5e-3, err_msg=f"frame {i}")
        assert abs(int(out.n_lines) - int(ref.n_lines)) <= 1, i
        assert abs(int(out.n_match) - int(ref.n_match)) <= 1, i
        n_match += int(ref.n_match)
    assert n_match > 0


@functools.lru_cache(maxsize=None)
def _port_run(fast_mode):
    """The port's ``Frontend.run`` on the noise-free L track at
    small_params (the given ``fast_mode``): params, streams, result and
    the chunk callbacks' payloads."""
    tprm = convert.params_from_reference(dataclasses.asdict(small_params())).replace(fast_mode=fast_mode)
    streams = tsim.simulate(tsim.default_track("L"), tsim.square_room(obstacles=True), tprm, noise=False, **SIM)
    chunks = []
    res = TFrontend(tprm, device="cpu").run(streams, chunk_size=16, chunk_callback=chunks.append)
    return tprm, streams, res, chunks


def test_frontend_run_shadows_reference():
    prm, jfe, frames, k0, track, st_init = _reference(noise=False)
    batch = jax.tree_util.tree_map(lambda *xs: jnp.asarray(np.stack(xs)), *frames[k0:])
    _, outs = jfe._chunk_fn()(track, batch)  # all tracked frames, one compile
    p_ref = np.concatenate([np.asarray(st_init.p), np.asarray(outs.p)])
    assert not prm.fast_mode
    tprm, streams, res, chunks = _port_run(False)
    F = len(res.t_us)
    assert F >= 40 and res.p.shape == (F, 3) and res.bs.shape == (F, 6)
    assert sum(c["n"] for c in chunks) == F - 10  # all but the init window
    pairs = metrics.associate_by_time(res.t_us, streams.gt_t_us)
    assert len(pairs) == F
    ate = metrics.ate_rmse(res.T_w_imu(), streams.gt_T_w_imu[pairs[:, 1]], align=False)
    assert ate < 0.1, ate
    n = min(F, len(p_ref))
    drift = np.linalg.norm(res.p[:n] - p_ref[:n], axis=1)
    assert np.median(drift) < 0.05, drift.max()
    assert res.is_keyframe.sum() >= 3 and len(res.kf_corners) == int(res.is_keyframe.sum())


def _first_seconds(streams, sec):
    """The streams' first ``sec`` seconds (the front end is causal: its
    poses there are those of the whole run's first frames)."""
    cut = int(sec * 1e6)
    kw = {}
    for prefix, fields in (("imu", ("imu_acc", "imu_gyro")), ("wheel", ("wheel_pose",)),
                           ("laser", ("laser_points", "laser_times_rel", "laser_valid")), ("gt", ("gt_T_w_imu", "gt_T_w_wheel"))):
        keep = getattr(streams, f"{prefix}_t_us") < cut
        kw[f"{prefix}_t_us"] = getattr(streams, f"{prefix}_t_us")[keep]
        kw.update({f: getattr(streams, f)[keep] for f in fields})
    return dataclasses.replace(streams, **kw)


def test_fast_mode_matches_full_mode_and_skips_the_prior():
    """tests/test_fast_mode.py's holds on the port, on the first 8 s of the
    noise-free L track at 360 beams (smaller than the reference test's
    whole track at 540): ``fast_mode`` (biases frozen in the tracking
    solve, the marginalization prior skipped) through the init window and
    ``tracking_step`` in chunks shadows the reference front end's
    ``fast_mode`` on the same streams (median drift < 0.05 m, as
    test_frontend_run_shadows_reference holds the full mode) and gives
    ATE < 0.1 m like the full mode, the two trajectories within 0.1 m of
    each other; the prior is invalid after the init window and after each
    chunk in ``fast_mode`` in both packages, valid in the full mode."""
    from liwslam_torch.core import geometry as tgeo

    tprm, streams, full, _ = _port_run(False)
    streams = _first_seconds(streams, 8.0)
    fe = TFrontend(tprm.replace(fast_mode=True), device="cpu")
    frames, lt = fe.pack_frames(streams)
    track, k0, st_init, init_times, _ = fe.initialize(frames, lt)
    assert not bool(track.prior_valid)
    p, q = [st_init.p], [st_init.q]
    t_us = np.concatenate([np.asarray(init_times, np.int64), np.asarray(lt[k0:], np.int64)])
    for k in range(k0, len(frames), 16):
        track, outs = fe.run_chunk(track, fe.stack_frames(frames[k : k + 16]))
        assert not bool(track.prior_valid)
        p.append(outs.p)
        q.append(outs.q)
    T_fast = tgeo.make_tf(torch.cat(p), torch.cat(q)).double().numpy()
    n = len(T_fast)
    assert n == len(t_us) >= 25 and np.array_equal(full.t_us[:n], t_us)
    jprm, jfe, jframes, jk0, jtrack, jst = _reference(noise=False, fast_mode=True, seconds=8.0)
    assert jprm.fast_mode and not bool(jtrack.prior_valid)
    jtrack, jouts = jfe._chunk_fn()(jtrack, jax.tree_util.tree_map(lambda *xs: jnp.asarray(np.stack(xs)), *jframes[jk0:]))
    assert not bool(jtrack.prior_valid)
    p_ref = np.concatenate([np.asarray(jst.p), np.asarray(jouts.p)])
    assert jk0 == k0 and len(p_ref) == n
    drift = np.linalg.norm(T_fast[:, :3, 3] - p_ref, axis=1)
    assert np.median(drift) < 0.05, drift.max()
    assert np.linalg.norm(full.p[:n, :2] - T_fast[:, :2, 3], axis=1).max() < 0.1
    pairs = metrics.associate_by_time(t_us, streams.gt_t_us)
    assert len(pairs) == n
    gt = streams.gt_T_w_imu[pairs[:, 1]]
    for T in (full.T_w_imu()[:n], T_fast):
        assert metrics.ate_rmse(T[pairs[:, 0]], gt, align=True) < 0.1
    full_fe = TFrontend(tprm, device="cpu")
    track, k0, *_ = full_fe.initialize(frames, lt)
    assert bool(track.prior_valid)
    track, _ = full_fe.run_chunk(track, full_fe.stack_frames(frames[k0 : k0 + 2]))
    assert bool(track.prior_valid)
