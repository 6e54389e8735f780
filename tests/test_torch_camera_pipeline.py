"""The port's camera-enabled front end against the reference package's.

Streams: tests/test_camera_e2e.py's (L track, 360 beams at 5 Hz, camera
160x120 at 10 Hz, no noise), cut after ``T_END_US``: an init window that
interleaves camera frames, then 13 tracked laser frames, each with one
accepted camera frame and one LK-only message.

(a) Before each of the first 6 tracked frames that carry a camera frame,
the reference's (TrackState, CamTrackState) and its packed FrameInputCam
are carried across with ``liwslam_torch.convert`` and one port
``tracking_step_cam`` runs on them: camera-frame and laser-frame positions
within 5e-3 m, tracked and ready landmark counts within 1.

At each of these steps the laser match has float32 ties: ``match_lines``
picks a scan line's reference line by arccos |cos|, and on this noise-free
track one wall is in the submap several times (seen from several
keyframes), its copies within 1e-8 in |cos| of each other, which float32
cannot resolve (~3e-4 rad near 0).  Which copy wins then follows rounding
(XLA's CPU code for the reference, whose vectorization follows the host's
ISA), and the chosen copy moves the step by up to ~1 cm.  So before each
step the submap lines that tie with a scan line's best candidate (angles
within ``TIE_RAD`` of it, in float64) are left out of the state, both
packages step from that state, and the step no longer depends on rounding.

(b) Both packages' ``Frontend.run`` on the cut streams: the port reaches
ATE < 0.1 m and stays within 0.05 m median drift of the reference's
trajectory (the bounds tests/test_torch_pipeline.py holds the laser path
to), and meets tests/test_camera_e2e.py's camera gates."""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from liwslam.frontend import camera_pipeline as jcpl
from liwslam.frontend.driver import Frontend as JFrontend
from liwslam.sim import world as jsim
from liwslam_torch import convert
from liwslam_torch.core import geometry as geo
from liwslam_torch.eval import metrics
from liwslam_torch.frontend import camera_pipeline as tcpl
from liwslam_torch.frontend import matching as tmm
from liwslam_torch.frontend.driver import Frontend as TFrontend
from liwslam_torch.sim import world as tsim
from tests.test_camera_e2e import H_PX, W_PX, cam_params

SIM = dict(imu_hz=100, wheel_hz=20, laser_hz=5, n_beams=360, camera_hz=10.0, camera_wh=(W_PX, H_PX), noise=False, seed=0)
T_END_US = 6_100_000
N_STEPS = 6
TIE_RAD = 1e-3


def _cut(streams, t_end_us):
    """The streams up to ``t_end_us`` (every sensor cut by its own stamps)."""
    groups = {
        "imu_t_us": ("imu_acc", "imu_gyro"),
        "wheel_t_us": ("wheel_pose",),
        "laser_t_us": ("laser_points", "laser_times_rel", "laser_valid"),
        "gt_t_us": ("gt_T_w_imu", "gt_T_w_wheel"),
        "cam_t_us": ("cam_images",),
    }
    kw = {}
    for t, fields in groups.items():
        keep = np.asarray(getattr(streams, t)) <= t_end_us
        kw[t] = getattr(streams, t)[keep]
        kw.update({f: getattr(streams, f)[keep] for f in fields})
    return dataclasses.replace(streams, **kw)


@pytest.fixture(scope="module")
def reference():
    """The reference front end on the cut streams: its packed frames, the
    index of the first tracked frame, the (state, cam state) before each
    tracked frame, its outputs, its whole trajectory, and its jitted step."""
    prm = cam_params()
    streams = _cut(jsim.simulate(jsim.default_track("L"), jsim.square_room(obstacles=True), prm, **SIM), T_END_US)
    fe = JFrontend(prm)
    frames, lt = fe.pack_frames(streams)
    track, k0, st_init, _, cam = fe.initialize(frames, lt)
    step = jax.jit(lambda s, c, i: jcpl.tracking_step_cam(s, c, i, fe.consts, fe.dcfg, fe.scfg, fe.ccfg, fe.cdyn))
    carry = jax.tree_util.tree_map(jnp.asarray, (track, cam))
    before, outs = [], []
    for k in range(k0, len(frames)):
        before.append(jax.tree_util.tree_map(np.asarray, carry))
        carry, out = step(*carry, jax.tree_util.tree_map(jnp.asarray, frames[k]))
        outs.append(jax.tree_util.tree_map(np.asarray, out))
    p_ref = np.concatenate([np.asarray(st_init.p), np.stack([o[0].p for o in outs])])
    return prm, frames, k0, before, outs, p_ref, step


def _port_step(fe, jstate, jcam, frame, stop_at_match=False):
    """One port ``tracking_step_cam`` from the reference's state; with
    ``stop_at_match``, only up to its ``match_lines`` call, whose
    arguments it returns."""
    state = convert.track_state_from_numpy(jstate, "cpu")
    cam = convert.cam_state_from_numpy(jcam, "cpu")
    assert cam.fw.ids.dtype == torch.int32 and cam.live.dtype == torch.bool
    inp = convert.frame_input_cam_from_numpy(frame, "cpu")
    if not stop_at_match:
        _, (out, cam_out) = tcpl.tracking_step_cam(state, cam, inp, fe.consts, fe.dcfg, fe.scfg, fe.ccfg, fe.cdyn)
        return out, cam_out

    class Matched(Exception):
        pass

    def stop(*args, **kw):
        raise Matched(args)

    match, tmm.match_lines = tmm.match_lines, stop
    try:
        tcpl.tracking_step_cam(state, cam, inp, fe.consts, fe.dcfg, fe.scfg, fe.ccfg, fe.cdyn)
    except Matched as m:
        return m.args[0]
    finally:
        tmm.match_lines = match
    raise AssertionError("tracking_step_cam did not call match_lines")


def _f64(x):
    if isinstance(x, tuple):
        return type(x)(*map(_f64, x))
    return x.double() if x.is_floating_point() else x


def _tied_lines(match_args, resolution):
    """Indices of the submap lines to leave out so that no matched scan
    line has a second candidate within ``TIE_RAD`` of its best (in
    float64, with ``match_lines``'s candidate gate and angle): each round
    leaves out such second candidates, until none is left."""
    ref, scan, p, q, Til = map(_f64, match_args)
    T12 = geo.tf_inv(geo.make_tf(ref.pose_p, ref.pose_q) @ Til) @ (geo.make_tf(p, q) @ Til)
    q1, q2 = geo.tf_apply(T12, scan.p1), geo.tf_apply(T12, scan.p2)
    mid = 0.5 * (q1 + q2)[:, None, :2]
    a, ab = ref.p1[None, :, :2], (ref.p2 - ref.p1)[None, :, :2]
    t = torch.clamp(((mid - a) * ab).sum(-1) / torch.clamp((ab * ab).sum(-1), min=1e-8), 0.0, 1.0)
    d2 = ((mid - a - t[..., None] * ab) ** 2).sum(-1)
    cand = (d2 <= (1.5 * resolution * math.sqrt(2.0)) ** 2) & scan.line_valid[:, None]
    unit = lambda v: v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-8)
    cos = torch.abs(unit((q2 - q1)[:, :2]) @ unit((ref.p2 - ref.p1)[:, :2]).T)
    ang = torch.arccos(torch.clamp(cos, -1.0, 1.0))
    valid, left_out = ref.valid.clone(), []
    while True:
        a = torch.where(cand & valid[None, :], ang, math.inf)
        best_ang, best = torch.min(a, 1)
        tie = (a <= best_ang[:, None] + TIE_RAD) & (best_ang < math.radians(10.0))[:, None]
        tie[torch.arange(len(best)), best] = False
        cols = torch.nonzero(tie.any(0)).flatten().tolist()
        if not cols:
            return left_out
        left_out += cols
        valid[cols] = False


def test_camera_steps_match_reference(reference):
    prm, frames, k0, before, outs, _, step = reference
    fe = TFrontend(convert.params_from_reference(dataclasses.asdict(prm)), device="cpu")
    steps = [i for i in range(len(before)) if frames[k0 + i].cam_valid][:N_STEPS]
    assert len(steps) == N_STEPS
    for i in steps:
        jstate, jcam = before[i]
        frame = frames[k0 + i]
        ref, ref_cam = outs[i]
        left_out = _tied_lines(_port_step(fe, jstate, jcam, frame, stop_at_match=True), fe.dcfg.resolution)
        if left_out:
            # both packages step without the tied submap lines
            pair = jstate.pair
            valid = pair.ref.valid.copy()
            valid[left_out] = False
            jstate = jstate._replace(pair=pair._replace(ref=pair.ref._replace(valid=valid)))
            _, (ref, ref_cam) = step(*jax.tree_util.tree_map(jnp.asarray, (jstate, jcam, frame)))
            ref, ref_cam = jax.tree_util.tree_map(np.asarray, (ref, ref_cam))
        out, cam_out = _port_step(fe, jstate, jcam, frame)
        msg = f"step {i} ({len(left_out)} tied submap lines left out)"
        assert cam_out.valid and bool(ref_cam.valid)
        np.testing.assert_allclose(cam_out.p.numpy(), ref_cam.p, atol=5e-3, err_msg=f"camera frame {i}: {msg}")
        np.testing.assert_allclose(out.p.numpy(), ref.p, atol=5e-3, err_msg=f"laser frame {i}: {msg}")
        assert abs(int(cam_out.n_tracked) - int(ref_cam.n_tracked)) <= 1, msg
        assert abs(int(cam_out.n_ready) - int(ref_cam.n_ready)) <= 1, msg
    assert max(int(outs[i][1].n_ready) for i in steps) >= 3


def test_camera_frontend_run_shadows_reference(reference):
    prm, _, _, _, _, p_ref, _ = reference
    tprm = convert.params_from_reference(dataclasses.asdict(prm))
    streams = _cut(tsim.simulate(tsim.default_track("L"), tsim.square_room(obstacles=True), tprm, **SIM), T_END_US)
    res = TFrontend(tprm, device="cpu").run(streams, chunk_size=16)
    F = len(res.t_us)
    assert res.p.shape == (F, 3) and F == len(p_ref)
    # tests/test_camera_e2e.py's gates: camera frames solved (>= 20 on the
    # whole track; 17 here, init window included), features tracked,
    # landmarks triangulated, init-window camera frames reported
    assert len(res.cam_t_us) >= 15
    assert np.median(res.cam_n_tracked) >= 5
    assert res.cam_n_ready.max() >= 3
    assert np.isin(res.cam_t_us, res.t_us).any() and not np.isin(res.cam_t_us, streams.laser_t_us).any()
    pairs = metrics.associate_by_time(res.t_us, streams.gt_t_us)
    ate = metrics.ate_rmse(res.T_w_imu()[pairs[:, 0]], streams.gt_T_w_imu[pairs[:, 1]], align=False)
    assert ate < 0.1, ate
    drift = np.linalg.norm(res.p - p_ref, axis=1)
    assert np.median(drift) < 0.05, drift.max()

