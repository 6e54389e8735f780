"""Host orchestration: stream packing, initialization, chunked tracking.

Port of the laser path of ``liwslam/frontend/driver.py``:

- the dispatch queue (``dispatch.h:192-241``): offline streams are merged
  into strict global time order once, and every IMU/wheel sample is
  packed into the laser frame interval it precedes;
- ``trajectory::check_and_processing_initialize`` (trajectory.cpp:381-487):
  the 10-frame bootstrap window, its >=2-matched-lines gate and full reset
  on failure, then the init solve (``gn.lm_solve``, QR), the submap
  rebuild and the marginalization that seeds the prior;
- tracking: ``pipeline.tracking_step`` per frame, chunks of frames moved to
  and from the device at once.

With ``enable_camera`` the first camera message after each laser frame is
a window frame of its own (``frontend/camera_pipeline``), in the init
window too; the camera images stay in the caller's one array and are
staged to the device per chunk (``Frontend.stage``), never copied into
each packed frame.

One difference from the reference package: each init-window interval is
integrated with ``preintegration.imu_interval_parallel`` (as the tracking
step does) where the reference package runs the per-sample recursion; the
two agree up to float reassociation, because the packer keeps every
interval's samples a valid prefix (``_split_frame`` moves the samples
after a camera stamp to the front).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from liwslam_torch import resolve_device
from liwslam_torch.camera import features as ft
from liwslam_torch.core import geometry as geo
from liwslam_torch.frontend import camera_pipeline as cpl
from liwslam_torch.frontend import matching as mm
from liwslam_torch.frontend import pipeline as pl
from liwslam_torch.frontend import preintegration as pre
from liwslam_torch.io import dispatch as dp
from liwslam_torch.parallel import multiseq
from liwslam_torch.solve import factors as fac
from liwslam_torch.solve import gn


@dataclass
class FrontendResult:
    """Per-frame front-end outputs (the TUM 'fornt_end.txt' equivalent)."""

    t_us: np.ndarray  # (F,)
    p: np.ndarray  # (F,3) IMU-frame world position
    q: np.ndarray  # (F,3)
    v: np.ndarray  # (F,3)
    bs: np.ndarray  # (F,6)
    is_keyframe: np.ndarray  # (F,)
    n_match: np.ndarray  # (F,)
    n_lines: np.ndarray  # (F,)
    kf_corners: list  # per keyframe: (k,3) world-frame corner arrays
    kf_indices: np.ndarray  # frame indices of keyframes
    kf_scans: list  # per keyframe: (p1, p2) line arrays (laser frame)
    # accepted camera frames (enable_camera only; empty otherwise), the
    # init window's first, in time order
    cam_t_us: np.ndarray = None  # (C,) stamps
    cam_p: np.ndarray = None  # (C,3) camera-frame-time IMU poses
    cam_q: np.ndarray = None  # (C,3)
    cam_n_tracked: np.ndarray = None  # (C,)
    cam_n_ready: np.ndarray = None  # (C,)

    def T_w_imu(self):
        return geo.make_tf(torch.as_tensor(self.p), torch.as_tensor(self.q)).numpy()

    def tum_poses(self, T_imu_to_wheel):
        """Wheel/base-frame TUM poses (trajectory.cpp:549-559)."""
        return self.T_w_imu() @ np.asarray(T_imu_to_wheel)


def _pad(a, n, fill=0):
    a = np.asarray(a)
    out = np.full((n,) + a.shape[1:], fill, a.dtype)
    k = min(len(a), n)
    out[:k] = a[:k]
    return out, k


def clean_scan(points, valid, min_range=0.1, min_spacing=0.01):
    """convert::laser_to_point_times filters (common.cpp:4-40): drop
    NaN/inf/short returns and points closer than 1 cm to their predecessor."""
    pts = np.asarray(points, np.float32)
    ok = np.asarray(valid, bool) & np.isfinite(pts).all(-1)
    ok &= np.linalg.norm(pts[:, :2], axis=-1) >= min_range
    # spacing filter against the previous raw point (differs from "previous
    # kept point" only on runs of near-duplicates)
    d = np.linalg.norm(np.diff(pts[:, :2], axis=0), axis=-1)
    ok[1:] &= (d >= min_spacing) | ~ok[:-1]
    return pts, ok


class Sequences(NamedTuple):
    """B sequences packed and initialized for the batched step
    (``parallel/multiseq``): their stacked states and, per sequence, its
    packed frames (numpy), frame stamps and first tracked frame."""

    states: "pl.TrackState"  # (B, ...)
    frames: list  # per sequence: packed FrameInputs
    stamps: list  # per sequence: (F_b,) frame stamps
    first: list  # per sequence: index of its first tracked frame
    n_common: int  # tracked frames every sequence has


def concat_sequences(parts, device=None) -> Sequences:
    """Several ``Sequences`` side by side, in order: their states
    concatenated on ``device`` (by default the first part's), their frames,
    stamps and first frames listed, ``n_common`` the least of theirs."""
    dev = device if device is not None else parts[0].states.prior_J.device
    return Sequences(
        tree_map(lambda *xs: torch.cat([x.to(dev) for x in xs]), *[s.states for s in parts]),
        [f for s in parts for f in s.frames],
        [t for s in parts for t in s.stamps],
        [k for s in parts for k in s.first],
        min(s.n_common for s in parts),
    )


class PackedCam(NamedTuple):
    """One laser interval with its camera messages, packed on the host; the
    images are indices into the stream's image array (-1: none)."""

    base: "pl.FrameInput"  # numpy leaves
    cam_idx: int  # accepted camera message (the first of the interval)
    cam_t_us: np.int32  # its stamp relative to the previous frame stamp
    extra_idx: np.ndarray  # (NE,) int64: the interval's later messages


def to_device(tree, device):
    """A NamedTuple of numpy arrays (or stacked lists of them) as tensors."""
    return type(tree)(*[torch.as_tensor(np.asarray(a)).to(device) for a in tree])


class Frontend:
    """Streaming front end: sensor streams in, trajectory out.  Runs on the
    card unless ``device="cpu"`` is asked for."""

    def __init__(self, params, device="cuda"):
        self.params = params
        self.device = resolve_device(device)
        self.consts = fac.make_consts(params, self.device)
        self.scfg = pl.make_static_cfg(params)
        self.dcfg = pl.make_dyn_cfg(params, self.device)
        if params.enable_camera:
            self.ccfg = cpl.make_cam_static_cfg(params)
            self.cdyn = cpl.make_cam_dyn_cfg(params, self.device)
        # camera entries solved inside the init window: (t_us, p, q,
        # n_tracked, n_ready), filled by _finish_init, reported by run()
        self._init_cam_rows = []

    # -- per-frame pieces of the init window --------------------------------

    def _preint(self, imu_c, wheel_c, inp: pl.FrameInput, new_ba, new_bw):
        """Preintegrate one interval.  Returns the 'keep' carries (frame
        skipped: integrals keep accumulating), the 'next' carries (frame
        accepted: integrals reset) and both results."""
        imu_c = pre.imu_interval_parallel(
            imu_c, inp.imu_acc, inp.imu_gyro, inp.imu_t_us, inp.imu_mask, inp.dt_us, self.dcfg.imu_Q
        )
        imu_res = pre.imu_result(imu_c)
        wheel_c = pre.wheel_add_samples(wheel_c, inp.wheel_pose, inp.wheel_t_us, inp.wheel_mask)
        wheel_c = pre.wheel_update_only_t(wheel_c, inp.dt_us)
        wheel_res = pre.wheel_result(wheel_c, self.dcfg.wheel_sigma)
        keep = (pre.imu_rebase(imu_c, inp.dt_us), pre.wheel_rebase(wheel_c, inp.dt_us))
        imu_next = pre.imu_reset(0, new_ba, new_bw)._replace(
            last_acc=imu_c.last_acc,
            last_gyro=imu_c.last_gyro,
            last_t_us=imu_c.last_t_us - inp.dt_us,
            has_sample=imu_c.has_sample,
        )
        nxt = (imu_next, pre.wheel_rebase(pre.wheel_reset(wheel_c), inp.dt_us))
        return keep, nxt, imu_res, wheel_res

    def _extract(self, pts, valid):
        return pl.extract(pts, valid, self.dcfg, self.scfg)

    # -- stream packing ------------------------------------------------------

    def pack_frames(self, streams):
        """Slice IMU/wheel streams into per-laser-frame FrameInputs (numpy)
        for laser frames relative to their predecessors, plus the frame
        timestamps.  With ``enable_camera`` each frame is a
        :class:`PackedCam` that names its interval's camera messages by
        their index in ``streams.cam_images``."""
        prm = self.params
        use_cam = prm.enable_camera
        sensor_times = [
            np.asarray(streams.imu_t_us) * 1e-6,
            np.asarray(streams.wheel_t_us) * 1e-6,
            np.asarray(streams.laser_t_us) * 1e-6,
        ]
        if use_cam:
            cam_ts_all = np.asarray(getattr(streams, "cam_t_us", np.zeros(0, np.int64)))
            if len(cam_ts_all) == 0:
                raise ValueError("enable_camera=True but the stream has no camera data")
            sensor_times.append(cam_ts_all * 1e-6)
        order_s, order_i = dp.merge(sensor_times, watermark=1, drain=True)
        imu_keep = np.sort(order_i[order_s == 0])
        wheel_keep = np.sort(order_i[order_s == 1])
        laser_keep = np.sort(order_i[order_s == 2])
        cam_keep = np.sort(order_i[order_s == 3])

        lt = np.asarray(streams.laser_t_us)[laser_keep]
        laser_orig = laser_keep
        # FPS frame gate (trajectory.cpp:170): skip laser frames closer than
        # min_delta_t to the last accepted frame; their IMU/wheel samples
        # fall into the next accepted frame's interval
        min_dt_us = int(round(prm.min_delta_t * 1e6))
        if len(lt) > 1 and min_dt_us > 1:
            keep = [0]
            for idx in range(1, len(lt)):
                if int(lt[idx]) - int(lt[keep[-1]]) >= min_dt_us:
                    keep.append(idx)
            keep = np.asarray(keep)
            lt = lt[keep]
            laser_orig = laser_orig[keep]
        it = np.asarray(streams.imu_t_us)[imu_keep]
        wt = np.asarray(streams.wheel_t_us)[wheel_keep]
        imu_acc_f = np.asarray(streams.imu_acc)[imu_keep]
        imu_gyro_f = np.asarray(streams.imu_gyro)[imu_keep]
        wheel_pose_f = np.asarray(streams.wheel_pose)[wheel_keep]
        if use_cam:
            # capacity for the interval's later camera messages: 0 when the
            # camera rate is at most the laser rate
            ct = cam_ts_all[cam_keep]
            bounds = np.concatenate([[0], lt])
            n_in = [int(np.count_nonzero((ct > a) & (ct <= b))) for a, b in zip(bounds[:-1], bounds[1:])]
            n_extra = max([0] + [n - 1 for n in n_in])
        frames = []
        for k in range(len(lt)):
            t0 = lt[k - 1] if k > 0 else 0
            t1 = lt[k]
            si = (it > t0) & (it <= t1)
            sw = (wt > t0) & (wt <= t1)
            acc, ni = _pad(imu_acc_f[si], prm.max_imu_per_frame)
            gyr, _ = _pad(imu_gyro_f[si], prm.max_imu_per_frame)
            its, _ = _pad((it[si] - t0).astype(np.int32), prm.max_imu_per_frame)
            wp, nw = _pad(wheel_pose_f[sw], prm.max_wheel_per_frame)
            wp[nw:] = np.eye(4, dtype=np.float32)
            wts, _ = _pad((wt[sw] - t0).astype(np.int32), prm.max_wheel_per_frame)
            ko = laser_orig[k]
            pts, ok = clean_scan(streams.laser_points[ko], streams.laser_valid[ko])
            pts, _ = _pad(pts, prm.max_points)
            okp, _ = _pad(ok, prm.max_points)
            rayt, _ = _pad(streams.laser_times_rel[ko], prm.max_points)
            base = pl.FrameInput(
                dt_us=np.int32(t1 - t0),
                imu_acc=acc,
                imu_gyro=gyr,
                imu_t_us=its,
                imu_mask=np.arange(prm.max_imu_per_frame) < ni,
                wheel_pose=wp,
                wheel_t_us=wts,
                wheel_mask=np.arange(prm.max_wheel_per_frame) < nw,
                points=pts,
                point_valid=okp,
                ray_t=rayt,
            )
            if use_cam:
                # the first camera message after the previous laser frame is
                # the interval's camera frame (trajectory.cpp:301); later
                # ones are LK-tracked only (trajectory.cpp:279-310)
                sel = cam_keep[np.flatnonzero((ct > t0) & (ct <= t1))]
                extra = np.full(n_extra, -1, np.int64)
                extra[: max(len(sel) - 1, 0)] = sel[1:]
                base = PackedCam(
                    base=base,
                    cam_idx=int(sel[0]) if len(sel) else -1,
                    cam_t_us=np.int32(int(cam_ts_all[sel[0]]) - t0 if len(sel) else 0),
                    extra_idx=extra,
                )
            frames.append(base)
        return frames, lt

    def stage(self, frames, images):
        """PackedCam frames on the device as ``camera_pipeline.
        FrameInputCam``: one copy of the chunk's images to the card, and the
        frames' images as views of it."""
        idx = sorted({i for f in frames for i in (f.cam_idx, *f.extra_idx) if i >= 0})
        row = {i: j for j, i in enumerate(idx)}
        imgs = torch.as_tensor(np.asarray(images[idx], np.float32)).to(self.device)
        bases = self.stack_frames([f.base for f in frames])
        cam_t = torch.as_tensor(np.asarray([f.cam_t_us for f in frames], np.int32)).to(self.device)
        out = []
        for j, f in enumerate(frames):
            out.append(
                cpl.FrameInputCam(
                    base=pl.FrameInput(*[t[j] for t in bases]),
                    cam_img=imgs[row[f.cam_idx]] if f.cam_idx >= 0 else None,
                    cam_t_us=cam_t[j],
                    cam_valid=f.cam_idx >= 0,
                    cam_extra_imgs=tuple(imgs[row[i]] for i in f.extra_idx if i >= 0),
                    cam_extra_mask=f.extra_idx >= 0,
                )
            )
        return out

    # -- initialization ------------------------------------------------------

    @staticmethod
    def _split_frame(base: pl.FrameInput, cam_t: int):
        """Split one interval's FrameInput (numpy) at the camera stamp.  The
        second part's samples move to the front of their arrays, so every
        part's mask stays a valid prefix (``imu_interval_parallel``)."""
        cam_t = int(cam_t)

        def front(mask, *arrays):
            order = np.argsort(~mask, kind="stable")
            return (mask[order],) + tuple(a[order] for a in arrays)

        m2i = base.imu_mask & (base.imu_t_us > cam_t)
        m2w = base.wheel_mask & (base.wheel_t_us > cam_t)
        m2i_f, acc, gyr, its = front(m2i, base.imu_acc, base.imu_gyro, base.imu_t_us)
        m2w_f, wp, wts = front(m2w, base.wheel_pose, base.wheel_t_us)
        inp_a = base._replace(
            dt_us=np.int32(cam_t),
            imu_mask=base.imu_mask & (base.imu_t_us <= cam_t),
            wheel_mask=base.wheel_mask & (base.wheel_t_us <= cam_t),
        )
        inp_b = base._replace(
            dt_us=np.int32(int(base.dt_us) - cam_t),
            imu_acc=acc,
            imu_gyro=gyr,
            imu_t_us=(its - cam_t).astype(np.int32),
            imu_mask=m2i_f,
            wheel_pose=wp,
            wheel_t_us=(wts - cam_t).astype(np.int32),
            wheel_mask=m2w_f,
        )
        return inp_a, inp_b

    def initialize(self, frames, lt, images=None):
        """The INITIALIZING state machine.  Returns (TrackState, first
        tracking frame index, init window WindowState, window times,
        CamTrackState or None).

        With ``enable_camera`` (``images``: the stream's image array) the
        window interleaves camera frames as the reference does
        (trajectory.cpp:279-370): ``slide_window_size`` counts frames of
        both kinds, the first frame must be laser, a camera frame carries
        its own preintegration interval, and LK runs on every camera
        message before any accept gate."""
        prm = self.params
        dev = self.device
        W = prm.slide_window_size
        z3 = torch.zeros(3, dtype=torch.float32, device=dev)
        Tiw64 = prm.mat_T_imu_to_wheel()
        p0, q0 = geo.log_SE3(geo.tf_inv(self.consts.T_imu_to_wheel))
        use_cam = prm.enable_camera
        self._init_cam_rows = []
        cam_state = None
        if use_cam:
            ccfg, cdyn = self.ccfg, self.cdyn
            cam_state = cpl.init_cam_state(images.shape[1], images.shape[2], ccfg, dev)
            img = lambda i: torch.as_tensor(np.asarray(images[i], np.float32)).to(dev)

            def observe_all(cs, fk):
                # the accepted message, then the interval's later ones (LK only)
                cs = cpl.observe(cs, img(fk.cam_idx), ccfg, cdyn)
                for i in fk.extra_idx[fk.extra_idx >= 0]:
                    cs = cpl.observe(cs, img(i), ccfg, cdyn, replenish=False)
                return cs

        def dead_reckon(cur_p, cur_q, wheel_res):
            delta_imu = Tiw64 @ wheel_res.delta_T.cpu().double().numpy() @ np.linalg.inv(Tiw64)
            T_new = geo.make_tf(cur_p, cur_q).cpu().double().numpy() @ delta_imu
            return geo.log_SE3(torch.as_tensor(T_new, dtype=torch.float32).to(dev))

        k = 0
        n_frames = len(frames)
        while True:
            # fresh session state (init_current_status, trajectory.cpp:39-68)
            imu_c = pre.imu_reset(0, z3, z3)
            wheel_c = pre.wheel_reset(0, dev)
            cur_p, cur_q = p0, q0
            window = []
            cam_entries = []  # window indices of camera entries
            if use_cam:
                # a failed window discards its observations; the LK chain
                # survives (the reference's camera_manager outlives a reset)
                cam_state = cam_state._replace(
                    fw=cam_state.fw._replace(
                        obs_mask=torch.zeros_like(cam_state.fw.obs_mask),
                        ready=torch.zeros_like(cam_state.fw.ready),
                    ),
                    ring_valid=torch.zeros_like(cam_state.ring_valid),
                )
            front_sub = None
            started = False
            imu_seen = wheel_seen = 0
            while k < n_frames:
                fk = frames[k]
                base_np = fk.base if use_cam else fk
                has_cam = use_cam and fk.cam_idx >= 0
                inp = to_device(base_np, dev)
                imu_seen += int(np.sum(base_np.imu_mask))
                wheel_seen += int(np.sum(base_np.wheel_mask))
                # feed samples even for skipped frames (preint keeps running)
                keep, nxt, imu_res, wheel_res = self._preint(imu_c, wheel_c, inp, z3, z3)
                accepted = True
                if imu_seen < 2 or wheel_seen < 2:
                    accepted = False
                elif not started:
                    # static-start gate (trajectory.cpp:163-165): wheel delta
                    # conjugated into the laser frame
                    dT = wheel_res.delta_T.cpu().double().numpy()
                    Tlw = np.linalg.inv(prm.mat_T_imu_to_laser()) @ Tiw64
                    dl = Tlw @ dT @ np.linalg.inv(Tlw)
                    dp_, dq_ = geo.log_SE3(torch.as_tensor(dl, dtype=torch.float32))
                    if (
                        float(torch.linalg.norm(dp_)) < prm.p_motion_threshold
                        and float(torch.linalg.norm(dq_)) < prm.q_motion_threshold
                    ):
                        accepted = False
                    else:
                        started = True
                if not accepted:
                    imu_c, wheel_c = keep
                    if has_cam:
                        cam_state = observe_all(cam_state, fk)
                    k += 1
                    continue
                if has_cam and window:
                    # camera window entry with its own preintegration interval
                    inp_a, inp_b = self._split_frame(base_np, fk.cam_t_us)
                    _, (imu_c, wheel_c), imu_res_a, wheel_res_a = self._preint(
                        imu_c, wheel_c, to_device(inp_a, dev), z3, z3
                    )
                    cam_p, cam_q = dead_reckon(cur_p, cur_q, wheel_res_a)
                    cam_state = cpl.observe(cam_state, img(fk.cam_idx), ccfg, cdyn)
                    cam_state = cpl.record(cam_state, cam_p, cam_q, cdyn)
                    window.append(
                        dict(t_us=int(lt[k - 1] if k else 0) + int(fk.cam_t_us), p=cam_p, q=cam_q,
                             imu=imu_res_a, wheel=wheel_res_a, feats=None, match=None,
                             n_tracked=int(torch.sum(cam_state.live)))
                    )
                    cam_entries.append(len(window) - 1)
                    for i in fk.extra_idx[fk.extra_idx >= 0]:
                        cam_state = cpl.observe(cam_state, img(i), ccfg, cdyn, replenish=False)
                    cur_p, cur_q = cam_p, cam_q
                    _, (imu_c, wheel_c), imu_res, wheel_res = self._preint(
                        imu_c, wheel_c, to_device(inp_b, dev), z3, z3
                    )
                else:
                    if has_cam:  # the first window frame must be laser (trajectory.cpp:303)
                        cam_state = observe_all(cam_state, fk)
                    imu_c, wheel_c = nxt
                cur_p, cur_q = dead_reckon(cur_p, cur_q, wheel_res)
                feats = self._extract(inp.points, inp.point_valid)
                if front_sub is None:
                    front_sub = mm.submap_from_scan(feats, cur_p, cur_q, prm.ref_capacity)
                    match = None
                else:
                    match = mm.match_lines(
                        front_sub, feats, cur_p, cur_q, self.consts.T_imu_to_laser,
                        resolution=self.dcfg.resolution,
                    )
                    if int(match.n) < 2:
                        # reset everything (trajectory.cpp:412-418)
                        k += 1
                        break
                window.append(
                    dict(t_us=int(lt[k]), p=cur_p, q=cur_q, imu=imu_res,
                         wheel=wheel_res, feats=feats, match=match)
                )
                k += 1
                if len(window) >= W:
                    track, st_opt, cam_state = self._finish_init(window, cam_state, cam_entries)
                    times = np.asarray([f["t_us"] for f in window])
                    return track, k, st_opt, times, cam_state
            else:
                raise RuntimeError(
                    f"stream ended during initialization (frame {k}/{n_frames})"
                )

    def _finish_init(self, window, cam_state=None, cam_entries=()):
        """init_solve + submap rebuild + marginalization -> (TrackState,
        window state, CamTrackState or None).

        With camera entries in the window the init solve carries
        reprojection rows over free landmarks, as
        ``do_init_solve(..., enable_camera_factor=true)`` does
        (solver.cpp:60-85,171-174): landmarks are triangulated first from
        the dead-reckoned ring poses (``estimate_features(true)``,
        trajectory.cpp:419) and those that fail are dropped."""
        prm = self.params
        dev = self.device
        consts = self.consts
        W = len(window)
        M = prm.max_lines
        f32 = dict(dtype=torch.float32, device=dev)
        st = fac.WindowState(
            p=torch.stack([f["p"] for f in window]),
            q=torch.stack([f["q"] for f in window]),
            v=torch.zeros((W, 3), **f32),
            bs=torch.zeros((W, 6), **f32),
        )
        eye = lambda n: torch.eye(n, **f32)
        Ms = M * W
        las = {k: np.zeros((Ms, 3), np.float32) for k in ("l1p1", "l1p2", "l2p1", "l2p2")}
        j_idx = np.zeros(Ms, np.int32)
        lvalid = np.zeros(Ms, bool)
        for i, f in enumerate(window):
            if f["match"] is None:
                continue
            sl = slice(i * M, (i + 1) * M)
            mt = f["match"]
            for key, t in (("l1p1", mt.ref_p1), ("l1p2", mt.ref_p2), ("l2p1", mt.new_p1), ("l2p2", mt.new_p2)):
                las[key][sl] = t.cpu().numpy()
            j_idx[sl] = i
            lvalid[sl] = mt.valid.cpu().numpy()
        first = lambda i, a, b: a if i > 0 else b
        valid_w = torch.as_tensor([i > 0 for i in range(W)], device=dev)
        data = fac.FactorData(
            imu_X=torch.stack([first(i, f["imu"].X, torch.zeros(15, **f32)) for i, f in enumerate(window)]),
            imu_J=torch.stack([first(i, f["imu"].J, eye(15)) for i, f in enumerate(window)]),
            imu_sqrtP=torch.stack([first(i, f["imu"].sqrt_inverse_P, eye(15)) for i, f in enumerate(window)]),
            imu_Dt=torch.stack([first(i, f["imu"].Dt, torch.zeros((), **f32)) for i, f in enumerate(window)]),
            imu_valid=valid_w,
            wheel_dT=torch.stack([first(i, f["wheel"].delta_T, eye(4)) for i, f in enumerate(window)]),
            wheel_sqrt=torch.stack([first(i, f["wheel"].sqrt_inverse_P, eye(3)) for i, f in enumerate(window)]),
            wheel_valid=valid_w,
            laser_l1p1=torch.as_tensor(las["l1p1"], device=dev),
            laser_l1p2=torch.as_tensor(las["l1p2"], device=dev),
            laser_l2p1=torch.as_tensor(las["l2p1"], device=dev),
            laser_l2p2=torch.as_tensor(las["l2p2"], device=dev),
            laser_i_idx=torch.zeros(Ms, dtype=torch.int32, device=dev),  # vs frame 0
            laser_j_idx=torch.as_tensor(j_idx, device=dev),
            laser_ref_p=torch.zeros((Ms, 3), **f32),
            laser_ref_q=torch.zeros((Ms, 3), **f32),
            laser_valid=torch.as_tensor(lvalid, device=dev),
            ground_weight=torch.full((), float(np.sqrt(W)), **f32),
            frame_valid=torch.ones(W, dtype=torch.bool, device=dev),
            prior_J=torch.zeros((15, 15), **f32),
            prior_X=torch.zeros(15, **f32),
            prior_res=torch.zeros(15, **f32),
            prior_idx=torch.zeros((), dtype=torch.int32, device=dev),
            prior_valid=torch.zeros((), dtype=torch.bool, device=dev),
        )
        base_res = lambda x: fac.stack_residuals(fac.WindowState.from_flat(x[: W * 15], W), data, consts)
        use_cam = cam_state is not None and len(cam_entries) > 0
        if use_cam:
            ccfg, cdyn = self.ccfg, self.cdyn
            Wc, F = ccfg.obs_window, ccfg.n_features
            # obs slot w <-> window frame: the last Wc camera entries sit in
            # the newest ring / observation slots, by construction of record()
            taken = list(cam_entries)[-Wc:]
            slot_to_frame = np.full(Wc, -1, np.int64)
            slot_to_frame[Wc - len(taken) :] = taken
            slot_valid = torch.as_tensor(slot_to_frame >= 0).to(dev)
            s2f = torch.as_tensor(np.maximum(slot_to_frame, 0)).to(dev)
            fw0 = ft.triangulate_ready(
                cam_state.fw._replace(ready=torch.zeros_like(cam_state.fw.ready)),
                cam_state.ring_p, cam_state.ring_q, cdyn.T_imu_to_camera,
                min_obs=min(ccfg.min_obs, max(2, len(taken) // 2)), min_parallax=cdyn.min_parallax,
            )
            ready = fw0.ready
            use = (fw0.obs_mask & slot_valid[None, :] & ready[:, None]).to(torch.float32)[..., None]

            def res_fn(x):
                stw = fac.WindowState.from_flat(x[: W * 15], W)
                world = x[W * 15 :].reshape(F, 3)
                rows = fac.camera_residual(
                    stw.p[s2f][None], stw.q[s2f][None], world[:, None, :], fw0.obs,
                    cdyn.T_imu_to_camera, cdyn.sqrt_info,
                )
                return torch.cat([base_res(x), (rows * use).reshape(-1)])

            free = torch.cat([torch.ones(W * 15, **f32), ready.to(torch.float32).repeat_interleave(3)])
            x0 = torch.cat([st.flat(), fw0.world.reshape(-1)])
            wrap = lambda x: torch.cat([pl.wrap_q(x[: W * 15], W), x[W * 15 :]])
        else:
            res_fn, free, x0 = base_res, torch.ones(W * 15, **f32), st.flat()
            wrap = lambda x: pl.wrap_q(x, W)
        x_full, _, _ = gn.lm_solve(
            res_fn, x0, free, gn.LMConfig(max_iters=prm.init_solver_max_iterations), wrap_fn=wrap
        )
        x_opt = x_full[: W * 15]
        st_opt = fac.WindowState.from_flat(x_opt, W)
        if use_cam:
            # the optimized landmarks; the ring poses become the optimized
            # camera-frame poses
            fw1 = fw0._replace(
                world=x_full[W * 15 :].reshape(F, 3),
                ids=torch.where(ready, fw0.ids, torch.full_like(fw0.ids, -1)),
                obs_mask=fw0.obs_mask & ready[:, None],
            )
            ring_p, ring_q = cam_state.ring_p.clone(), cam_state.ring_q.clone()
            for w in range(Wc):
                if slot_to_frame[w] >= 0:
                    ring_p[w], ring_q[w] = st_opt.p[slot_to_frame[w]], st_opt.q[slot_to_frame[w]]
            cam_state = cam_state._replace(
                fw=fw1, live=cam_state.live & ready, ring_p=ring_p, ring_q=ring_q, ring_valid=slot_valid
            )
            # the init window's camera entries are reported too; n_ready is
            # the post-init triangulation count, shared by all of them
            n_ready = int(torch.sum(ready))
            self._init_cam_rows = [
                (window[i]["t_us"], st_opt.p[i].cpu().numpy(), st_opt.q[i].cpu().numpy(),
                 window[i]["n_tracked"], n_ready)
                for i in cam_entries
            ]

        # rebuild the submaps from the optimized poses (trajectory.cpp:466-478)
        pair = mm.empty_pair(prm.ref_capacity, dev)
        for i, f in enumerate(window):
            if f["feats"] is None:
                continue
            pair = mm.add_scan(
                pair, f["feats"], st_opt.p[i], st_opt.q[i], consts.T_imu_to_laser,
                ref_n_accumulation=prm.ref_n_accumulation,
                motion_filter_p=self.dcfg.ref_motion_filter_p,
                motion_filter_q=self.dcfg.ref_motion_filter_q,
            )

        # marginalization seeds the prior (trajectory.cpp:479); the laser
        # reference side becomes the frozen optimized frame-0 pose
        data_m = data._replace(
            laser_i_idx=torch.full((Ms,), -1, dtype=torch.int32, device=dev),
            laser_ref_p=st_opt.p[0][None].expand(Ms, 3),
            laser_ref_q=st_opt.q[0][None].expand(Ms, 3),
        )
        res_fn_m = lambda x: fac.stack_residuals(fac.WindowState.from_flat(x, W), data_m, consts)
        lin_J, lin_res, lin_X = gn.marginalize(res_fn_m, x_opt, keep=15)

        track = pl.init_track_state(st_opt.p[-1], st_opt.q[-1], st_opt.v[-1], st_opt.bs[-1], self.scfg)
        track = track._replace(
            pair=pair,
            prior_J=lin_J,
            prior_X=lin_X,
            prior_res=lin_res,
            prior_valid=torch.full((), not prm.fast_mode, dtype=torch.bool, device=dev),
            last_keyframe_T=geo.make_tf(st_opt.p[-1], st_opt.q[-1]) @ consts.T_imu_to_laser,
        )
        return track, st_opt, cam_state

    # -- tracking --------------------------------------------------------------

    def stack_frames(self, frames):
        """Stack FrameInputs (numpy) into one FrameInput of device tensors
        with a leading frame dim."""
        return to_device(pl.FrameInput(*[np.stack(xs) for xs in zip(*frames)]), self.device)

    def init_sequences(self, streams_list) -> Sequences:
        """Pack and initialize B sequences (laser path; each its own host
        init window) and stack their states.  Sequences may differ in
        length after the frame gate: ``n_common`` is the count of tracked
        frames they all have, each counted from its own first tracked
        frame."""
        parts = []
        for streams in streams_list:
            fr, lt = self.pack_frames(streams)
            track, k0, _, _, _ = self.initialize(fr, lt)
            parts.append(Sequences(multiseq.stack_track_states([track]), [fr], [lt], [k0], len(fr) - k0))
        return concat_sequences(parts)

    def stack_sequences(self, seqs: Sequences, j, n):
        """Tracked frames j .. j+n of every sequence (each from its own
        first tracked frame) as one FrameInput of (B, n, ...) tensors."""
        rows = [zip(*fr[k0 + j : k0 + j + n]) for fr, k0 in zip(seqs.frames, seqs.first)]
        return to_device(pl.FrameInput(*[np.stack([np.stack(xs) for xs in f]) for f in zip(*rows)]), self.device)

    def run_chunk(self, track, batch):
        return pl.run_chunk(track, batch, self.consts, self.dcfg, self.scfg)

    def run_chunk_cam(self, track, cam, inputs):
        return cpl.run_chunk_cam(track, cam, inputs, self.consts, self.dcfg, self.scfg, self.ccfg, self.cdyn)

    def run(self, streams, chunk_size=32, chunk_callback=None) -> FrontendResult:
        """Run the full stream.  ``chunk_callback(info)`` fires after each
        chunk's outputs are back on the host, with the chunk's first frame
        index, frame count, stamps and poses, and its keyframes' payloads
        (frame index, stamp, pose, corners and scan lines), as the reference
        package's ``run`` hands chunks to its back end."""
        use_cam = self.params.enable_camera
        images = streams.cam_images if use_cam else None
        frames, lt = self.pack_frames(streams)
        track, k0, st_init, init_times, cam = self.initialize(frames, lt, images)
        n_init = len(init_times)
        out_t = [int(t) for t in init_times]
        rows = {k: [] for k in ("p", "q", "v", "bs", "kf", "nm", "nl")}
        kf_corners, kf_indices, kf_scans = [], [], []
        # (t_us, p, q, n_tracked, n_ready) per accepted camera frame
        cam_rows = list(self._init_cam_rows)
        k = k0
        F = len(frames)
        while k < F:
            n = min(chunk_size, F - k)
            if use_cam:
                (track, cam), (outs, couts) = self.run_chunk_cam(track, cam, self.stage(frames[k : k + n], images))
                couts = cpl.CamFrameOutput(*[c if i == 2 else c.cpu().numpy() for i, c in enumerate(couts)])
                for i in np.flatnonzero(couts.valid):
                    t0 = int(lt[k + i - 1]) if k + i > 0 else 0
                    cam_rows.append(
                        (t0 + int(frames[k + i].cam_t_us), couts.p[i], couts.q[i],
                         int(couts.n_tracked[i]), int(couts.n_ready[i]))
                    )
            else:
                track, outs = self.run_chunk(track, self.stack_frames(frames[k : k + n]))
            outs = pl.FrameOutput(*[t.cpu().numpy() for t in outs])
            chunk_kfs = []
            for i in range(n):
                out_t.append(int(lt[k + i]))
                for key, a in (("p", outs.p), ("q", outs.q), ("v", outs.v), ("bs", outs.bs)):
                    rows[key].append(a[i])
                rows["kf"].append(bool(outs.is_keyframe[i]))
                rows["nm"].append(int(outs.n_match[i]))
                rows["nl"].append(int(outs.n_lines[i]))
                if outs.is_keyframe[i]:
                    kf_indices.append(n_init + len(rows["p"]) - 1)
                    kf_corners.append(outs.kf_corners[i][outs.kf_corner_valid[i]])
                    lv = outs.scan_line_valid[i]
                    kf_scans.append((outs.scan_p1[i][lv], outs.scan_p2[i][lv]))
                    chunk_kfs.append(
                        dict(
                            frame_index=kf_indices[-1], t_us=int(lt[k + i]), p=outs.p[i], q=outs.q[i],
                            corners=kf_corners[-1], scan_lines=kf_scans[-1],
                        )
                    )
            if chunk_callback is not None:
                chunk_callback(
                    dict(
                        frame_start=n_init + k - k0, n=n, t_us=lt[k : k + n], p=outs.p, q=outs.q,
                        keyframes=chunk_kfs,
                    )
                )
            k += n

        def cat(init_a, key):
            a = init_a.cpu().numpy()
            return np.concatenate([a, np.stack(rows[key])]) if rows[key] else a

        cam_col = lambda j, shape: np.stack([r[j] for r in cam_rows]) if cam_rows else np.zeros(shape)
        return FrontendResult(
            t_us=np.asarray(out_t),
            p=cat(st_init.p, "p"),
            q=cat(st_init.q, "q"),
            v=cat(st_init.v, "v"),
            bs=cat(st_init.bs, "bs"),
            is_keyframe=np.asarray([False] * n_init + rows["kf"]),
            n_match=np.asarray([0] * n_init + rows["nm"]),
            n_lines=np.asarray([0] * n_init + rows["nl"]),
            kf_corners=kf_corners,
            kf_indices=np.asarray(kf_indices, np.int64),
            kf_scans=kf_scans,
            cam_t_us=np.asarray([r[0] for r in cam_rows], np.int64),
            cam_p=cam_col(1, (0, 3)),
            cam_q=cam_col(2, (0, 3)),
            cam_n_tracked=np.asarray([r[3] for r in cam_rows], np.int64),
            cam_n_ready=np.asarray([r[4] for r in cam_rows], np.int64),
        )
