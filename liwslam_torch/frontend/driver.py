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

The camera path (``enable_camera``) is not ported yet (ROADMAP queue A,
item 12).  One difference from the reference package: each init-window
interval is integrated with ``preintegration.imu_interval_parallel`` (as
the tracking step does) where the reference package runs the per-sample
recursion; the two agree up to float reassociation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from liwslam_torch import resolve_device
from liwslam_torch.core import geometry as geo
from liwslam_torch.frontend import matching as mm
from liwslam_torch.frontend import pipeline as pl
from liwslam_torch.frontend import preintegration as pre
from liwslam_torch.io import dispatch as dp
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

    def T_w_imu(self):
        return geo.make_tf(torch.as_tensor(self.p), torch.as_tensor(self.q)).numpy()


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


def to_device(tree, device):
    """A NamedTuple of numpy arrays (or stacked lists of them) as tensors."""
    return type(tree)(*[torch.as_tensor(np.asarray(a)).to(device) for a in tree])


class Frontend:
    """Streaming front end: sensor streams in, trajectory out.  Runs on the
    card unless ``device="cpu"`` is asked for."""

    def __init__(self, params, device="cuda"):
        if params.enable_camera:
            raise NotImplementedError(
                "liwslam_torch: the camera path is not ported yet "
                "(ROADMAP.md queue A item 12, kernels B3 and B4)"
            )
        self.params = params
        self.device = resolve_device(device)
        self.consts = fac.make_consts(params, self.device)
        self.scfg = pl.make_static_cfg(params)
        self.dcfg = pl.make_dyn_cfg(params, self.device)

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
        timestamps."""
        prm = self.params
        sensor_times = [
            np.asarray(streams.imu_t_us) * 1e-6,
            np.asarray(streams.wheel_t_us) * 1e-6,
            np.asarray(streams.laser_t_us) * 1e-6,
        ]
        order_s, order_i = dp.merge_numpy(sensor_times, [True] * 3, watermark=1, drain=True)
        imu_keep = np.sort(order_i[order_s == 0])
        wheel_keep = np.sort(order_i[order_s == 1])
        laser_keep = np.sort(order_i[order_s == 2])

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
            frames.append(
                pl.FrameInput(
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
            )
        return frames, lt

    # -- initialization ------------------------------------------------------

    def initialize(self, frames, lt):
        """The INITIALIZING state machine.  Returns (TrackState, first
        tracking frame index, init window WindowState, window times)."""
        prm = self.params
        dev = self.device
        W = prm.slide_window_size
        z3 = torch.zeros(3, dtype=torch.float32, device=dev)
        Tiw64 = prm.mat_T_imu_to_wheel()
        p0, q0 = geo.log_SE3(geo.tf_inv(self.consts.T_imu_to_wheel))

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
            front_sub = None
            started = False
            imu_seen = wheel_seen = 0
            while k < n_frames:
                fk = frames[k]
                inp = to_device(fk, dev)
                imu_seen += int(np.sum(fk.imu_mask))
                wheel_seen += int(np.sum(fk.wheel_mask))
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
                    k += 1
                    continue
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
                    track, st_opt = self._finish_init(window)
                    times = np.asarray([f["t_us"] for f in window])
                    return track, k, st_opt, times
            else:
                raise RuntimeError(
                    f"stream ended during initialization (frame {k}/{n_frames})"
                )

    def _finish_init(self, window):
        """init_solve + submap rebuild + marginalization -> TrackState."""
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
        res_fn = lambda x: fac.stack_residuals(fac.WindowState.from_flat(x, W), data, consts)
        x_opt, _, _ = gn.lm_solve(
            res_fn,
            st.flat(),
            torch.ones(W * 15, **f32),
            gn.LMConfig(max_iters=prm.init_solver_max_iterations),
            wrap_fn=lambda x: pl.wrap_q(x, W),
        )
        st_opt = fac.WindowState.from_flat(x_opt, W)

        # rebuild the submaps from the optimized poses (trajectory.cpp:466-478)
        pair = mm.empty_pair(prm.ref_capacity, dev)
        for i, f in enumerate(window):
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
        return track, st_opt

    # -- tracking --------------------------------------------------------------

    def stack_frames(self, frames):
        """Stack FrameInputs (numpy) into one FrameInput of device tensors
        with a leading frame dim."""
        return to_device(pl.FrameInput(*[np.stack(xs) for xs in zip(*frames)]), self.device)

    def run_chunk(self, track, batch):
        return pl.run_chunk(track, batch, self.consts, self.dcfg, self.scfg)

    def run(self, streams, chunk_size=32, chunk_callback=None) -> FrontendResult:
        """Run the full stream.  ``chunk_callback(info)`` fires after each
        chunk's outputs are back on the host, with the chunk's first frame
        index, frame count, stamps and poses (as the reference package's
        ``run`` hands chunks to its back end)."""
        frames, lt = self.pack_frames(streams)
        track, k0, st_init, init_times = self.initialize(frames, lt)
        n_init = len(init_times)
        out_t = [int(t) for t in init_times]
        rows = {k: [] for k in ("p", "q", "v", "bs", "kf", "nm", "nl")}
        kf_corners, kf_indices, kf_scans = [], [], []
        k = k0
        F = len(frames)
        while k < F:
            n = min(chunk_size, F - k)
            track, outs = self.run_chunk(track, self.stack_frames(frames[k : k + n]))
            outs = pl.FrameOutput(*[t.cpu().numpy() for t in outs])
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
            if chunk_callback is not None:
                chunk_callback(
                    dict(frame_start=n_init + k - k0, n=n, t_us=lt[k : k + n], p=outs.p, q=outs.q)
                )
            k += n

        def cat(init_a, key):
            a = init_a.cpu().numpy()
            return np.concatenate([a, np.stack(rows[key])]) if rows[key] else a

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
        )
