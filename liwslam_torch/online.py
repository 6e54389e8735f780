"""Online front-end/back-end coupling: concurrent mapping + live re-basing.

Port of ``liwslam/online.py``.  The reference's keyframe manager runs on
its own thread (``src/trajectory/keyframe_manager.cpp:859-881``), taking
keyframes from a mailbox while the front end keeps tracking; after each
pose-graph solve it publishes ``modify_delta_tf``, which re-bases the live
front-end output (``keyframe_manager.cpp:407-417, 468-473``).

Here the front end drains one chunk at a time (``Frontend.run``), and at
every chunk boundary the chunk's keyframes go to a back-end worker thread.
Loop detection, Kabsch and the pose-graph solve run there while the next
chunk is tracked; whatever correction has landed when a chunk drains is
applied to that chunk's live poses.  On the card the worker issues its
device work on a CUDA stream of its own, so its kernels and its waits for
them do not queue behind the front end's on the default stream; keyframe
payloads cross as numpy arrays, so no tensor changes streams, and the
run waits for the worker's stream before it hands the manager back.  The
live poses and files are computed on the host in numpy.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from liwslam_torch import resolve_device
from liwslam_torch.backend.manager import KeyframeManager
from liwslam_torch.frontend.driver import Frontend, FrontendResult


def _render_live_map(path, snap, resolution, Til):
    """Occupancy snapshot from (p, q, scan_lines) keyframe tuples; runs on
    the async writer thread (visualization.cpp:50-75 equivalent)."""
    from liwslam_torch.backend.loop import densify_lines
    from liwslam_torch.core import geometry as geo
    from liwslam_torch.eval import occupancy

    scans_xy, origins = [], []
    for p, q, (l1, l2) in snap:
        T_wl = geo.make_tf_np(p, q) @ Til
        pts = densify_lines(l1, l2, resolution)
        w = (T_wl[:3, :3] @ pts.T).T + T_wl[:3, 3]
        scans_xy.append(w[:, :2])
        origins.append(T_wl[:2, 3])
    if not scans_xy:
        return
    grid, _origin = occupancy.build_occupancy(scans_xy, np.asarray(origins), resolution=resolution)
    occupancy.write_pgm(path, grid)


@dataclass
class OnlineResult:
    frontend: FrontendResult
    live_T: np.ndarray  # (F,4,4) re-based live poses (IMU frame)
    live_delta_norm: np.ndarray  # (F,) |translation| of the delta applied per frame
    manager: KeyframeManager  # None with backend=False
    wall_s: float
    frontend_busy_s: float
    backend_busy_s: float
    drain_wait_s: float  # main-thread wait for the worker after the front end

    @property
    def overlap_s(self) -> float:
        """Back-end seconds that ran concurrently with front-end work: the
        worker's busy time minus the post-front-end drain wait."""
        return max(0.0, self.backend_busy_s - self.drain_wait_s)


class OnlineRunner:
    """Drives Frontend and KeyframeManager concurrently, on the card unless
    ``device="cpu"`` is asked for."""

    LIVE_MAP_EVERY = 4  # chunks between live_map.pgm refreshes

    def __init__(self, params, live_dir=None, device="cuda", backend=True):
        """``live_dir``: emit during-run artifacts there at chunk boundaries
        (the reference's visualization thread streams markers and occupancy
        while running, visualization.cpp:557-691): ``live_trajectory.txt``
        (TUM, re-based live poses, every chunk) and ``live_map.pgm``
        (occupancy from loop-corrected keyframes, every ``LIVE_MAP_EVERY``
        chunks), written on the async writer thread.

        ``backend=False`` builds no keyframe manager and no worker: the live
        output is the front end's, and no ``live_map.pgm`` is written."""
        self.params = params
        self.device = resolve_device(device)
        self.fe = Frontend(params, device=self.device)
        self.mgr = KeyframeManager(params, device=self.device) if backend else None
        self.live_dir = live_dir
        self._writer = None
        self._chunk_no = 0
        self.live_emits = 0  # trajectory refreshes submitted during the run
        if live_dir is not None:
            from liwslam_torch.utils.asyncwriter import AsyncWriter

            os.makedirs(live_dir, exist_ok=True)
            self._writer = AsyncWriter()
        # a bounded mailbox: a back end that falls behind blocks the front
        # end at a chunk boundary instead of piling up keyframe payloads
        self._q: queue.Queue = queue.Queue(maxsize=256)
        self._stream = torch.cuda.Stream(self.device) if backend and self.device.type == "cuda" else None
        self._be_busy = 0.0
        self._fe_busy = 0.0
        self._worker = None
        self._worker_exc = None  # first exception raised in the worker
        self.q_depth_max = 0  # high-water mark of the keyframe mailbox

    # -- back-end worker -----------------------------------------------------

    def _process_one(self, kf):
        t0 = time.perf_counter()
        self.mgr.add_keyframe(t_us=kf["t_us"], p=kf["p"], q=kf["q"], corners=kf["corners"], scan_lines=kf["scan_lines"])
        self._be_busy += time.perf_counter() - t0

    def _worker_loop(self):
        # keep draining after an error, so a back-end failure cannot wedge
        # the front end against the bounded mailbox; the first exception is
        # raised on the main thread at drain time
        ctx = torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()
        with ctx:
            while True:
                kf = self._q.get()
                if kf is None:
                    return
                if self._worker_exc is not None:
                    continue
                try:
                    self._process_one(kf)
                except Exception as e:  # noqa: BLE001 - re-raised by run()
                    self._worker_exc = e

    # -- main ------------------------------------------------------------------

    def run(self, streams, chunk_size=32) -> OnlineResult:
        from liwslam_torch.core import geometry as geo
        from liwslam_torch.io import tum

        if self.mgr is not None:
            self._worker = threading.Thread(target=self._worker_loop, daemon=True)
            self._worker.start()

        live_T, live_dn, live_ts = [], [], []
        Tiw = self.params.mat_T_imu_to_wheel()

        def emit_live():
            self._chunk_no += 1
            self.live_emits += 1
            out = self.live_dir
            self._writer.submit(
                tum.write_tum, os.path.join(out, "live_trajectory.txt"), np.asarray(live_ts), np.stack(live_T) @ Tiw
            )
            if self.mgr is not None and self._chunk_no % self.LIVE_MAP_EVERY == 0:
                # occupancy from the loop-corrected keyframes; the pose arrays
                # are copied here (the worker replaces them after solves)
                snap = [
                    (kf.p.copy(), kf.q.copy(), kf.scan_lines)
                    for kf in list(self.mgr.keyframes)
                    if kf.scan_lines is not None and len(kf.scan_lines[0])
                ]
                self._writer.submit(
                    _render_live_map, os.path.join(out, "live_map.pgm"), snap,
                    2.0 * self.params.laser_resolution, self.params.mat_T_imu_to_laser(),
                )

        def on_chunk(info):
            # hand this chunk's keyframes to the back end (mailbox push,
            # keyframe_manager.cpp:399-406) ...
            for kf in info["keyframes"] if self.mgr is not None else ():
                self._q.put(kf)
                self.q_depth_max = max(self.q_depth_max, self._q.qsize())
            # ... and re-base this chunk's live output with whatever
            # correction has landed (update_other_frame semantics)
            delta = self.mgr.modify_delta_tf() if self.mgr is not None else np.eye(4)
            dp = np.linalg.norm(delta[:3, 3])
            for p, q in zip(info["p"], info["q"]):
                live_T.append(delta @ geo.make_tf_np(p, q))
                live_dn.append(dp)
            live_ts.extend(int(t) for t in info["t_us"])
            if self._writer is not None and live_T:
                emit_live()

        t_start = time.perf_counter()
        try:
            res = self.fe.run(streams, chunk_size=chunk_size, chunk_callback=on_chunk)
        finally:
            self._fe_busy = time.perf_counter() - t_start
            drain_wait = 0.0
            if self._worker is not None:
                t_d = time.perf_counter()
                self._q.put(None)
                self._worker.join()
                if self._stream is not None:
                    # the worker's last keyframe may leave pool writes queued
                    # on its stream with no host read after them: finish them
                    # before the caller uses the manager on another stream
                    self._stream.synchronize()
                drain_wait = time.perf_counter() - t_d
            errs = self._writer.close() if self._writer is not None else []
        if self._worker_exc is not None:
            raise self._worker_exc
        if errs:
            raise RuntimeError("live artifact writer failed: " + "; ".join(errs))
        wall = time.perf_counter() - t_start

        # init-window frames precede the first chunk: identity correction
        n_init = len(res.p) - len(live_T)
        init_T = res.T_w_imu()[:n_init]
        live = np.concatenate([init_T, np.stack(live_T)]) if live_T else init_T
        dn = np.concatenate([np.zeros(n_init), np.asarray(live_dn)])
        return OnlineResult(
            frontend=res,
            live_T=live,
            live_delta_norm=dn,
            manager=self.mgr,
            wall_s=wall,
            frontend_busy_s=self._fe_busy,
            backend_busy_s=self._be_busy,
            drain_wait_s=drain_wait,
        )
