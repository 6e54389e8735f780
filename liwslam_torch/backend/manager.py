"""Keyframe manager: the asynchronous mapping back end.

Port of ``liwslam/backend/manager.py`` (``keyframe_manager``,
``src/trajectory/keyframe_manager.{h,cpp}``): receives keyframes from the
front end, keeps sequential edges from tracking deltas, spawns
corner-constellation descriptor maps, detects loops, solves the pose graph
on a cadence (only when a loop is pending and enough data time has passed,
keyframe_manager.cpp:839-848), and publishes the ``modify_delta_tf``
correction that re-bases the live front-end output
(keyframe_manager.cpp:468-473).

Host orchestration at keyframe rate, in float64 numpy; on the device
(``device``, the card unless the caller asks for the CPU):

- the descriptor pool: a dict of tensors with a leading slot dim, grown by
  doubling and written in place;
- per laser keyframe, the descriptor's pairwise tables and its scoring
  against the gated candidates' pooled maps, with one host-to-device copy
  in (the deduplicated corners, built on the host) plus one for the
  candidates' slots, and one device-to-host copy out (counts and bins);
- the pose-graph solve, dense for a padded graph of at most 64 nodes and
  PCG above, as the reference chooses.

Cadence uses data time, not wall time, so offline runs are deterministic
and replayable.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from liwslam_torch import resolve_device
from liwslam_torch.backend import loop as loop_mod
from liwslam_torch.backend import posegraph as pg
from liwslam_torch.core import geometry as geo


@dataclass
class Keyframe:
    t_us: int
    T_tracking: np.ndarray  # (4,4) front-end pose (IMU frame)
    p: np.ndarray  # (3,) corrected pose (optimized by the pose graph)
    q: np.ndarray  # (3,)
    is_laser: bool
    corners: np.ndarray  # (k,3) accumulated world-frame corners
    scan_lines: tuple  # (p1 (l,3), p2 (l,3)) laser-frame lines
    session: int = 0  # multi-session/multi-robot id (0 = primary)


class KeyframeManager:
    _POOL_FIELDS = ("points", "valid", "dist_q", "ang", "bitmap", "origin")

    def __init__(self, params, device="cuda"):
        self.params = params
        self.device = resolve_device(device)
        self.T_iw = params.mat_T_imu_to_wheel()
        self.keyframes: list[Keyframe] = []
        # per keyframe: the pool slot of its descriptor map, None for
        # non-laser keyframes
        self.map_features: list = []
        self._mf_pool: dict | None = None  # field -> (cap, ...) tensor
        self._mf_slots = 0  # slots used
        # host-side per-map metadata the loop gates read:
        # {n_valid, origin, index, slot}
        self.mf_meta: list = []
        self.seq_edges: list = []  # (i, j, tf12 (4,4))
        self.loop_edges: list = []
        self._modify_delta = {}  # per-session re-basing correction
        self.last_solve_t_us = -(10**15)
        self.has_loop_pending = False
        self.pg_consts = pg.make_pg_consts(params, self.device)
        self.loops_found: list = []  # (i_new, i_old, tf12)
        # candidates that matched the descriptor threshold but were rejected
        # by a safety gate: (reason, i1, i2)
        self.loop_rejections: list = []
        # per-session rolling window of the last submap_count laser
        # keyframes' (index, corners)
        self._corner_hist: dict = {}
        # per add_keyframe a (total_s, device_s) pair: wall time, and the
        # part spent in device work up to its results on the host; solves
        # are also listed on their own, with their counters in "solves"
        self.perf = {"kf_s": [], "solve_s": [], "solves": [], "device_s_acc": 0.0}
        # session co-registration (union-find): sessions joined by a loop
        # edge share a pose-graph frame; odometry-frame gates apply only
        # within a group
        self._session_root: dict = {}

    # ------------------------------------------------------------------

    def _ensure_pool(self):
        """Create the pool, or double it so one more slot fits."""
        prm = self.params
        P = prm.map_corner_capacity
        NW = (prm.n_dist_bins + 31) // 32
        dev = self.device
        if self._mf_pool is None:
            cap = 64
            self._mf_pool = {
                "points": torch.zeros((cap, P, 3), dtype=torch.float32, device=dev),
                "valid": torch.zeros((cap, P), dtype=torch.bool, device=dev),
                "dist_q": torch.zeros((cap, P, P), dtype=torch.int32, device=dev),
                "ang": torch.zeros((cap, P, P), dtype=torch.float32, device=dev),
                "bitmap": torch.zeros((cap, P, NW), dtype=torch.int32, device=dev),
                "origin": torch.zeros((cap, 4, 4), dtype=torch.float32, device=dev),
            }
        cap = self._mf_pool["points"].shape[0]
        if self._mf_slots >= cap:
            self._mf_pool = {f: torch.cat([x, torch.zeros_like(x)]) for f, x in self._mf_pool.items()}
        return self._mf_pool["points"].shape[0]

    def _pool_add(self, mf) -> int:
        """Write a MapFeature's tensors into the next pool slot."""
        self._ensure_pool()
        slot = self._mf_slots
        for f in self._POOL_FIELDS:
            self._mf_pool[f][slot].copy_(getattr(mf, f))
        self._mf_slots += 1
        return slot

    def _fetch_mf(self, slot, index):
        """One pooled MapFeature (views of the pool's slot)."""
        return loop_mod.MapFeature(*[self._mf_pool[f][slot] for f in self._POOL_FIELDS], index=index)

    # ------------------------------------------------------------------

    def add_keyframe(self, t_us, p, q, corners, scan_lines, is_laser=True, session=0):
        """do_add_keyframe (keyframe_manager.cpp:418-482).

        Multi-session extension (no reference counterpart): keyframes carry a
        session id; sequential edges connect only within a session, and loop
        detection also searches other sessions' descriptor maps without the
        min-interval gate; a cross-session loop aligns the sessions through
        the shared pose graph."""
        t_kf0 = time.perf_counter()
        dev0 = self.perf["device_s_acc"]
        prm = self.params
        T_track = geo.make_tf_np(p, q)
        pc, qc = geo.log_SE3_np(self.modify_delta_tf(session) @ T_track)
        kf = Keyframe(
            t_us=int(t_us),
            T_tracking=T_track,
            p=pc,
            q=qc,
            is_laser=is_laser,
            corners=np.asarray(corners).reshape(-1, 3),
            scan_lines=scan_lines,
            session=session,
        )
        self.keyframes.append(kf)
        k = len(self.keyframes) - 1

        prev_same = next((i for i in range(k - 1, -1, -1) if self.keyframes[i].session == session), None)
        if prev_same is not None:
            self.seq_edges.append((prev_same, k, np.linalg.inv(self.keyframes[prev_same].T_tracking) @ T_track))

        if is_laser:
            # the candidate gates run before the descriptor build, so the
            # build, insert and scoring share one round trip to the device
            cands = self._loop_candidates(k)
            slot, newest, n_valid, counts, bins = self._spawn_and_score(k, cands)
            self.map_features.append(slot)
            self.mf_meta.append(
                dict(n_valid=n_valid, origin=np.asarray(self.keyframes[k].T_tracking, np.float64), index=newest, slot=slot)
            )
            loop = None
            if n_valid >= prm.laser_loop_min_match_threshold and len(cands):
                loop = self._examine_candidates(cands, counts, bins, slot, newest)
            if loop is not None:
                self.loop_edges.append(loop)
                self.loops_found.append(loop)
                self.has_loop_pending = True
        else:
            self.map_features.append(None)
            self.mf_meta.append(None)

        if self._is_time_to_solve(t_us):
            self.last_solve_t_us = int(t_us)
            self.perf.setdefault("solve_kf", []).append(k)
            self.solve()
            # re-base every session's live output from its newest keyframe
            # (keyframe_manager.cpp:468-473, per session)
            newest = {}
            for i, kf2 in enumerate(self.keyframes):
                newest[kf2.session] = i
            for s, i in newest.items():
                T_new = geo.make_tf_np(self.keyframes[i].p, self.keyframes[i].q)
                self._modify_delta[s] = T_new @ np.linalg.inv(self.keyframes[i].T_tracking)
            self.has_loop_pending = False
        self.perf["kf_s"].append((time.perf_counter() - t_kf0, self.perf["device_s_acc"] - dev0))
        return kf

    def modify_delta_tf(self, session=0):
        return self._modify_delta.get(session, np.eye(4))

    # -- session co-registration (union-find) ---------------------------

    def _find_session(self, s):
        root = self._session_root.setdefault(s, s)
        while root != self._session_root.setdefault(root, root):
            root = self._session_root[root]
        self._session_root[s] = root
        return root

    def _union_sessions(self, a, b):
        ra, rb = self._find_session(a), self._find_session(b)
        if ra != rb:
            self._session_root[rb] = ra

    def sessions_coregistered(self, a, b) -> bool:
        return self._find_session(a) == self._find_session(b)

    def _is_time_to_solve(self, t_us):
        return self.has_loop_pending and (t_us - self.last_solve_t_us) * 1e-6 > self.params.pose_graph_solve_interval_s

    # ------------------------------------------------------------------

    def _collect_corners(self, k):
        """spawn_laser_map_feature's corner window (keyframe_manager.cpp:
        898-925): the last submap_count laser keyframes' corners,
        newest-first (the dedup is order-sensitive)."""
        prm = self.params
        hist = self._corner_hist.setdefault(self.keyframes[k].session, [])
        hist.append((k, np.asarray(self.keyframes[k].corners).reshape(-1, 3)))
        if len(hist) > prm.submap_count:
            del hist[: len(hist) - prm.submap_count]
        newest = hist[-1][0]
        pts = np.concatenate([c for _, c in reversed(hist)]).astype(np.float32)
        perm = np.random.default_rng(newest).permutation(prm.map_corner_capacity).astype(np.int32)
        return pts, perm, newest

    def _spawn_and_score(self, k, cands):
        """The per-keyframe device work: the new keyframe's descriptor map,
        written into the pool, scored against the candidates' pooled maps
        with probes 0..loop_probe_count-1 (probes past the map's valid
        corners score 0).  Returns (slot, newest, n_valid, counts (C,NP,P),
        bins (C,NP,P))."""
        prm = self.params
        pts, perm, newest = self._collect_corners(k)
        t0 = time.perf_counter()
        kept, n_valid = loop_mod.dedup_corners_device(pts, np.ones(len(pts), bool), prm.d_res, prm.map_corner_capacity)
        mf = loop_mod.map_feature_from_kept(
            kept, n_valid, self.keyframes[newest].T_tracking, d_res=prm.d_res, n_dist_bins=prm.n_dist_bins,
            perm=perm, device=self.device,
        )
        slot = self._pool_add(mf)
        C, NP, P = len(cands), prm.loop_probe_count, prm.map_corner_capacity
        if C == 0:
            z = np.zeros((0, NP, P), np.int32)
            self.perf["device_s_acc"] += time.perf_counter() - t0
            return slot, newest, n_valid, z, z
        idxs = torch.as_tensor(np.asarray([s for _, s in cands], np.int64)).to(self.device)
        pool = self._mf_pool
        m2s = loop_mod.MapFeature(*[pool[f].index_select(0, idxs) for f in self._POOL_FIELDS], index=-1)
        probes = torch.arange(NP, device=self.device)
        counts, bins = loop_mod.score_pairs(
            mf, m2s, probes, a_res=prm.a_res, n_angle_bins=prm.n_angle_bins,
            min_match_threshold=prm.laser_loop_min_match_threshold,
        )
        out = torch.stack([counts, bins]).cpu().numpy()
        self.perf["device_s_acc"] += time.perf_counter() - t0
        return slot, newest, n_valid, out[0], out[1]

    def _loop_candidates(self, k):
        """Host-side candidate gates of laser_loop_detect
        (keyframe_manager.cpp:642-712), evaluated before the descriptor
        build.  Returns [(kf index, slot)]."""
        prm = self.params
        feats = self.map_features
        meta = self.mf_meta
        cur_session = self.keyframes[k].session
        stride = prm.submap_count // 3 + 1
        origin_new = np.asarray(self.keyframes[k].T_tracking, np.float64)
        p_new = self.keyframes[k].p
        cands = []
        for i in range(0, len(feats), stride):
            if feats[i] is None:
                continue
            # same-session revisit: min-interval gate (in keyframes);
            # cross-session candidates are always eligible
            if self.keyframes[i].session == cur_session and len(feats) - i <= prm.loop_detect_min_interval:
                continue
            if meta[i]["n_valid"] < prm.laser_loop_min_match_threshold:
                continue
            # distance gate: same session -> odometry-origin distance (the
            # reference's); co-registered other session -> corrected-pose
            # distance; not yet co-registered -> no gate
            cand_session = self.keyframes[i].session
            if cand_session == cur_session:
                dorigin = np.linalg.inv(origin_new) @ meta[i]["origin"]
                if np.linalg.norm(dorigin[:3, 3]) > prm.loop_max_dis:
                    continue
            elif self.sessions_coregistered(cur_session, cand_session):
                if np.linalg.norm(p_new[:2] - self.keyframes[i].p[:2]) > prm.loop_max_dis:
                    continue
            cands.append((i, meta[i]["slot"]))
        return cands

    def _examine_candidates(self, cands, counts_all, bins_all, m1_slot, m1_index):
        """Winner examination half of laser_loop_detect: threshold, Kabsch,
        drift gates, overlap verification, in the candidates' order."""
        prm = self.params
        meta = self.mf_meta
        m1 = self._fetch_mf(m1_slot, m1_index)
        for ci, (i, slot_i) in enumerate(cands):
            counts = counts_all[ci]
            if int(counts.max()) <= prm.laser_loop_min_match_threshold:
                continue
            pi, pj = np.unravel_index(np.argmax(counts), counts.shape)
            m2 = self._fetch_mf(slot_i, meta[i]["index"])
            p1, p2 = loop_mod.extract_correspondences(
                m1, m2, int(pi), int(pj), int(bins_all[ci][pi, pj]), a_res=prm.a_res, n_angle_bins=prm.n_angle_bins
            )
            # Kabsch in the wheel-local frames (keyframe_manager.cpp:670-686)
            i1, i2 = m1.index, m2.index
            tf1 = self.keyframes[i1].T_tracking
            tf2 = self.keyframes[i2].T_tracking
            inv1 = np.linalg.inv(tf1 @ self.T_iw)
            inv2 = np.linalg.inv(tf2 @ self.T_iw)
            P1A = (inv1[:3, :3] @ p1.T).T + inv1[:3, 3]
            P2B = (inv2[:3, :3] @ p2.T).T + inv2[:3, 3]
            P1A[:, 2] = 0
            P2B[:, 2] = 0
            w_T12 = loop_mod.kabsch_2d(P1A, P2B)
            i_t12 = self.T_iw @ w_T12 @ np.linalg.inv(self.T_iw)
            # drift gate.  Same session: tracking-frame delta as the
            # reference (keyframe_manager.cpp:694-699); co-registered other
            # session: corrected-pose delta; not yet co-registered: skipped
            s1 = self.keyframes[i1].session
            s2 = self.keyframes[i2].session
            if s1 == s2:
                track_t12 = np.linalg.inv(tf1) @ tf2
            elif self.sessions_coregistered(s1, s2):
                Tc1 = geo.make_tf_np(self.keyframes[i1].p, self.keyframes[i1].q)
                Tc2 = geo.make_tf_np(self.keyframes[i2].p, self.keyframes[i2].q)
                track_t12 = np.linalg.inv(Tc1) @ Tc2
            else:
                track_t12 = None
            if track_t12 is not None:
                dp, dq = geo.log_SE3_np(np.linalg.inv(i_t12) @ track_t12)
                if float(np.linalg.norm(dp)) > prm.loop_max_tf_p or float(np.linalg.norm(dq)) > prm.loop_max_tf_q:
                    self.loop_rejections.append(("drift", i1, i2))
                    continue
            if not self._verify_loop(i1, i2, i_t12):
                self.loop_rejections.append(("verify", i1, i2))
                continue
            self._union_sessions(s1, s2)
            return (i1, i2, i_t12)
        return None

    def _verify_loop(self, i1, i2, i_t12):
        """Scan-overlap verification behind verify_loop_rate (<= 0 keeps the
        reference's always-true stub, keyframe_manager.cpp:52-54)."""
        prm = self.params
        if prm.verify_loop_rate <= 0:
            return True
        kf1, kf2 = self.keyframes[i1], self.keyframes[i2]
        # no stored scan: unverifiable, so the reference's always-true
        if (
            kf1.scan_lines is None
            or kf2.scan_lines is None
            or len(kf1.scan_lines[0]) == 0
            or len(kf2.scan_lines[0]) == 0
        ):
            return True
        Til = prm.mat_T_imu_to_laser()
        l_t12 = np.linalg.inv(Til) @ i_t12 @ Til  # laser1 <- laser2
        step = 2.0 * prm.laser_resolution
        pts1 = loop_mod.densify_lines(*kf1.scan_lines, step=step)
        pts2 = loop_mod.densify_lines(*kf2.scan_lines, step=step)
        return loop_mod.verify_loop_overlap(pts1, pts2, l_t12, resolution=step, rate=prm.verify_loop_rate)

    # ------------------------------------------------------------------

    def _build_graph(self):
        """The padded pose graph on the device; capacities are powers of two
        (at least 64 poses and 128 edges), as the reference pads them."""
        prm = self.params
        K = len(self.keyframes)
        E = len(self.seq_edges) + len(self.loop_edges)
        Kc = max(64, 1 << (K - 1).bit_length())
        Ec = max(128, 1 << (E - 1).bit_length())
        p = np.zeros((Kc, 3), np.float32)
        q = np.zeros((Kc, 3), np.float32)
        for i, kf in enumerate(self.keyframes):
            p[i] = kf.p
            q[i] = kf.q
        ei = np.zeros(Ec, np.int64)
        ej = np.zeros(Ec, np.int64)
        etf = np.tile(np.eye(4, dtype=np.float32), (Ec, 1, 1))
        ew = np.zeros(Ec, np.float32)
        for n, (i, j, tf) in enumerate(self.seq_edges):
            ei[n], ej[n], etf[n], ew[n] = i, j, tf, 1.0
        off = len(self.seq_edges)
        for n, (i, j, tf) in enumerate(self.loop_edges):
            ei[off + n], ej[off + n], etf[off + n], ew[off + n] = i, j, tf, prm.loop_edge_k
        return pg.graph_from_numpy(p, q, K, ei, ej, etf, ew, E, self.device)

    def solve(self):
        """Pose-graph solve (keyframe_manager.cpp:722-838): dense LM for a
        padded graph of at most 64 nodes (its Jacobian spans the whole
        6K-dim state), block-Jacobi PCG above.  Appends the solve's solver,
        K, E, Gauss-Newton iterations, host syncs and seconds to
        ``perf["solves"]``."""
        g = self._build_graph()
        K, E = g.p.shape[0], g.e_i.shape[0]
        t0 = time.perf_counter()
        stats = dict(K=K, E=E)
        if K <= 64:
            g_out, cost, iters = pg.solve_dense(g, self.pg_consts, max_iters=30)
            # lm_solve reads its exit test once an iteration
            stats.update(solver="dense", gn_iters=iters, syncs=iters)
        else:
            g_out, cost = pg.solve_pcg(g, self.pg_consts, gn_iters=20, cg_iters=60, stats=stats)
            stats.update(solver="pcg")
        pq = torch.stack([g_out.p, g_out.q]).cpu().numpy()
        dt = time.perf_counter() - t0
        stats.update(syncs=stats["syncs"] + 1, s=dt)  # + the poses' copy to the host
        self.perf["device_s_acc"] += dt
        self.perf["solve_s"].append(dt)
        self.perf["solves"].append(stats)
        for i, kf in enumerate(self.keyframes):
            kf.p = pq[0, i].astype(np.float64)
            kf.q = pq[1, i].astype(np.float64)
        return float(cost)

    # ------------------------------------------------------------------

    def trajectory(self):
        """back_end.txt equivalent: corrected keyframe poses (IMU frame)."""
        if not self.keyframes:
            return np.zeros(0, np.int64), np.zeros((0, 4, 4))
        ts = np.asarray([kf.t_us for kf in self.keyframes])
        Ts = np.stack([geo.make_tf_np(kf.p, kf.q) for kf in self.keyframes])
        return ts, Ts

    def corrected_live_pose(self, T_tracking, session=0):
        """update_other_frame's live output (keyframe_manager.cpp:407-417)."""
        return self.modify_delta_tf(session) @ np.asarray(T_tracking)
