"""End-to-end SLAM runner CLI: front end + back end + evaluation.

Usage:
    python -m liwslam_torch.run --preset office --synthetic loop [--no-backend] [--device cpu]
    python -m liwslam_torch.run --preset office --sequence /path/to/seq[.npz|.bag] [--gt gt.txt] [--debug-viz]

Port of ``liwslam/run.py`` (the reference's ROS node on a dataset,
``launch/lvio_2d_office.launch``): runs odometry, feeds keyframes to the
keyframe manager, writes TUM trajectories (``fornt_end.txt`` /
``back_end.txt``, the reference's spelling kept), an occupancy map
(``map.pgm``) and per-stage timings (``pipeline.md``), and prints a JSON
report with the ATE when ground truth is available.  Runs on the card
unless ``--device cpu`` is given.

``--sequence`` reads an OpenLORIS directory, an ``.npz`` or a ROS1 bag
(``io/openloris``, ``io/rosbag``); ``--debug-viz`` writes the merged
keyframe scans before and after loop correction and the trajectory with
its loop edges (``eval/debug_viz``; PNG, or PPM without PIL).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

def _parse_params(preset, kvs):
    from liwslam_torch import config

    prm = config.PRESETS[preset]()
    overrides = {}
    for kv in kvs:
        k, v = kv.split("=", 1)
        cur = getattr(prm, k)  # raises on an unknown key
        if isinstance(cur, bool):
            v = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            v = int(v)
        elif isinstance(cur, float):
            v = float(v)
        overrides[k] = v
    return prm.replace(**overrides) if overrides else prm


def _occupancy_map(mgr, prm, path):
    """Occupancy grid from the loop-corrected keyframe scans (the
    reference's visualization::update_occupancy_grid); returns the number
    of known cells, or None when no keyframe has a scan."""
    from liwslam_torch.backend.loop import densify_lines
    from liwslam_torch.core import geometry as geo
    from liwslam_torch.eval import occupancy

    Til = prm.mat_T_imu_to_laser()
    scans_xy, origins = [], []
    for kf in mgr.keyframes:
        l1, l2 = kf.scan_lines
        if len(l1) == 0:
            continue
        T_wl = geo.make_tf_np(kf.p, kf.q) @ Til
        # hits sampled every cell along each stored line (the reference
        # raycasts every submap point, visualization.cpp:50-75)
        pts = densify_lines(l1, l2, prm.laser_resolution)
        scans_xy.append(((T_wl[:3, :3] @ pts.T).T + T_wl[:3, 3])[:, :2])
        origins.append(T_wl[:2, 3])
    if not scans_xy:
        return None
    grid, _ = occupancy.build_occupancy(scans_xy, np.asarray(origins), resolution=prm.laser_resolution)
    occupancy.write_pgm(path, grid)
    return int((grid >= 0).sum())


def _debug_viz(mgr, res, est, prm, out):
    """Merged keyframe scans with the front end's and the back end's poses
    and the trajectories with the loop edges, written on the async writer's
    thread (the reference's visualization thread); returns the writer's
    errors."""
    from liwslam_torch.core import geometry as geo
    from liwslam_torch.eval import debug_viz as dv
    from liwslam_torch.utils.asyncwriter import AsyncWriter

    Til = prm.mat_T_imu_to_laser()
    # float32 poses, as the reference's renderings build them
    T_wl = lambda p, q: geo.make_tf_np(np.float32(p), np.float32(q)) @ Til
    kf_idx = np.flatnonzero(res.is_keyframe)
    merged_front, merged_back = [], []
    for ki, kf in enumerate(mgr.keyframes):
        l1, l2 = kf.scan_lines
        if len(l1) == 0:
            continue
        if ki < len(kf_idx):
            merged_front.append(dv.transform_lines(l1, l2, T_wl(res.p[kf_idx[ki]], res.q[kf_idx[ki]])))
        merged_back.append(dv.transform_lines(l1, l2, T_wl(kf.p, kf.q)))
    writer = AsyncWriter()
    writer.submit(dv.render_merged_scans, os.path.join(out, "merged_scans_frontend.png"), merged_front)
    writer.submit(dv.render_merged_scans, os.path.join(out, "merged_scans_backend.png"), merged_back)
    _, Ts = mgr.trajectory()
    loop_pairs = [(mgr.keyframes[i].p[:2], mgr.keyframes[j].p[:2]) for i, j, _ in mgr.loop_edges]
    writer.submit(
        dv.render_trajectories, os.path.join(out, "trajectory.png"),
        [(est[:, :2, 3], dv.C_TRAJ_A), (Ts[:, :2, 3], dv.C_TRAJ_B)], loop_pairs,
    )
    return writer.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description="liwslam_torch: front end + back end + evaluation on one stream")
    ap.add_argument("--preset", default="office", choices=["base", "office", "corridor", "cafe", "market"])
    ap.add_argument("--synthetic", default=None, choices=[None, "loop", "smallloop", "L"])
    ap.add_argument("--sequence", default=None, help="OpenLORIS dir, .npz, or ROS1 .bag")
    ap.add_argument("--gt", default=None, help="TUM ground-truth file (for .bag input)")
    ap.add_argument(
        "--camera-topic", default=None,
        help="bag camera topic (e.g. /d400/color/image_raw); loaded into the streams, solved when enable_camera is set",
    )
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "liwslam_out"))
    ap.add_argument("--no-backend", action="store_true")
    ap.add_argument(
        "--online",
        action="store_true",
        help="concurrent back-end worker (liwslam_torch.online) and during-run artifacts: live_trajectory.txt "
        "every chunk and, with the back end, live_map.pgm periodically, refreshed in --out",
    )
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--laser-hz", type=float, default=10.0)
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--noise", action="store_true")
    ap.add_argument(
        "--param", action="append", default=[], metavar="KEY=VALUE",
        help="override any Params field (repeatable), e.g. --param loop_max_dis=2.5",
    )
    ap.add_argument(
        "--debug-viz", action="store_true",
        help="write debug renderings (merged keyframe scans before and after loop correction, trajectory and "
        "loop-edge map) into --out",
    )
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if not (args.synthetic or args.sequence):
        ap.error("need --synthetic or --sequence")

    from liwslam_torch import resolve_device
    from liwslam_torch.backend.manager import KeyframeManager
    from liwslam_torch.eval import metrics
    from liwslam_torch.frontend.driver import Frontend
    from liwslam_torch.io import openloris, tum
    from liwslam_torch.sim import world as sim
    from liwslam_torch.utils.record import Record

    device = resolve_device(args.device)
    prm = _parse_params(args.preset, args.param)
    rec = Record("pipeline")
    if args.synthetic:
        streams = sim.simulate(
            sim.default_track(args.synthetic),
            sim.square_room(size=12.0, obstacles=True, rich=True),
            prm,
            imu_hz=200,
            wheel_hz=20,
            laser_hz=args.laser_hz,
            n_beams=args.beams,
            noise=args.noise,
            seed=1,
        )
    elif args.sequence.endswith(".bag"):
        streams = openloris.load_bag(
            args.sequence, T_imu_to_wheel=prm.mat_T_imu_to_wheel(), gt_path=args.gt, camera_topic=args.camera_topic
        )
    else:
        streams = openloris.load_sequence(args.sequence, T_imu_to_wheel=prm.mat_T_imu_to_wheel())

    os.makedirs(args.out, exist_ok=True)
    mgr = None
    if args.online:
        from liwslam_torch.online import OnlineRunner

        runner = OnlineRunner(prm, live_dir=args.out, device=device, backend=not args.no_backend)
        rec.begin_record()
        ores = runner.run(streams, chunk_size=args.chunk)
        rec.end_record("frontend total (online)")
        res, mgr = ores.frontend, ores.manager
    else:
        rec.begin_record()
        res = Frontend(prm, device=device).run(streams, chunk_size=args.chunk)
        rec.end_record("frontend total")
    F = len(res.p)
    print(f"frontend: {F} frames, {int(res.is_keyframe.sum())} keyframes", file=sys.stderr)

    est = res.T_w_imu()
    Tiw = prm.mat_T_imu_to_wheel()
    tum.write_tum(os.path.join(args.out, "fornt_end.txt"), res.t_us, est @ Tiw)
    report = {"frames": F, "keyframes": int(res.is_keyframe.sum())}
    if len(streams.gt_t_us):
        pairs = metrics.associate_by_time(res.t_us, streams.gt_t_us)
        if len(pairs):
            report["ate_frontend_m"] = metrics.ate_rmse(est[pairs[:, 0]], streams.gt_T_w_imu[pairs[:, 1]])
        else:
            print(
                "gt provided but no timestamp associations found (check that the gt file uses the bag's "
                "absolute time base)",
                file=sys.stderr,
            )

    if not args.no_backend:
        if mgr is None:
            mgr = KeyframeManager(prm, device=device)
            rec.begin_record()
            for ki, fi in enumerate(np.flatnonzero(res.is_keyframe)):
                mgr.add_keyframe(
                    t_us=int(res.t_us[fi]), p=res.p[fi], q=res.q[fi], corners=res.kf_corners[ki],
                    scan_lines=res.kf_scans[ki],
                )
            rec.end_record("backend total")
        ts, Ts = mgr.trajectory()
        if len(ts):
            tum.write_tum(os.path.join(args.out, "back_end.txt"), ts, Ts @ Tiw)
        report["loops"] = len(mgr.loops_found)
        if len(streams.gt_t_us) and len(ts):
            pairs = metrics.associate_by_time(ts, streams.gt_t_us)
            if len(pairs):
                report["ate_backend_m"] = metrics.ate_rmse(Ts[pairs[:, 0]], streams.gt_T_w_imu[pairs[:, 1]])
        cells = _occupancy_map(mgr, prm, os.path.join(args.out, "map.pgm"))
        if cells is not None:
            report["map_cells"] = cells
        if args.debug_viz:
            errs = _debug_viz(mgr, res, est, prm, args.out)
            if errs:
                print("\n".join(errs), file=sys.stderr)
            report["debug_viz"] = True

    rec.dump(args.out)
    print(json.dumps(report))
    return report



if __name__ == "__main__":
    main()
