"""The port's back end against the reference's on the bench track's keyframes.

    python3 tools/parity_backend.py --save chiprun_out/bench_frontend.npz   # on the GPU
    python3 tools/parity_backend.py --load chiprun_out/bench_frontend.npz   # on the CPU

``--save`` runs the port's front end (``Frontend(device="cuda").run``) on
chip_smoke.py's bench track (``bench_params`` / ``bench_streams``: the
office loop track, 1080 beams, seed 1, chunks of 64) and writes its
result to an ``.npz``: stamps, poses, keyframe flags, and each keyframe's
corners and scan lines.

``--load`` feeds those keyframes, after the run as ``run.py`` does, to the
reference's ``liwslam.backend.manager.KeyframeManager`` and to the port's
``KeyframeManager(device="cpu")``, both on the CPU, and prints for each:
the loop pairs, the rejections, the solves, the front-end and back-end
ATE against the track's ground truth (simulated anew, the same seed), and
the largest gap between the two back ends' keyframe poses (position,
rotation angle, yaw).  The same
input through both back ends: a gap in the back-end ATE between this
front end's result and another's belongs to the front ends.

Like the tests, this script runs the reference package (JAX, on the CPU)
beside the port; the port itself imports neither.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def save(path):
    import torch

    import chip_smoke as cs
    from liwslam_torch.frontend.driver import Frontend

    if not torch.cuda.is_available():
        print("--save runs the front end on the GPU; CUDA is not available", file=sys.stderr)
        return 1
    prm = cs.bench_params()
    res = Frontend(prm, device="cuda").run(cs.bench_streams(prm), chunk_size=64)
    corners = [np.asarray(c, np.float32).reshape(-1, 3) for c in res.kf_corners]
    l1 = [np.asarray(s[0], np.float32).reshape(-1, 3) for s in res.kf_scans]
    l2 = [np.asarray(s[1], np.float32).reshape(-1, 3) for s in res.kf_scans]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path, t_us=res.t_us, p=res.p, q=res.q, is_keyframe=res.is_keyframe,
        corners=np.concatenate(corners), corners_n=[len(c) for c in corners],
        l1=np.concatenate(l1), l2=np.concatenate(l2), lines_n=[len(a) for a in l1],
    )
    print(f"saved {len(res.t_us)} frames, {len(corners)} keyframes to {path}")
    return 0


def _split(a, n):
    return np.split(a, np.cumsum(n)[:-1])


def _feed(mgr, z):
    corners = _split(z["corners"], z["corners_n"])
    l1, l2 = _split(z["l1"], z["lines_n"]), _split(z["l2"], z["lines_n"])
    t0 = time.perf_counter()
    for ki, fi in enumerate(np.flatnonzero(z["is_keyframe"])):
        mgr.add_keyframe(
            t_us=int(z["t_us"][fi]), p=z["p"][fi], q=z["q"][fi], corners=corners[ki], scan_lines=(l1[ki], l2[ki])
        )
    return time.perf_counter() - t0


def load(path):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    import chip_smoke as cs
    from liwslam import config as jconfig
    from liwslam.backend.manager import KeyframeManager as JManager
    from liwslam_torch import config as tconfig
    from liwslam_torch import convert
    from liwslam_torch.backend.manager import KeyframeManager as TManager
    from liwslam_torch.core import geometry as geo
    from liwslam_torch.eval import metrics

    torch.set_num_threads(4)
    z = dict(np.load(path))
    jprm = jconfig.office().replace(**tconfig.BENCH_WIDTHS)
    tprm = convert.params_from_reference(dataclasses.asdict(jprm))
    assert tprm == cs.bench_params(), "the reference's bench parameters differ from the port's"
    streams = cs.bench_streams(tprm)
    est = geo.make_tf(torch.as_tensor(z["p"]), torch.as_tensor(z["q"])).numpy()
    pf = metrics.associate_by_time(z["t_us"], streams.gt_t_us)
    ate_front = metrics.ate_rmse(est[pf[:, 0]], streams.gt_T_w_imu[pf[:, 1]])
    out, traj = {}, {}
    for name, mgr in (("reference", JManager(jprm)), ("port", TManager(tprm, device="cpu"))):
        wall = _feed(mgr, z)
        ts, Ts = mgr.trajectory()
        pb = metrics.associate_by_time(ts, streams.gt_t_us)
        traj[name] = (np.asarray(ts), np.asarray(Ts))
        out[name] = dict(
            keyframes=len(mgr.keyframes),
            loops=[(int(a), int(b)) for a, b, _ in mgr.loops_found],
            rejections=[(r[0], int(r[1]), int(r[2])) for r in mgr.loop_rejections],
            solves=len(getattr(mgr, "perf", {}).get("solves", [])) or None,
            ate_front_m=float(ate_front),
            ate_back_m=float(metrics.ate_rmse(Ts[pb[:, 0]], streams.gt_T_w_imu[pb[:, 1]])),
            feed_s_cpu=round(wall, 1),
        )
        print(name, json.dumps(out[name]), flush=True)
    (ta, Ta), (tb, Tb) = traj["reference"], traj["port"]
    same = np.array_equal(ta, tb)
    gap = dict(
        same_loops=out["reference"]["loops"] == out["port"]["loops"],
        same_rejections=out["reference"]["rejections"] == out["port"]["rejections"],
        same_stamps=bool(same),
        max_dp_m=float(np.abs(Ta[:, :3, 3] - Tb[:, :3, 3]).max()) if same else None,
        max_dR_rad=float(2 * np.arcsin(min(1.0, np.linalg.norm(Ta[:, :3, :3] - Tb[:, :3, :3], axis=(1, 2)).max() / 8**0.5)))
        if same else None,
        max_dyaw_rad=float(np.abs(np.angle(np.exp(1j * (np.arctan2(Ta[:, 1, 0], Ta[:, 0, 0]) - np.arctan2(Tb[:, 1, 0], Tb[:, 0, 0]))))).max())
        if same else None,
        ate_back_gap_m=out["port"]["ate_back_m"] - out["reference"]["ate_back_m"],
    )
    print("gap", json.dumps(gap), flush=True)
    return 0


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--save", help="run the port's front end on the GPU and write its result here")
    g.add_argument("--load", help="feed a saved result to both packages' back ends on the CPU")
    args = ap.parse_args(argv)
    return save(args.save) if args.save else load(args.load)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
