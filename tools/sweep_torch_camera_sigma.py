"""ATE of the port's camera path against the camera's pixel sigma, on the GPU.

    python3 tools/sweep_torch_camera_sigma.py [--wh 160x120] [--sigmas 1.5,3,6,10,20]

Runs ``liwslam_torch.frontend.driver.Frontend`` on bench.py's loop track
(chip_smoke.py's ``bench_params`` and ``cam_params``, 30 Hz camera) once
laser-only and once per ``camera_sigma`` at the given image size, and
prints one line per arm with the ATE over every laser frame of the result
(init window included), as ``tools/diag_camera_ate.py`` measures the JAX
package on the same track.  The camera's focal length grows with the image
width (``sim.synthetic_camera_K``, 70 degree field of view), so one sigma
in pixels is a different angular noise at each size.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wh", default="160x120", help="image width x height")
    ap.add_argument("--sigmas", default="1.5,3,6,10,20", help="camera_sigma values in pixels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_torch_camera_sigma: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from liwslam_torch.eval import metrics
    from liwslam_torch.frontend.driver import Frontend
    from liwslam_torch.ops import _build
    from liwslam_torch.sim import world as sim

    _build.load()
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    wh = tuple(int(v) for v in args.wh.split("x"))
    prm = chip_smoke.bench_params()
    cprm = chip_smoke.cam_params(prm).replace(camera_K=sim.synthetic_camera_K(*wh))
    chip_smoke.CAM_WH = wh
    streams = chip_smoke.bench_streams(cprm, camera=True)
    print(f"{smi}; {wh[0]}x{wh[1]}, fx={cprm.camera_K[0]:.1f} px", flush=True)

    def arm(p, label):
        t0 = time.perf_counter()
        res = Frontend(p, device=dev).run(streams, chunk_size=64)
        pairs = metrics.associate_by_time(res.t_us, streams.gt_t_us)
        ate = metrics.ate_rmse(res.T_w_imu()[pairs[:, 0]], streams.gt_T_w_imu[pairs[:, 1]], align=True)
        n_cam = len(res.cam_t_us) if p.enable_camera else 0
        print(
            f"{label}: frames={len(res.t_us)} camera_frames={n_cam} ATE={ate * 1e3:.2f} mm "
            f"wall={time.perf_counter() - t0:.1f}s",
            flush=True,
        )

    arm(prm, "laser-only")
    for s in (float(v) for v in args.sigmas.split(",")):
        arm(cprm.replace(camera_sigma=(s, s)), f"camera sigma={s:g} px ({s / cprm.camera_K[0]:.2e} rad)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
