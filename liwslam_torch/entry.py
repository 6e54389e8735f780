"""The port's entry contract: one tracking frame, and the multi-device flow.

The counterpart of the reference's ``__graft_entry__.py``:

- :func:`entry` returns the front end's per-frame step (de-skew,
  preintegration, line extraction (B2), submap matching, the window's LM
  solve and Schur reduction (B1), the keyframe test, the submap update) at
  small widths with an example frame;
- :func:`dryrun_multichip` runs the composed multi-device flow once:
  batched front ends split over ``n_processes`` ranks run a real chunk,
  their gathered poses seed a K = 1024 / E = 4096 pose graph, and the
  ranks solve it edge-sharded (``parallel/dist_runner``'s ``composed``
  mode).  It raises unless the run's verdict is ok.

Both run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from liwslam_torch import config, resolve_device


def example_frame(prm):
    """The reference entry's example frame (__graft_entry__.py:30-53): a
    3 m circle of points, gravity only, the wheel at rest; numpy leaves."""
    from liwslam_torch.frontend import pipeline as pl

    ang = np.linspace(-np.pi, np.pi, prm.max_points, endpoint=False)
    pts = np.stack([3 * np.cos(ang), 3 * np.sin(ang), np.zeros_like(ang)], -1)
    return pl.FrameInput(
        dt_us=np.int32(100000),
        imu_acc=np.tile(np.asarray([[0, 0, 9.8]], np.float32), (prm.max_imu_per_frame, 1)),
        imu_gyro=np.zeros((prm.max_imu_per_frame, 3), np.float32),
        imu_t_us=(np.arange(prm.max_imu_per_frame) * 12000 + 1000).astype(np.int32),
        imu_mask=np.ones(prm.max_imu_per_frame, bool),
        wheel_pose=np.tile(np.eye(4, dtype=np.float32), (prm.max_wheel_per_frame, 1, 1)),
        wheel_t_us=(np.arange(prm.max_wheel_per_frame) * 30000 + 5000).astype(np.int32),
        wheel_mask=np.ones(prm.max_wheel_per_frame, bool),
        points=pts.astype(np.float32),
        point_valid=np.ones(prm.max_points, bool),
        ray_t=np.zeros(prm.max_points, np.float32),
    )


def entry(device="cuda"):
    """(fn, example_args): ``fn(state, inp) -> (state, out)``, one tracking
    frame at the reference entry's widths (``config.TINY_WIDTHS``), from
    the zero state."""
    from liwslam_torch.frontend import pipeline as pl
    from liwslam_torch.frontend.driver import to_device
    from liwslam_torch.solve import factors as fac

    dev = resolve_device(device)
    prm = config.tiny_params()
    consts = fac.make_consts(prm, dev)
    scfg = pl.make_static_cfg(prm)
    dcfg = pl.make_dyn_cfg(prm, dev)

    def fn(state, inp):
        return pl.tracking_step(state, inp, consts, dcfg, scfg)

    z = lambda n: torch.zeros(n, dtype=torch.float32, device=dev)
    state = pl.init_track_state(z(3), z(3), z(3), z(6), scfg)
    return fn, (state, to_device(example_frame(prm), dev))


def dryrun_multichip(n_processes: int, device="cuda", backend=None) -> dict:
    """The composed flow over ``n_processes`` ranks at the reference
    entry's widths with B = ``n_processes`` sequences and F = 8 frames, as the
    reference's ``dryrun_multichip(n)``: NCCL, a card a rank, on the card
    (gloo on the CPU, or when ``backend="gloo"``).  Returns the verdict;
    raises ``RuntimeError`` unless it is ok."""
    from liwslam_torch.parallel import dist_runner as dr

    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    v = dr.launch(dr.RunConfig(
        mode="composed", num_processes=n_processes, device=dev.type, backend=backend,
        widths="tiny", sequences=n_processes, frames=8,
    ))
    if not v["ok"]:
        raise RuntimeError(f"dryrun_multichip({n_processes}): the composed flow failed: {v}")
    return v
