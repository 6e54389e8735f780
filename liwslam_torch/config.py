"""Typed configuration for liwslam_torch.

The port's own copy of ``liwslam/config.py`` (the port imports nothing of
``liwslam``; importing ``liwslam.config`` would import JAX).  Field names,
defaults and presets are identical, so a ``dataclasses.asdict`` of one
package's ``Params`` builds the other's (``liwslam_torch.convert``).

Reproduces the capability surface of the reference parameter system
(``src/utilies/params.{h,cpp}``) as a frozen dataclass + YAML loader.
Per-sequence presets mirror ``config/{params,office,corridor,cafe}.yaml``.

Implementation switches in the port: ``solver_method`` and
``extract_impl`` are resolved by the device of the tensors (hand-written
CUDA kernel on the card, plain PyTorch on the CPU); ``fast_prefix``,
``cam_lk_impl`` and ``cam_solver`` are kept only so the field set matches
the reference package.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np

# ---------------------------------------------------------------------------
# helpers


def _mat4(vals) -> np.ndarray:
    a = np.asarray(vals, dtype=np.float64).reshape(4, 4)
    return a


_IDENTITY4 = tuple(float(x) for x in np.eye(4).reshape(-1))


@dataclass(frozen=True)
class Params:
    """All tunables of the pipeline.

    Field names follow the reference YAML keys (``config/params.yaml``) so a
    reference user can bring their configs over unchanged; structural
    fields are grouped at the bottom.
    """

    # --- sensor enables (config/params.yaml:6-9) ---
    enable_laser: bool = True
    enable_camera: bool = False

    # --- extrinsics: 4x4 row-major (config/params.yaml:13-34) ---
    T_imu_to_wheel: tuple = _IDENTITY4
    T_imu_to_camera: tuple = _IDENTITY4
    T_imu_to_laser: tuple = _IDENTITY4
    camera_K: tuple = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)

    # --- rates / gravity ---
    FPS: float = 40.0
    g: float = 9.8

    # --- noise sigmas (per second / per meter) ---
    imu_noise_acc_sigma: tuple = (0.0163, 0.0163, 0.0163)
    imu_bias_acc_sigma: tuple = (0.00499, 0.00499, 0.00499)
    imu_noise_gyro_sigma: tuple = (0.003208, 0.003208, 0.003208)
    imu_bias_gyro_sigma: tuple = (0.000499, 0.000499, 0.000499)
    wheel_sigma: tuple = (0.1, 99999.0, 999.99)  # len / dir / yaw, per meter
    camera_sigma: tuple = (20.0, 20.0)
    max_camera_reproject_error: float = 20.0
    max_camera_feature_dis: float = 50.0
    manifold_p_sigma: float = 0.01  # m      (ground-plane z)
    manifold_q_sigma: float = 0.001  # rad   (roll/pitch)

    # --- camera tracking ---
    max_feature_num: int = 5
    feature_min_dis: float = 50.0

    # --- initialization ---
    slide_window_size: int = 10
    p_motion_threshold: float = 0.1
    q_motion_threshold: float = 0.05

    # --- laser feature extraction ---
    w_laser_each_scan: float = 100.0
    h_laser_each_scan: float = 100.0
    laser_resolution: float = 0.05
    line_continuous_threshold: float = 0.1
    line_min_len: float = 0.05
    line_max_dis: float = 0.03
    line_max_tolerance_angle: float = 175.0  # degrees
    line_to_line_sigma: float = 0.001

    # --- keyframe gating ---
    key_frame_p_motion_threshold: float = 0.1
    key_frame_q_motion_threshold: float = 0.1

    # --- loop closure ---
    a_res: float = 0.05
    d_res: float = 0.05
    submap_count: int = 10
    laser_loop_min_match_threshold: int = 8
    loop_detect_min_interval: int = 100
    verify_loop_rate: float = 0.5
    loop_max_dis: float = 999.0
    loop_edge_k: float = 10.0
    loop_max_tf_p: float = 999.0
    loop_max_tf_q: float = 999.0
    loop_sigma_p: tuple = (0.01, 0.01, 0.01)
    loop_sigma_q: tuple = (0.001, 0.001, 0.001)

    # --- backend ---
    use_ground_p_factor: bool = True
    use_ground_q_factor: bool = False
    pose_graph_solve_interval_s: float = 10.0  # keyframe_manager.cpp:843

    # --- front-end reference submap ---
    ref_motion_filter_p: float = 0.01
    ref_motion_filter_q: float = 0.01
    ref_n_accumulation: int = 2
    fast_mode: bool = True

    # --- output ---
    output_tum: bool = False
    output_dir: str = "/tmp/liwslam"

    # ------------------------------------------------------------------
    # Structural capacities (no reference counterpart: the reference uses
    # dynamic std::vector/deque; the port keeps fixed-shape tensors).
    # ------------------------------------------------------------------
    max_points: int = 2048  # laser beams per scan (padded)
    max_lines: int = 64  # extracted lines per scan
    max_corners: int = 32  # corners per scan
    max_matches: int = 64  # line matches used by the solver
    ref_capacity: int = 1024  # line capacity of a reference submap
    max_imu_per_frame: int = 64  # IMU samples between consecutive frames
    max_wheel_per_frame: int = 64
    map_corner_capacity: int = 128  # corners per loop descriptor map
    # camera path capacities/knobs (enable_camera)
    cam_feature_capacity: int = 64  # landmark/track slots F
    cam_obs_window: int = 10  # observation ring length Wc
    cam_min_obs: int = 5  # obs needed before triangulation (camera_manager.cpp:179)
    cam_min_parallax: float = 0.02  # normalized-plane parallax gate
    cam_lk_radius: int = 7
    cam_lk_levels: int = 3
    cam_lk_iters: int = 6
    cam_lk_max_err: float = 0.1  # LK verify gate (fraction of dynamic range)
    cam_lk_impl: str = "auto"  # field parity with the reference package
    cam_solver: str = "auto"  # field parity with the reference package
    keyframe_capacity: int = 4096  # pose-graph node capacity
    edge_capacity: int = 8192  # pose-graph edge capacity
    loop_probe_count: int = 5  # match_map probes (keyframe_manager.cpp:1139)
    solver_max_iterations: int = 10  # LM iterations (fast_mode cap, solver.cpp:801)
    init_solver_max_iterations: int = 50
    # field parity with the reference package: the port's tracking solve is
    # always ops/track_solve (kernel for CUDA tensors, plain version for CPU
    # tensors) and its init solve is gn.lm_solve(method="qr")
    solver_method: str = "auto"
    # tracking LM loop: stop at convergence instead of running frozen
    # iterations to solver_max_iterations (identical result)
    solver_early_exit: bool = True
    fast_prefix: str = "auto"  # field parity with the reference package
    # field parity with the reference package: extraction is the B2 kernel
    # for CUDA tensors and its plain version for CPU tensors
    extract_impl: str = "auto"
    dtype: str = "float32"  # device dtype for the solve path

    # ------------------------------------------------------------------

    def __post_init__(self):
        # Mirror param::manager::check_param (params.cpp-style validation)
        assert self.FPS > 0
        assert self.slide_window_size >= 2
        if not self.enable_laser:
            # The reference gates the laser at ingest (lvio_2d_node.cpp:33
            # and the dispatch watermark, dispatch.h:202-212), implying a
            # camera+IMU+wheel-only arrangement; liwslam's frontend is
            # structurally laser-frame-driven (frames are created per laser
            # scan, frontend/driver.py), so that mode is unsupported —
            # reject loudly instead of silently ignoring the knob.
            raise ValueError(
                "enable_laser=false (laser-off camera+IMU+wheel mode) is "
                "not supported by liwslam: the frontend is laser-frame-"
                "driven. Run with enable_laser=true (optionally with "
                "enable_camera=true for laser+camera fusion)."
            )

    # Derived values ----------------------------------------------------

    @property
    def min_delta_t(self) -> float:
        return 1.0 / self.FPS

    @property
    def line_max_tolerance_angle_rad(self) -> float:
        return math.radians(self.line_max_tolerance_angle)

    @property
    def grid_w(self) -> int:
        return int(self.w_laser_each_scan / self.laser_resolution) + 1

    @property
    def grid_h(self) -> int:
        return int(self.h_laser_each_scan / self.laser_resolution) + 1

    @property
    def n_dist_bins(self) -> int:
        # des_i quick_des sizing: (100m / d_res + 1) bits (keyframe_manager.cpp:21-24)
        return int(100.0 / self.d_res + 1)

    @property
    def n_angle_bins(self) -> int:
        # match_des rotation-vote histogram (keyframe_manager.cpp:1052)
        return int(2 * math.pi / self.a_res) + 2

    def mat_T_imu_to_wheel(self) -> np.ndarray:
        return _mat4(self.T_imu_to_wheel)

    def mat_T_imu_to_camera(self) -> np.ndarray:
        return _mat4(self.T_imu_to_camera)

    def mat_T_imu_to_laser(self) -> np.ndarray:
        return _mat4(self.T_imu_to_laser)

    def mat_camera_K(self) -> np.ndarray:
        return np.asarray(self.camera_K, dtype=np.float64).reshape(3, 3)

    def replace(self, **kw) -> "Params":
        return dataclasses.replace(self, **kw)

    # Loading ------------------------------------------------------------

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "Params":
        known = {f.name for f in dataclasses.fields(Params)}
        kw = {}
        for k, v in d.items():
            if k not in known:
                continue  # topics etc. are I/O concerns
            if isinstance(v, list):
                v = tuple(float(x) for x in v)
            kw[k] = v
        return Params(**kw)

    @staticmethod
    def from_yaml(path: str) -> "Params":
        """A Params from a YAML file keyed as ``config/params.yaml``
        (PyYAML needed; unknown keys are ignored, as in ``from_dict``)."""
        try:
            import yaml
        except ImportError as e:
            raise ImportError("liwslam_torch.config.Params.from_yaml needs PyYAML (import yaml failed)") from e
        with open(path) as f:
            return Params.from_dict(yaml.safe_load(f))


# ---------------------------------------------------------------------------
# Per-sequence presets mirroring the reference configs.  Extrinsics below are
# the OpenLORIS calibrations shipped with the reference (config/office.yaml).

_OPENLORIS_T_IMU_TO_WHEEL = (
    0.0040697, -0.9998940, -0.0139789, -0.061,
    0.0099712, 0.0140189, -0.9998520, 0.919,
    0.9999420, 0.0039297, 0.0100272, -0.224,
    0.0, 0.0, 0.0, 1.0,
)
_OPENLORIS_T_IMU_TO_LASER = (
    0.0019070, -0.9999900, 0.0040438, 0.024,
    0.0459794, -0.0039519, -0.9989346, -0.078,
    0.9989406, 0.0020909, 0.0459714, -0.071,
    0.0, 0.0, 0.0, 1.0,
)
_OPENLORIS_T_IMU_TO_CAMERA = (
    0.9999740, -0.0039879, -0.0060079, -0.020,
    0.0040119, 0.9999840, 0.0039879, 0.005,
    0.0059919, -0.0040119, 0.9999740, 0.011,
    0.0, 0.0, 0.0, 1.0,
)
_OPENLORIS_K = (611.45, 0.0, 433.203, 0.0, 611.485, 249.473, 0.0, 0.0, 1.0)

_OPENLORIS_COMMON = dict(
    T_imu_to_wheel=_OPENLORIS_T_IMU_TO_WHEEL,
    T_imu_to_laser=_OPENLORIS_T_IMU_TO_LASER,
    T_imu_to_camera=_OPENLORIS_T_IMU_TO_CAMERA,
    camera_K=_OPENLORIS_K,
    FPS=1000.0,
    key_frame_p_motion_threshold=0.05,
    key_frame_q_motion_threshold=0.05,
    a_res=0.03,
    d_res=0.03,
    loop_edge_k=10.0,
    loop_max_tf_p=1.0,
    loop_max_tf_q=0.5,
    loop_sigma_p=(0.1, 0.1, 0.1),
    loop_sigma_q=(0.01, 0.01, 0.01),
    use_ground_p_factor=True,
    use_ground_q_factor=True,
    fast_mode=False,
)


def office() -> Params:
    """OpenLORIS office sequences (config/office.yaml)."""
    return Params(
        **_OPENLORIS_COMMON,
        wheel_sigma=(0.5, 99999.0, 999.99),
        manifold_q_sigma=0.0005,
        laser_resolution=0.05,
        line_continuous_threshold=0.1,
        line_max_dis=0.03,
        line_to_line_sigma=0.001,
        submap_count=30,
        laser_loop_min_match_threshold=5,
        loop_detect_min_interval=100,
        loop_max_dis=1.0,
        ref_n_accumulation=2,
    )


def corridor() -> Params:
    """OpenLORIS corridor sequences (config/corridor.yaml)."""
    return Params(
        **_OPENLORIS_COMMON,
        wheel_sigma=(0.02, 99999.0, 999.99),
        manifold_q_sigma=0.0001,
        laser_resolution=0.1,
        line_continuous_threshold=0.5,
        line_max_dis=0.1,
        line_to_line_sigma=0.01,
        submap_count=10,
        laser_loop_min_match_threshold=7,
        loop_detect_min_interval=300,
        loop_max_dis=99999.0,
        ref_n_accumulation=100,
        ref_capacity=4096,
    )


def cafe() -> Params:
    """OpenLORIS cafe sequences (config/cafe.yaml)."""
    return Params(
        **_OPENLORIS_COMMON,
        wheel_sigma=(0.2, 99999.0, 999.99),
        manifold_q_sigma=0.001,
        laser_resolution=0.03,
        line_continuous_threshold=0.1,
        line_max_dis=0.03,
        line_to_line_sigma=0.001,
        submap_count=10,
        laser_loop_min_match_threshold=8,
        loop_detect_min_interval=100,
        loop_max_dis=1.0,
        ref_n_accumulation=2,
    )


def market() -> Params:
    """OpenLORIS market sequences.  The reference's launch file
    (``launch/lvio_2d_market.launch``) points at a ``config/market.yaml``
    that is MISSING from the reference repository — this preset is liwslam's
    own composition for that capability: cafe's dynamic-scene settings scaled
    to the much larger market hall (coarser grid, longer loop search radius,
    stronger dedup of the bigger corner population)."""
    return Params(
        **_OPENLORIS_COMMON,
        wheel_sigma=(0.2, 99999.0, 999.99),
        manifold_q_sigma=0.001,
        laser_resolution=0.05,
        line_continuous_threshold=0.2,
        line_max_dis=0.05,
        line_to_line_sigma=0.005,
        submap_count=10,
        laser_loop_min_match_threshold=8,
        loop_detect_min_interval=200,
        loop_max_dis=5.0,
        ref_n_accumulation=10,
        ref_capacity=2048,
        map_corner_capacity=256,
    )


def base() -> Params:
    """The reference base config (config/params.yaml)."""
    return Params()


PRESETS = {
    "base": base,
    "office": office,
    "corridor": corridor,
    "cafe": cafe,
    "market": market,
}


# Capacities over the office preset used to size runs.  Bench widths:
# bench.py's single-stream configuration (bench.py:96-105); tiny widths: the
# reference entry's (__graft_entry__.py:16-27), for the entry contract and
# the CPU tests.
BENCH_WIDTHS = dict(
    max_points=1152,
    max_lines=64,
    max_corners=16,
    ref_capacity=1024,
    max_imu_per_frame=32,
    max_wheel_per_frame=8,
    solver_max_iterations=8,
    init_solver_max_iterations=25,
)
TINY_WIDTHS = dict(
    max_points=256,
    max_lines=16,
    max_corners=8,
    ref_capacity=128,
    max_imu_per_frame=8,
    max_wheel_per_frame=4,
    solver_max_iterations=3,
)


def bench_params() -> Params:
    return office().replace(**BENCH_WIDTHS)


def tiny_params() -> Params:
    return office().replace(**TINY_WIDTHS)
