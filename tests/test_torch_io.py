"""The CLI on recorded sequences: ``python -m liwslam_torch.run --sequence``
with ``--debug-viz`` on the CPU.

A short simulated drive is written as an indexed, lz4-compressed ROS1 bag
by the port's own writer (``io/openloris.save_bag``), with its ground
truth as a TUM file on the bag's absolute time base, and run through the
CLI at small capacities (the flow of tests/test_rosbag_real.py:130-176):
the report's front-end ATE < 0.1 m, and the trajectories, the map and the
three renderings (.png, or .ppm without PIL) written.  The bag's camera
topic is read into the streams.  The readers and renderers themselves are
held to the reference's in tests/test_torch_isolation.py."""

import numpy as np
import pytest

from liwslam_torch import config, run
from liwslam_torch.io import openloris, tum
from liwslam_torch.sim import world as sim

SMALL = dict(
    max_points=384, max_lines=48, max_corners=16, ref_capacity=384, max_imu_per_frame=32,
    max_wheel_per_frame=8, solver_max_iterations=5, init_solver_max_iterations=6,
)


def test_cli_runs_a_bag_with_debug_renderings(tmp_path):
    prm = config.office().replace(**SMALL)
    track = sim.TwistTrack([(1.0, 0.0, 0.0, 0.0), (4.0, 0.3, 0.0, 0.25)])
    streams = sim.simulate(
        track, sim.square_room(size=8.0, obstacles=True, rich=True), prm, imu_hz=100, wheel_hz=20,
        laser_hz=5, n_beams=360, camera_hz=2.0, camera_wh=(40, 30), noise=True, seed=5,
    )
    bag = str(tmp_path / "seq.bag")
    openloris.save_bag(bag, streams, compression="lz4", indexed=True, chunk_threshold=65536)
    gt = str(tmp_path / "gt.txt")
    tum.write_tum(gt, streams.gt_t_us + int(1560000000.0 * 1e6), streams.gt_T_w_wheel)
    loaded = openloris.load_bag(bag, camera_topic="/d400/color/image_raw")
    assert len(loaded.cam_t_us) == len(streams.cam_t_us) > 0 and loaded.cam_images.shape[1:] == (30, 40)
    out = tmp_path / "out"
    argv = ["--sequence", bag, "--gt", gt, "--debug-viz", "--device", "cpu", "--chunk", "8", "--out", str(out)]
    for k, v in SMALL.items():
        argv += ["--param", f"{k}={v}"]
    report = run.main(argv)
    assert report["frames"] > 15 and report["ate_frontend_m"] < 0.1, report
    assert report["debug_viz"] and "loops" in report
    for name in ("fornt_end.txt", "back_end.txt", "map.pgm"):
        assert (out / name).is_file(), name
    for name in ("merged_scans_frontend", "merged_scans_backend", "trajectory"):
        assert any((out / (name + ext)).is_file() for ext in (".png", ".ppm")), name
    t_s, _ = tum.read_tum(str(out / "fornt_end.txt"))
    assert len(t_s) == report["frames"] and np.all(np.diff(t_s) > 0)


def _merge_cases():
    """tests/test_io.py's cases: three jittered streams (watermark 40), a
    stream with a non-monotonic stamp (watermark 2) and one that runs dry
    without drain (watermark 5); and the merge pack_frames asks for."""
    from tests.test_io import rand_streams

    a = np.asarray([0.0, 1.0, 0.5, 2.0, 3.0] + list(np.arange(4.0, 50.0)))
    return [
        (rand_streams(np.random.default_rng(0)), 40, True),
        ([a, np.arange(0.05, 50.0, 0.5)], 2, True),
        ([np.arange(0.0, 10.0), np.arange(0.5, 100.5)], 5, False),
        (rand_streams(np.random.default_rng(1), rates=(200.0, 20.0, 10.0, 30.0)), 1, True),
    ]


def test_native_merge_matches_python_and_the_reference(tmp_path, monkeypatch):
    """The port's native merge (its own copy of dispatch.cpp, built at
    first use) against its Python oracle and the reference's merge, on
    tests/test_io.py's cases: equal orders.  The build is keyed by the
    source, and a failed build raises."""
    from liwslam.io import dispatch as jdp
    from liwslam_torch.io import dispatch as dp

    for times, wm, drain in _merge_cases():
        s, i = dp.merge(times, watermark=wm, drain=drain)
        for so, io_ in (dp.merge_numpy(times, [True] * len(times), wm, drain), jdp.merge(times, watermark=wm, drain=drain)):
            np.testing.assert_array_equal(s, so)
            np.testing.assert_array_equal(i, io_)
        t = np.asarray([times[a][b] for a, b in zip(s, i)])
        assert (np.diff(t) > 0).all()
    assert dp._lib_path().startswith(dp.BUILD_DIR)
    bad = tmp_path / "dispatch.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(dp, "SOURCE", str(bad))
    monkeypatch.setattr(dp, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(dp, "_lib", None)
    with pytest.raises(RuntimeError, match="native dispatcher"):
        dp.merge([np.arange(3.0)])
