"""The port stands alone: it imports neither JAX nor the reference package,
its entry points refuse to fall back to the CPU, its kernel build refuses
to fall back when the CUDA compiler is missing, and its own copies of the
reference's numpy-only modules (config presets, the simulator and its
moving obstacles, the metrics, TUM files, the occupancy grid, the stage
record, the async writer) give what the reference's give."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from liwslam import config as jconfig
from liwslam.eval import metrics as jmetrics
from liwslam.sim import world as jsim
from liwslam_torch import config as tconfig
from liwslam_torch.eval import metrics as tmetrics
from liwslam_torch.sim import world as tsim

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (
    sorted((ROOT / "liwslam_torch").rglob("*.py"))
    + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "tools").glob("*torch*.py"))
)


def _modules():
    return [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted((ROOT / "liwslam_torch").rglob("*.py"))
    ]


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'liwslam'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module",
            "__import__",
        ):
            roots |= {a.value.split(".")[0] for a in node.args if isinstance(a, ast.Constant)}
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_reference(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "liwslam"}


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    from liwslam_torch.frontend.driver import Frontend
    from liwslam_torch.ops import extract

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prm = tconfig.office()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Frontend(prm)
    assert Frontend(prm, device="cpu").device.type == "cpu"
    cam = prm.replace(enable_camera=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Frontend(cam)
    assert Frontend(cam, device="cpu").cdyn.K.device.type == "cpu"
    # the entry module and the composed multi-device flow
    from liwslam_torch import entry
    from liwslam_torch.parallel import dist_runner as dr

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dr.launch(dr.RunConfig(mode="composed", num_processes=1, widths="bench"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.dryrun_multichip(1)
    fn, args = entry.entry("cpu")
    _, out = fn(*args)
    assert out.p.device.type == "cpu" and torch.isfinite(out.p).all()
    # a wrapper takes its plain version only for CPU tensors; anything else
    # that is not a CUDA float32 tensor is refused, not computed
    pts = torch.zeros((8, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        extract.extract_lines(
            pts, torch.ones(8, dtype=torch.bool, device="meta"), continuous_threshold=0.1,
            min_len=0.1, max_dis=0.1, tolerance_angle_rad=0.1, max_lines=4,
        )


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from liwslam_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "CUDA_ROOTS", (str(tmp_path),))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load()
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("preset", ["base", "office", "corridor", "cafe", "market"])
def test_config_presets_match_reference(preset):
    j, t = getattr(jconfig, preset)(), getattr(tconfig, preset)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    np.testing.assert_array_equal(t.mat_T_imu_to_laser(), j.mat_T_imu_to_laser())
    np.testing.assert_array_equal(t.mat_T_imu_to_wheel(), j.mat_T_imu_to_wheel())


def test_simulator_and_metrics_match_reference():
    # camera images too (the camera path's input), at 160x120
    kw = dict(imu_hz=100, wheel_hz=20, laser_hz=5, n_beams=360, noise=True, seed=3, camera_hz=10.0, camera_wh=(160, 120))
    cam = dict(enable_camera=True, camera_K=tsim.synthetic_camera_K(160, 120))
    j = jsim.simulate(jsim.default_track("L"), jsim.square_room(obstacles=True), jconfig.office().replace(**cam), **kw)
    t = tsim.simulate(tsim.default_track("L"), tsim.square_room(obstacles=True), tconfig.office().replace(**cam), **kw)
    assert t.cam_images.shape == (len(t.cam_t_us), 120, 160) and t.cam_images.max() > 0.4
    fields = [f.name for f in dataclasses.fields(j)]
    assert fields == [f.name for f in dataclasses.fields(t)]
    for name in fields:
        a, b = getattr(j, name), getattr(t, name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=name)
    pairs = tmetrics.associate_by_time(t.laser_t_us, t.gt_t_us)
    np.testing.assert_array_equal(pairs, jmetrics.associate_by_time(j.laser_t_us, j.gt_t_us))
    est = t.gt_T_w_imu[pairs[:, 1]].copy()
    est[:, :2, 3] += np.random.default_rng(0).normal(0, 0.01, (len(est), 2))
    for align in (False, True):
        assert tmetrics.ate_rmse(est, t.gt_T_w_imu[pairs[:, 1]], align=align) == pytest.approx(
            jmetrics.ate_rmse(est, j.gt_T_w_imu[pairs[:, 1]], align=align), rel=1e-9
        )
    # the moving obstacles (segments at 20 instants) and the corridor
    kw = dict(center=(0.5, -2.0), size=(0.6, 0.4), velocity=(0.35, 0.35), period=4.0)
    jb, tb = jsim.MovingBox(**kw), tsim.MovingBox(**kw)
    for tt in np.linspace(0.0, 17.0, 20):
        np.testing.assert_array_equal(tb.segments_at(tt), jb.segments_at(tt))
    np.testing.assert_array_equal(tsim.corridor_world(), jsim.corridor_world())
    np.testing.assert_array_equal(tsim.corridor_world(20.0, 2.5), jsim.corridor_world(20.0, 2.5))


def test_build_is_keyed_by_source_hash(monkeypatch, tmp_path):
    from liwslam_torch.ops import _build

    src = tmp_path / "csrc"
    src.mkdir()
    monkeypatch.setattr(_build, "CSRC", str(src))
    (src / "k.cu").write_text("// one\n")
    first = _build._lib_path("k")
    assert first == _build._lib_path("k")
    (src / "k.cu").write_text("// two\n")
    assert _build._lib_path("k") != first
    # a header the source includes (directly or through another header)
    # keys the library too; an unrelated header does not
    (src / "k.cu").write_text('#include "a.cuh"\n')
    (src / "a.cuh").write_text('#include "b.cuh"\n')
    (src / "b.cuh").write_text("// one\n")
    (src / "other.cuh").write_text("// one\n")
    second = _build._lib_path("k")
    (src / "other.cuh").write_text("// two\n")
    assert _build._lib_path("k") == second
    (src / "b.cuh").write_text("// two\n")
    assert _build._lib_path("k") != second
    assert set(_build.SOURCES) == {p.stem for p in (ROOT / "liwslam_torch" / "csrc").glob("*.cu")}


def test_solve_wrapper_runs_the_plain_version_only_on_the_cpu():
    from liwslam_torch.ops import track_solve

    B, M = 1, 4
    shapes = dict(
        x0=(B, 30), free=(B, 30), imu_J=(B, 15, 15), imu_sqrtP=(B, 15, 15), imu_X=(B, 15),
        prior_J=(B, 15, 15), prior_X=(B, 15), T_il=(B, 4, 4), T_iw=(B, 4, 4), wheel=(B, 9),
        scal=(B, 6), laser=(B, M, 11),
    )
    inp = track_solve.TrackSolveInputs(**{k: torch.zeros(s, device="meta") for k, s in shapes.items()})
    with pytest.raises(ValueError, match="CUDA"):
        track_solve.lm_solve_track_batched(inp)


def test_back_end_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    from liwslam_torch import run
    from liwslam_torch.backend.manager import KeyframeManager
    from liwslam_torch.online import OnlineRunner
    from liwslam_torch.utils import checkpoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prm = tconfig.office()
    for make in (lambda **k: KeyframeManager(prm, **k), lambda **k: OnlineRunner(prm, **k)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        assert make(device="cpu").device.type == "cpu"
    checkpoint.save_manager(str(tmp_path / "m"), KeyframeManager(prm, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        checkpoint.load_manager(str(tmp_path / "m"), prm)
    assert checkpoint.load_manager(str(tmp_path / "m"), prm, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--synthetic", "L", "--out", str(tmp_path)])
    # the readers' path and the renderings (the device is resolved before
    # anything is read)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--sequence", str(tmp_path / "seq.bag"), "--debug-viz", "--out", str(tmp_path)])


def test_dist_runner_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    """``python -m liwslam_torch.parallel.dist_runner`` runs on the card by
    default and raises without CUDA before it spawns a rank."""
    from liwslam_torch.parallel import dist_runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dist_runner, "_worker", lambda *a: pytest.fail("a rank was spawned"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist_runner.main(["--mode", "solve", "--num-processes", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist_runner.launch(dist_runner.RunConfig(mode="pipeline", backend="gloo"))
    assert dist_runner.RunConfig().device == "cuda"


def test_dist_runner_refuses_more_nccl_ranks_than_devices(monkeypatch):
    """NCCL takes one CUDA device a rank: the runner's defaults (2 ranks,
    cuda, nccl) on a one-card machine, and NCCL on the CPU, raise a clear
    error before a rank is spawned."""
    from liwslam_torch.parallel import dist_runner

    monkeypatch.setattr(dist_runner, "_worker", lambda *a: pytest.fail("a rank was spawned"))
    with pytest.raises(ValueError, match="NCCL takes one CUDA device a rank: 2 ranks, 0 devices"):
        dist_runner.launch(dist_runner.RunConfig(mode="solve", device="cpu", backend="nccl"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks, 1 devices"):
        dist_runner.main([])


def test_batched_step_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    from liwslam_torch.frontend.driver import Frontend
    from liwslam_torch.ops import extract, track_solve
    from liwslam_torch.parallel import multiseq

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prm = tconfig.office()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Frontend(prm).init_sequences([])
    fe = Frontend(prm, device="cpu")
    run = multiseq.batched_chunk_fn(fe.consts, fe.dcfg, fe.scfg)
    assert callable(run) and fe.consts.T_imu_to_laser.device.type == "cpu"
    # under vmap, a tensor that is neither on the CPU nor a float32 CUDA
    # tensor is refused by both kernels' wrappers, not computed
    kw = dict(continuous_threshold=0.1, min_len=0.1, max_dis=0.1, tolerance_angle_rad=0.1, max_lines=4)
    pts = torch.zeros((2, 8, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        torch.func.vmap(lambda p, v: extract.extract_lines(p, v, **kw))(pts, torch.ones((2, 8), dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        extract.extract_lines_batched(pts, torch.ones((2, 8), dtype=torch.bool, device="meta"), **kw)
    shapes = dict(track_solve._SHAPES, laser=(4, 11))
    inp = track_solve.TrackSolveInputs(**{k: torch.zeros((2, 1) + s, device="meta") for k, s in shapes.items()})
    with pytest.raises(ValueError, match="CUDA"):
        torch.func.vmap(lambda *t: track_solve.lm_solve_track_batched(track_solve.TrackSolveInputs(*t)))(*inp)


def test_io_eval_and_util_copies_match_reference(tmp_path):
    from liwslam.eval import debug_viz as jdv
    from liwslam.eval import occupancy as jocc
    from liwslam.io import openloris as jol
    from liwslam.io import rosbag as jbag
    from liwslam.io import tum as jtum
    from liwslam.utils import asyncwriter as jaw
    from liwslam.utils import record as jrec
    from liwslam_torch.core import geometry as tgeo
    from liwslam_torch.eval import debug_viz as tdv
    from liwslam_torch.eval import occupancy as tocc
    from liwslam_torch.io import openloris as tol
    from liwslam_torch.io import rosbag as tbag
    from liwslam_torch.io import tum as ttum
    from liwslam_torch.utils import asyncwriter as taw
    from liwslam_torch.utils import record as trec

    rng = np.random.default_rng(0)
    scans = [rng.uniform(-4, 4, (50, 2)) for _ in range(3)]
    origins = rng.uniform(-1, 1, (3, 2))
    (gj, oj), (gt, ot) = jocc.build_occupancy(scans, origins, 0.1), tocc.build_occupancy(scans, origins, 0.1)
    np.testing.assert_array_equal(gt, gj)
    assert ot == oj
    jocc.write_pgm(tmp_path / "j.pgm", gj)
    tocc.write_pgm(tmp_path / "t.pgm", gt)
    assert (tmp_path / "j.pgm").read_bytes() == (tmp_path / "t.pgm").read_bytes()

    # TUM: the port's float64 quaternions against the reference's float32
    # ones, to float32's resolution; rotations near pi take other pivots
    w = rng.normal(size=(20, 3))
    w[:5] *= np.pi / np.linalg.norm(w[:5], axis=1, keepdims=True) * 0.999
    T = np.stack([tgeo.make_tf_np(p, q) for p, q in zip(rng.normal(size=(20, 3)), w)])
    t_us = np.arange(20) * 100000
    jtum.write_tum(str(tmp_path / "j.txt"), t_us, T)
    ttum.write_tum(str(tmp_path / "t.txt"), t_us, T)
    rows = lambda f: np.loadtxt(tmp_path / f)
    np.testing.assert_allclose(rows("t.txt"), rows("j.txt"), rtol=0, atol=2e-6)
    for f in ("j.txt", "t.txt"):
        (tj, Tj), (tt, Tt) = jtum.read_tum(str(tmp_path / f)), ttum.read_tum(str(tmp_path / f))
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_allclose(Tt, Tj, rtol=0, atol=2e-6)
        np.testing.assert_allclose(Tt, T, rtol=0, atol=1e-5)

    recs = (jrec.Record("x"), trec.Record("x"))
    for r in recs:
        for v in (1.0, 2.5, -3.0):
            r.add_record("series", v)
    assert recs[1].to_markdown() == recs[0].to_markdown()

    out = []
    for mod in (jaw, taw):
        w8 = mod.AsyncWriter(maxsize=2)
        for i in range(5):
            w8.submit(out.append, (mod.__name__, i))
        w8.submit(lambda: 1 / 0)
        errs = w8.close()
        assert len(errs) == 1 and "ZeroDivisionError" in errs[0]
    assert [i for m, i in out if m == taw.__name__] == [i for m, i in out if m == jaw.__name__] == list(range(5))

    # OpenLORIS: the text loader and the .npz round trip, across packages
    seq = tmp_path / "seq"
    seq.mkdir()
    t0 = 1560000000.0
    np.savetxt(seq / "imu.txt", np.column_stack([t0 + np.arange(20) * 0.01, rng.normal(size=(20, 6))]))
    q = rng.normal(size=(5, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.savetxt(seq / "odom.txt", np.column_stack([t0 + np.arange(5) * 0.05, rng.normal(size=(5, 3)), q]))
    with open(seq / "laser.txt", "w") as f:
        for k in range(3):
            r = " ".join(f"{x:.4f}" for x in rng.uniform(0.05, 5.0, 8))
            f.write(f"{t0 + 0.05 * k} {-np.pi} {2 * np.pi / 8} 8 {r}\n")
    sj, st = jol.load_sequence(str(seq)), tol.load_sequence(str(seq))
    for name in tol._FIELDS:
        a, b = getattr(sj, name), getattr(st, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 if name == "wheel_pose" else 0, err_msg=name)
    tol.save_npz(str(tmp_path / "t.npz"), st)
    back = jol.load_npz(str(tmp_path / "t.npz"))
    for name in tol._FIELDS:
        np.testing.assert_array_equal(getattr(back, name), getattr(st, name), err_msg=name)

    # ROS1 bags: a bz2 bag written by the port, read by both readers; lz4
    # frames across the two codecs
    bag = str(tmp_path / "t.bag")
    with tbag.BagWriter(bag, compression="bz2", indexed=True) as w:
        w.write("/d400/imu0", "sensor_msgs/Imu", 1.0, tbag.serialize_imu(1.0, [0, 0, 9.8], [0, 0, 0.1]))
        w.write("/scan", "sensor_msgs/LaserScan", 1.01, tbag.serialize_laser_scan(1.01, [2.0, np.nan, 2.1], 0.0, 0.01))
        w.write("/odom", "nav_msgs/Odometry", 1.02, tbag.serialize_odometry(1.02, [0.5, 0, 0], [0, 0, 0.383, 0.924]))
    mj, mt = list(jbag.read_messages(bag)), list(tbag.read_messages(bag))
    assert [m[:2] for m in mt] == [m[:2] for m in mj] and len(mt) == 3
    for (_, _, a), (_, _, b) in zip(mj, mt):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)
    blob = rng.integers(0, 256, 70000, dtype=np.uint8).tobytes() + b"abcd" * 300
    assert jbag.lz4_frame_decompress(tbag.lz4_frame_compress(blob)) == blob
    assert tbag.lz4_frame_decompress(jbag.lz4_frame_compress(blob)) == blob
    assert tbag._xxh32(blob) == jbag._xxh32(blob)

    # debug renderings: the same files, byte for byte
    px = rng.uniform(-3, 3, (200, 2))
    l1, l2 = rng.uniform(-3, 3, (5, 2)), rng.uniform(-3, 3, (5, 2))
    traj = np.stack([np.linspace(0, 2, 20), np.sin(np.linspace(0, 2, 20))], -1)
    img = rng.uniform(0, 1, (60, 80)).astype(np.float32)
    for tag, dv in (("j", jdv), ("t", tdv)):
        dv.render_frame_matches(str(tmp_path / f"{tag}_frame.png"), px, l1, l2, l1[:1], l1 + 0.05, l2 + 0.05, l1[:2], l2[:2], l1[:2] + 0.05, l2[:2] + 0.05)
        dv.render_merged_scans(str(tmp_path / f"{tag}_merged.png"), [(l1, l2), (l1 + 0.1, l2)])
        dv.render_trajectories(str(tmp_path / f"{tag}_traj.png"), [(traj, dv.C_TRAJ_A), (traj + 0.1, dv.C_TRAJ_B)], [(traj[0], traj[-1])])
        dv.render_camera_tracks(str(tmp_path / f"{tag}_cam.png"), img, px[:10] * 10 + 30, np.ones(10, bool))
    for name in ("frame", "merged", "traj", "cam"):
        (fj,), (ft,) = sorted(tmp_path.glob(f"j_{name}.*")), sorted(tmp_path.glob(f"t_{name}.*"))
        assert fj.suffix == ft.suffix and ft.read_bytes() == fj.read_bytes(), name
