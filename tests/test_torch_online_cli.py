"""The port's CLI (``python -m liwslam_torch.run``) and online runner on
the CPU, at tests/test_cli.py's small L-track size.

- The post-hoc run writes the reference CLI's files (fornt_end.txt,
  back_end.txt, map.pgm, pipeline.md) and report keys (liwslam/run.py:
  151-222 for a synthetic run without --debug-viz).
- ``--online`` (the back end fed by the online runner's worker thread
  during the run) reports what the post-hoc run reports: the same front
  end, the same keyframes fed to the same manager; back-end poses within
  1e-4 m (float32 solves), the rest equal.  It also writes the live
  trajectory and map.
- A checkpoint of the online run's manager, as the runner hands it back,
  holds what a checkpoint of a post-hoc feed of the same front-end result
  holds: the same keys and descriptor arrays (equal), keyframe poses
  within 1e-4 m.
- ``--online --no-backend`` builds no keyframe manager and writes no
  back-end file and no live map (the online run's front end replayed)."""

import json
import os

import numpy as np
import pytest

from liwslam_torch import run as cli
from liwslam_torch.backend.manager import KeyframeManager
from liwslam_torch.frontend.driver import Frontend
from liwslam_torch.io import tum
from liwslam_torch.online import OnlineRunner
from liwslam_torch.utils import checkpoint as ckpt

ARGS = [
    "--preset", "office", "--synthetic", "L", "--chunk", "8", "--laser-hz", "4", "--beams", "540",
    "--param", "max_points=576", "--param", "max_lines=48", "--param", "max_corners=16",
    "--param", "ref_capacity=512", "--param", "max_imu_per_frame=64", "--param", "solver_max_iterations=6",
    "--param", "init_solver_max_iterations=20", "--param", "loop_max_dis=2.5", "--device", "cpu",
]
REFERENCE_KEYS = {"frames", "keyframes", "ate_frontend_m", "loops", "ate_backend_m", "map_cells"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The post-hoc and the --online run, the online run's front end (its
    result and the chunk payloads it handed over) for a replay, and the
    online runner's result."""
    out, fe_run, record, online_run, online = {}, Frontend.run, [], OnlineRunner.run, []

    def keeping(self, streams, chunk_size=32):
        online.append(online_run(self, streams, chunk_size=chunk_size))
        return online[-1]

    def recording(self, streams, chunk_size=32, chunk_callback=None):
        infos = []
        cb = None if chunk_callback is None else (lambda info: (infos.append(info), chunk_callback(info)))
        res = fe_run(self, streams, chunk_size=chunk_size, chunk_callback=cb)
        record.append((res, infos))
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Frontend, "run", recording)
        mp.setattr(OnlineRunner, "run", keeping)
        for name, extra in (("posthoc", []), ("online", ["--online"])):
            d = tmp_path_factory.mktemp(name)
            out[name] = (d, cli.main(ARGS + ["--out", str(d)] + extra))
    out["online_front_end"] = record[-1]
    out["online_result"] = online[-1]
    return out


def test_cli_writes_the_reference_files_and_keys(runs):
    d, report = runs["posthoc"]
    assert set(report) == REFERENCE_KEYS
    json.dumps(report)
    assert report["frames"] > 20 and report["keyframes"] >= 3
    assert report["ate_frontend_m"] < 0.1 and report["ate_backend_m"] < 0.1
    for f in ("fornt_end.txt", "back_end.txt", "map.pgm", "pipeline.md"):
        assert os.path.exists(d / f), f
    front = [l for l in (d / "fornt_end.txt").read_text().splitlines() if not l.startswith("#")]
    assert len(front) == report["frames"] and len(front[0].split()) == 8
    t, T = tum.read_tum(str(d / "back_end.txt"))
    assert len(t) == report["keyframes"] and np.allclose(T[:, :3, :3] @ T[:, :3, :3].transpose(0, 2, 1), np.eye(3), atol=1e-6)


def test_online_run_reports_what_the_posthoc_run_reports(runs):
    (dp, a), (do, b) = runs["posthoc"], runs["online"]
    assert set(b) == REFERENCE_KEYS
    for k in ("frames", "keyframes", "loops", "map_cells", "ate_frontend_m"):
        assert b[k] == a[k], k
    assert b["ate_backend_m"] == pytest.approx(a["ate_backend_m"], abs=1e-4)
    _, Ta = tum.read_tum(str(dp / "back_end.txt"))
    _, Tb = tum.read_tum(str(do / "back_end.txt"))
    np.testing.assert_allclose(Tb[:, :3, 3], Ta[:, :3, 3], rtol=0, atol=1e-4)
    t_live, _ = tum.read_tum(str(do / "live_trajectory.txt"))
    assert 0 < len(t_live) < b["frames"]  # the tracked frames, without the init window
    assert os.path.exists(do / "live_map.pgm")


def test_online_manager_checkpoint_matches_a_posthoc_feed(runs, tmp_path):
    ores = runs["online_result"]
    ckpt.save_manager(str(tmp_path / "online"), ores.manager)
    res, mgr = ores.frontend, KeyframeManager(ores.manager.params, device="cpu")
    for ki, fi in enumerate(np.flatnonzero(res.is_keyframe)):
        mgr.add_keyframe(
            t_us=int(res.t_us[fi]), p=res.p[fi], q=res.q[fi], corners=res.kf_corners[ki], scan_lines=res.kf_scans[ki]
        )
    ckpt.save_manager(str(tmp_path / "posthoc"), mgr)
    a, b = (np.load(tmp_path / f"{n}.npz") for n in ("online", "posthoc"))
    assert set(a.files) == set(b.files) and any(k.startswith("mf") for k in a.files)
    assert (tmp_path / "online.json").read_text() == (tmp_path / "posthoc.json").read_text()
    for k in a.files:
        if k.startswith("kf") and k.endswith(("_p", "_q")):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_online_no_backend_builds_no_manager(runs, tmp_path, monkeypatch):
    """--online --no-backend, with the online run's front end replayed (its
    chunk payloads, keyframes included, and its result): the CLI's wiring
    builds no manager, feeds nothing and writes no back-end artifact."""
    from liwslam_torch.backend import manager

    def refuse(*a, **k):
        raise AssertionError("a KeyframeManager was built")

    res, infos = runs["online_front_end"]

    def replay(self, streams, chunk_size=32, chunk_callback=None):
        for info in infos:
            chunk_callback(info)
        return res

    monkeypatch.setattr(manager.KeyframeManager, "__init__", refuse)
    monkeypatch.setattr(Frontend, "run", replay)
    report = cli.main(ARGS + ["--out", str(tmp_path), "--online", "--no-backend"])
    a = runs["posthoc"][1]
    assert report == {k: a[k] for k in ("frames", "keyframes", "ate_frontend_m")}
    t_live, _ = tum.read_tum(str(tmp_path / "live_trajectory.txt"))
    assert len(t_live) == sum(info["n"] for info in infos) and any(info["keyframes"] for info in infos)
    assert os.path.exists(tmp_path / "fornt_end.txt")
    assert not os.path.exists(tmp_path / "back_end.txt") and not os.path.exists(tmp_path / "live_map.pgm")


@pytest.mark.parametrize("flag", ["--sequence", "--debug-viz"])
def test_unported_inputs_raise(flag, tmp_path, runs, monkeypatch):
    """What the CLI does with the two flags that raised NotImplementedError
    until the readers and the renderings were ported (the name is kept
    from then): ``--sequence`` reads the file it names, so a missing bag
    raises the reader's FileNotFoundError, not NotImplementedError;
    ``--debug-viz`` writes the three renderings beside the report (the
    post-hoc run's front end replayed).  tests/test_torch_io.py runs a bag
    end to end."""
    if flag == "--sequence":
        args = [a for a in ARGS if a not in ("--synthetic", "L")]
        with pytest.raises(FileNotFoundError):
            cli.main(args + ["--out", str(tmp_path), flag, str(tmp_path / "x.bag")])
        return
    res, _ = runs["online_front_end"]
    monkeypatch.setattr(Frontend, "run", lambda self, streams, chunk_size=32, chunk_callback=None: res)
    report = cli.main(ARGS + ["--out", str(tmp_path), flag])
    assert report["debug_viz"] is True and REFERENCE_KEYS <= report.keys()
    for name in ("merged_scans_frontend", "merged_scans_backend", "trajectory"):
        assert any(os.path.exists(tmp_path / (name + ext)) for ext in (".png", ".ppm")), name
