"""The traffic generator, the windows and the per-layer readers on the CPU."""

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves, tree_map

from benchmark import run
from benchmark.harness import check, fleet, runner, trace, windows
from benchmark.tests.cells import CORRIDOR, OFFICE, tiny_cell


def _replicas(seed, B=4, S=2, frames=3):
    cfg = run.load_cell(OFFICE)["cfg"]
    mix = dict(tracks=S, init_frames_max=60)
    packed = fleet.simulate_tracks(cfg, mix, seed, frames)
    tracks = [fleet.Track(clean=p, init_frames=None, first=30, state=None) for p in packed]
    return fleet.replica_inputs(tracks, B, frames, 0, cfg, seed, "cpu")


def test_fleet_same_seed_same_replicas_and_replicas_differ():
    a, b, c = _replicas(2**33 + 5), _replicas(2**33 + 5), _replicas(2**33 + 6)
    for k in fleet.FIELDS:
        assert torch.equal(a[k], b[k]), k
    # sequences 0 and 2 replay the same track: only their noise differs
    for k in ("imu_acc", "imu_gyro", "points", "wheel_pose"):
        assert not torch.equal(a[k][0], a[k][2]), k
        assert not torch.equal(a[k], c[k]), k
    for k in ("dt_us", "imu_t_us", "imu_mask", "wheel_t_us", "wheel_mask"):
        assert torch.equal(a[k][0], a[k][2]), k
    # no two sequences step the same inputs
    flat = a["points"].reshape(a["points"].shape[0], -1)
    assert len({tuple(r[:64].tolist()) for r in flat}) == flat.shape[0]


def test_tracks_differ_by_seed_and_stay_in_the_world():
    for name in (OFFICE, CORRIDOR):
        cfg = run.load_cell(name)["cfg"]
        rng = [np.random.default_rng(s) for s in (1, 2)]
        t1, t2 = (fleet.make_track(cfg, r, 40.0) for r in rng)
        assert t1.segments != t2.segments
        poses = fleet.sim.track_poses(t1, np.arange(0, 40.0, 0.5))
        if cfg["world"]["kind"] == "corridor":
            w = cfg["world"]
            assert (poses[:, 0, 3] > 0.3).all() and (poses[:, 0, 3] < w["length"] - 0.3).all()
            assert (np.abs(poses[:, 1, 3]) < w["width"] / 2 - 0.2).all()
        else:
            assert (np.abs(poses[:, :2, 3]) < cfg["world"]["size"] / 2 - 0.5).all()


def test_replay_pass_restarts_from_the_saved_states_exactly(monkeypatch):
    cell = tiny_cell(OFFICE, frames=2, chunk=1)
    prog, _, _, states0, inputs = runner.setup(cell["cfg"], cell["mix"], 12, "cpu")
    saved = tree_map(lambda t: t.clone(), states0)
    seen = []
    real = prog.run

    def spy(states, inp):
        seen.append(states)
        return real(states, inp)

    prog.run = spy
    # a clock that moves one second a reading: the window of 2.5 s runs
    # three chunks, the third after the pass of two has ended
    ticks = iter(range(100))
    monkeypatch.setattr(windows.time, "perf_counter", lambda: float(next(ticks)))
    res = windows.replay(prog, states0, inputs, 1, 2.5, check.Plan(seqs=[0], tracks=[]))
    assert len(seen) == 3 and res.frames == 2 * 3
    assert seen[0] is states0 and seen[2] is states0
    for a, b in zip(tree_leaves(states0), tree_leaves(saved)):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(seen[1]), tree_leaves(saved)))


def _synthetic_trace():
    tr = trace.Trace()
    # two steps: kernels at [0,100) [150,250) us, B1 and B2 among them
    tr.device = [("aten::mul", 0, 100), ("track_solve_kernel", 150, 250), ("extract_lines_kernel", 300, 310),
                 ("track_solve_kernel", 500, 600), ("extract_lines_kernel", 700, 710)]
    tr.host = [("cudaLaunchKernel", 0, 5)] * 6 + [("cudaStreamSynchronize", 400, 450)] * 2 + [("aten::eigh", 250, 300)]
    tr.steps = 2
    tr.window_s = 1000e-6
    tr.busy_s = trace.union_s([(a, b) for _, a, b in tr.device])
    tr.cell = dict(B=4, N=1152, L=64, window_peak_gib=1.5,
                   b1_launches=[(4000, 64, np.array([2, 3, 3, 8]))] * 2)
    return tr


def test_readers_on_a_synthetic_trace():
    from benchmark.harness import peaks, runner

    tr = _synthetic_trace()
    read = lambda name: runner._metric_reader(name)(tr)
    assert read("launches_per_step.replay") == 3.0
    assert read("device_idle_share.replay") == pytest.approx(100 * (1 - 320e-6 / 1000e-6))
    assert read("peak_mem_gib.replay") == 1.5
    b2 = read("extract_lines_roofline.replay")
    nbytes, nops = peaks.extract_lines(4, 1152, 64)
    assert b2 == pytest.approx(100 * max(nbytes / peaks.HBM_BYTES_S, nops / peaks.F32_FLOP_S) / 10e-6)
    b1 = read("track_solve_roofline.replay")
    nb, no = peaks.track_solve(4000, 64, [2, 3, 3, 8])
    assert b1 == pytest.approx(100 * max(nb / peaks.HBM_BYTES_S, no / peaks.F32_FLOP_S) / 100e-6)
    br = trace.breakdown(tr)
    assert br["device_ops"][0] == ["track_solve_kernel", 200e-6]
    assert dict(br["idle_gaps"])["aten::eigh"] == pytest.approx(50e-6)


def test_readers_find_nothing_in_an_empty_trace():
    tr = trace.Trace()
    for name in ("launches_per_step.replay", "device_idle_share.replay", "track_solve_roofline.replay",
                 "extract_lines_roofline.replay", "peak_mem_gib.replay"):
        from benchmark.harness import runner

        assert runner._metric_reader(name)(tr) is None, name
