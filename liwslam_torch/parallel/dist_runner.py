"""Multi-process runs of the edge-sharded pose-graph solve over
``torch.distributed``, and the verdict of each against one process.

The port's twin of ``tools/dist_runner.py``, with its two modes, and of
``__graft_entry__.dryrun_multichip``'s composed flow:

- ``solve``: every rank builds the same ring graph (:func:`build_graph`),
  solves its slice of the edges with
  :func:`~liwslam_torch.parallel.posegraph_dist.solve_pcg_sharded`, and
  rank 0 holds the result to the single-process ``solve_pcg``;
- ``pipeline``: each rank runs its own robot's front end; the keyframes
  cross the ranks in one ``all_gather_object``; rank 0's
  ``KeyframeManager`` (one session per rank) closes the cross-session
  loop; its graph goes out to every rank in two broadcasts (first its
  sizes, then its tensors), and all ranks solve it together, edge-sharded.
  ``--feed synthetic`` replaces the front ends by keyframes sampled from
  the same two tracks with drift (no front end: the exchange alone);
- ``composed``: B sequences (the bench track, seed 1 + b) split over the
  ranks (``parallel/multiseq``'s dp mode): each rank simulates and
  initializes its own B/W, steps them one chunk of F frames, and the
  poses come together in one ``all_gather``; they seed a K = 1024 /
  E = 4096 pose graph (:func:`composed_graph`) that all ranks solve
  edge-sharded.  Rank 0 holds the gathered poses to one process's batched
  run of all B, and the sharded solves to the unsharded float64 one (which
  the last rank runs meanwhile).

Usage::

    python -m liwslam_torch.parallel.dist_runner --mode solve \\
        --num-processes 2 --device cpu --backend gloo
    python -m liwslam_torch.parallel.dist_runner --mode pipeline \\
        --num-processes 2 --backend gloo          # both ranks on cuda:0
    python -m liwslam_torch.parallel.dist_runner --backend nccl --num-processes 1
    python -m liwslam_torch.parallel.dist_runner --mode composed \\
        --widths bench --num-processes 4              # NCCL, a card a rank
    python -m liwslam_torch.parallel.dist_runner --mode composed \\
        --widths tiny --device cpu --num-processes 2  # gloo on the CPU

Ranks meet at a file under a fresh temporary directory
(``init_method="file://..."``), so concurrent runs never share a port.
Rank r runs on ``cuda:(r % device_count)``; NCCL needs a card a rank,
gloo reduces CUDA tensors through the host and takes several ranks on
one card.  Prints one JSON verdict line (rank 0's) and exits 0 when it
says ``"ok": true``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from liwslam_torch import config, resolve_device
from liwslam_torch.backend import posegraph as pg
from liwslam_torch.core import geometry as geo
from liwslam_torch.parallel import posegraph_dist as pgd


@dataclasses.dataclass
class RunConfig:
    mode: str = "solve"  # "solve", "pipeline" or "composed"
    num_processes: int = 2
    device: str = "cuda"
    backend: str = "nccl"
    dtype: str = "float32"  # solve mode: the graph's dtype
    nodes: int = 64  # solve mode: the ring graph's size
    edges: int = 128
    gn_iters: int = 30  # solve mode: the reference tool's iteration caps
    cg_iters: int = 40
    feed: str = "frontend"  # pipeline mode: "frontend" or "synthetic"
    widths: str = "runner"  # pipeline: "runner" or "bench"; composed: "bench" or "tiny" (widths and rates)
    sequences: int = 0  # composed mode: B (0: 8 a rank)
    frames: int = 32  # composed mode: F, the chunk's frames
    streams: str = ""  # composed mode: a directory of streams simulated before (save_streams), else simulate


KF_CAPACITY = 96  # keyframes a rank sends at most (the reference tool's)


# ------------------------------------------------------------ solve mode ----


def build_graph(K, E, seed=0, params=None):
    """The reference tool's ring graph (``tools/dist_runner.py:30``) as
    padded numpy arrays: K poses on a 10 m circle, K-1 sequential edges
    and up to K/4 loop edges (weight 10) measured from the true poses, the
    start poses drifted by a random walk.  Returns a dict of
    :func:`~liwslam_torch.backend.posegraph.graph_from_numpy`'s arguments
    (float32 poses, as the reference rounds them)."""
    params = config.office() if params is None else params
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, K)
    gt_p = np.stack([10 * np.cos(th), 10 * np.sin(th), np.zeros(K)], -1)
    yaw = th + np.pi / 2
    # IMU-frame poses: T_w_imu = T_w_wheel @ T_imu_to_wheel^-1, so the
    # ground factors see a level wheel frame
    Tiw_inv = np.linalg.inv(params.mat_T_imu_to_wheel())

    def tf_of(k):
        c, s = np.cos(yaw[k]), np.sin(yaw[k])
        T = np.eye(4)
        T[:2, :2] = [[c, -s], [s, c]]
        T[:3, 3] = gt_p[k]
        return T @ Tiw_inv

    n_seq = K - 1
    ei, ej = np.zeros(E, np.int64), np.zeros(E, np.int64)
    etf = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    ew = np.zeros(E, np.float32)
    for k in range(n_seq):
        ei[k], ej[k] = k, k + 1
        etf[k] = np.linalg.inv(tf_of(k)) @ tf_of(k + 1)
        ew[k] = 1.0
    n_loops = min(E - n_seq, K // 4)
    for n in range(n_loops):
        a = int(rng.integers(0, K // 2))
        b = int(rng.integers(K // 2, K - 1))
        ei[n_seq + n], ej[n_seq + n] = a, b
        etf[n_seq + n] = np.linalg.inv(tf_of(a)) @ tf_of(b)
        ew[n_seq + n] = 10.0
    drift = np.cumsum(rng.normal(0, 0.01, (K, 3)), 0) * [1, 1, 0]
    p0, q0 = np.zeros((K, 3), np.float32), np.zeros((K, 3), np.float32)
    for k in range(K):
        pp, qq = geo.log_SE3_np(tf_of(k).astype(np.float32).astype(np.float64))
        p0[k] = pp.astype(np.float32) + drift[k]
        q0[k] = qq
    return dict(p=p0, q=q0, n_nodes=K, e_i=ei, e_j=ej, e_tf=etf, e_weight=ew, n_edges=n_seq + n_loops)


def to_dtype(g: pg.PoseGraph, c: pg.PGConsts, dtype):
    """A graph and its constants in ``dtype``."""
    g = g._replace(**{f: getattr(g, f).to(dtype) for f in ("p", "q", "e_tf", "e_weight")})
    return g, c._replace(info6=c.info6.to(dtype), T_imu_to_wheel=c.T_imu_to_wheel.to(dtype))


def graph_cost(g, c):
    r_e, r_g = pg.graph_residuals(g, c)
    return float(0.5 * (torch.sum(r_e * r_e) + torch.sum(r_g * r_g)))


def _gathered_equal(t):
    """Whether every rank holds the same bits of ``t``."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return all(torch.equal(parts[0], x) for x in parts[1:])


def sharded_against_single(g, c, gn_iters, cg_iters, rank, world):
    """Solve ``g`` edge-sharded over the default group, and on rank 0 once
    more in this process alone.  Returns the verdict's numbers (rank 0's;
    the others get ``ranks_equal`` and None)."""
    stats = {}
    if g.p.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_out, cost = pgd.solve_pcg_sharded(pgd.shard_edges(g, rank, world), c, gn_iters=gn_iters, cg_iters=cg_iters, stats=stats)
    pq = torch.cat([g_out.p, g_out.q], 1)
    cost_multi = float(cost)
    solve_s = time.perf_counter() - t0
    equal = _gathered_equal(pq)
    if rank != 0:
        return dict(ranks_equal=equal)
    g1, cost1 = pg.solve_pcg(g, c, gn_iters=gn_iters, cg_iters=cg_iters)
    K = g.n_nodes
    dp = float(torch.max(torch.abs(g_out.p[:K] - g1.p[:K])))
    dq = float(torch.max(torch.abs(g_out.q[:K] - g1.q[:K])))
    return dict(
        cost_initial=graph_cost(g, c),
        cost_multi=cost_multi,
        cost_single=float(cost1),
        max_dp=dp,
        max_dq=dq,
        ranks_equal=equal,
        gn_iters=stats["gn_iters"],
        cg_iters=stats.get("cg_iters", 0),
        reductions=stats["reductions"],
        solve_s=solve_s,
        p_multi=g_out.p[:K].cpu().numpy().tolist(),
    )


def _run_solve(cfg: RunConfig, rank, world, dev):
    prm = config.office()
    g = pg.graph_from_numpy(**build_graph(cfg.nodes, cfg.edges), device=dev)
    g, c = to_dtype(g, pg.make_pg_consts(prm, dev), getattr(torch, cfg.dtype))
    v = sharded_against_single(g, c, cfg.gn_iters, cfg.cg_iters, rank, world)
    if rank != 0:
        return None
    cm, cs, c0 = v["cost_multi"], v["cost_single"], v["cost_initial"]
    ok = abs(cm - cs) < 0.05 * cs + 1e-3 and cm < 0.5 * c0 and cs < 0.5 * c0 and v["ranks_equal"]
    return dict(mode="solve", n_processes=world, K=cfg.nodes, E=cfg.edges, dtype=cfg.dtype, **v, ok=bool(ok))


# --------------------------------------------------------- pipeline mode ----


def pipeline_params(widths="runner"):
    """The reference runner's parameters (``tools/dist_runner.py:259-270``):
    keyframe thresholds and loop knobs over the office preset, at its own
    widths or at bench.py's (1152 points, 64 lines, 16 corners)."""
    knobs = dict(
        key_frame_p_motion_threshold=0.12,
        key_frame_q_motion_threshold=0.12,
        loop_detect_min_interval=1000,  # isolate the cross-session loop
        submap_count=8,
        pose_graph_solve_interval_s=4.0,
        loop_max_dis=2.5,
    )
    if widths == "bench":
        sizes = config.BENCH_WIDTHS
    else:
        sizes = dict(max_points=768, max_lines=48, max_corners=16, ref_capacity=384, max_imu_per_frame=32,
                     max_wheel_per_frame=8, solver_max_iterations=5, init_solver_max_iterations=20)
    return config.office().replace(**sizes, **knobs)


def pipeline_track(session):
    """The runner's two equal-length tracks (``tools/dist_runner.py:272-282``):
    robot 1 starts 0.9 m / -0.7 m and 0.55 rad from robot 0."""
    from liwslam_torch.sim import world as sim

    leg = [(3.5, 0.35, 0.0, 0.0), (2.6, 0.25, 0.0, np.pi / 2 / 2.6)]
    T0 = None if session == 0 else sim.make_tf_np(np.array([0.9, -0.7]), 0.55)
    return sim.TwistTrack([(2.0, 0.0, 0.0, 0.0)] + leg * 3, T0=T0)


def pipeline_streams(session, prm, widths="runner"):
    """The rank's simulated streams: the runner's room and rates, or
    bench.py's rates (1080 beams, laser 10 Hz, IMU 200 Hz, wheel 20 Hz)."""
    from liwslam_torch.sim import world as sim

    room = sim.square_room(size=12.0, obstacles=True, rich=True)
    rates = dict(imu_hz=200, wheel_hz=20, laser_hz=10, n_beams=1080) if widths == "bench" else dict(
        imu_hz=100, wheel_hz=20, laser_hz=4, n_beams=720
    )
    return sim.simulate(pipeline_track(session), room, prm, **rates, noise=True, seed=3 + session)


def synthetic_keyframes(session, prm, seed=0):
    """Keyframes of the rank's track without a front end: a pose every
    1.6 s of motion in the robot's own odometry frame (its start is the
    origin), drifting 2 mrad and 5 mm a keyframe, and the corners of a
    fixed random constellation over the room within 6 m, in the drifted
    frame (as a front end records them)."""
    rng = np.random.default_rng(seed + session)
    world = np.concatenate([np.random.default_rng(seed).uniform(-5.5, 5.5, (24, 2)), np.zeros((24, 1))], 1)
    track = pipeline_track(session)
    T0 = np.eye(4) if track.T0 is None else track.T0
    Tiw_inv = np.linalg.inv(prm.mat_T_imu_to_wheel())
    kfs = []
    T_drift = np.eye(4)
    for t in np.arange(2.0, track.total_time(), 1.6):
        T_true = np.linalg.inv(T0) @ track.pose(t)  # the robot's own frame
        T_odo = T_drift @ T_true
        vis = world[np.linalg.norm(world[:, :2] - track.pose(t)[:2, 3], axis=1) < 6.0]
        own = (np.linalg.inv(T0)[:3, :3] @ vis.T).T + np.linalg.inv(T0)[:3, 3]
        corners = (T_drift[:3, :3] @ own.T).T + T_drift[:3, 3]
        p, q = geo.log_SE3_np(T_odo @ Tiw_inv)
        kfs.append((int(t * 1e6), p, q, corners))
        yaw = rng.normal(0, 2e-3)
        T_drift = T_drift @ np.array(
            [[np.cos(yaw), -np.sin(yaw), 0, rng.normal(0, 5e-3)], [np.sin(yaw), np.cos(yaw), 0, rng.normal(0, 5e-3)],
             [0, 0, 1, 0], [0, 0, 0, 1]]
        )
    return kfs


def pack_keyframes(kfs, KC, CC):
    """The reference runner's keyframe pack (``tools/dist_runner.py:286-303``)
    from a list of (t_us, p, q, corners), at most KC keyframes of at most
    CC corners."""
    kfs = kfs[:KC]
    pack = {
        "n": np.asarray([len(kfs)], np.int32),
        "t_us": np.zeros(KC, np.int64),
        "p": np.zeros((KC, 3), np.float64),
        "q": np.zeros((KC, 3), np.float64),
        "corners": np.zeros((KC, CC, 3), np.float32),
        "ccount": np.zeros(KC, np.int32),
    }
    for n, (t_us, p, q, corners) in enumerate(kfs):
        cn = np.asarray(corners).reshape(-1, 3)[:CC]
        pack["t_us"][n], pack["p"][n], pack["q"][n] = t_us, p, q
        pack["corners"][n, : len(cn)] = cn
        pack["ccount"][n] = len(cn)
    return pack


def broadcast_graph(g, dev, src=0):
    """Rank ``src``'s PoseGraph on every rank, in two broadcasts of its
    sizes (K, E, nodes, edges) and then of its float and index tensors;
    no capacity is agreed beforehand.  ``g`` is ignored off ``src``."""
    rank = dist.get_rank()
    sizes = torch.zeros(4, dtype=torch.int64, device=dev)
    if rank == src:
        sizes = torch.tensor([g.p.shape[0], g.e_i.shape[0], g.n_nodes, g.n_edges], dtype=torch.int64, device=dev)
    dist.broadcast(sizes, src)
    K, E, n_nodes, n_edges = sizes.tolist()
    nf = 6 * K + 17 * E
    if rank == src:
        f = torch.cat([g.p.reshape(-1), g.q.reshape(-1), g.e_tf.reshape(-1), g.e_weight]).float().contiguous()
        i = torch.cat([g.e_i, g.e_j]).contiguous()
    else:
        f = torch.empty(nf, dtype=torch.float32, device=dev)
        i = torch.empty(2 * E, dtype=torch.int64, device=dev)
    dist.broadcast(f, src)
    dist.broadcast(i, src)
    return pg.PoseGraph(
        p=f[: 3 * K].reshape(K, 3),
        q=f[3 * K : 6 * K].reshape(K, 3),
        node_valid=torch.arange(K, device=dev) < n_nodes,
        e_i=i[:E],
        e_j=i[E:],
        e_tf=f[6 * K : 6 * K + 16 * E].reshape(E, 4, 4),
        e_weight=f[6 * K + 16 * E :],
        e_valid=torch.arange(E, device=dev) < n_edges,
        n_nodes=int(n_nodes),
        n_edges=int(n_edges),
    )


def exchange_and_solve(kfs, prm, dev):
    """The pipeline after the front ends: this rank's keyframes (a list of
    (t_us, p, q, corners)) to every rank in one ``all_gather_object``,
    rank 0's manager over all of them (session = rank), its graph
    broadcast, the edge-sharded solve by all ranks, and rank 0's check
    against the single-process solve.  Returns rank 0's verdict (None
    elsewhere)."""
    from liwslam_torch.backend.manager import KeyframeManager

    rank, world = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    gathered = [None] * world
    dist.all_gather_object(gathered, pack_keyframes(kfs, KF_CAPACITY, 4 * prm.max_corners))
    gather_s = time.perf_counter() - t0
    g0, n_cross = None, 0
    if rank == 0:
        mgr = KeyframeManager(prm, device=dev)
        empty = np.zeros((0, 3))
        feed = [
            (int(pk["t_us"][n]), s, pk["p"][n], pk["q"][n], pk["corners"][n][: pk["ccount"][n]])
            for s, pk in enumerate(gathered)
            for n in range(int(pk["n"][0]))
        ]
        feed.sort(key=lambda r: (r[0], r[1]))
        for t_us, s, p_, q_, corners in feed:
            mgr.add_keyframe(t_us=t_us, p=p_, q=q_, corners=corners, scan_lines=(empty, empty), session=s)
        g0 = mgr._build_graph()
        n_cross = sum(1 for i, j, _ in mgr.loop_edges if mgr.keyframes[i].session != mgr.keyframes[j].session)
    g = broadcast_graph(g0, dev)
    c = pg.make_pg_consts(prm, dev)
    v = sharded_against_single(g, c, 20, 40, rank, world)
    if rank != 0:
        return None
    v.pop("p_multi")
    cm, cs, c0 = v["cost_multi"], v["cost_single"], v["cost_initial"]
    ok = n_cross >= 1 and abs(cm - cs) < 0.05 * max(cs, 1e-9) + 1e-3 and cm <= c0 + 1e-6 and v["max_dp"] < 0.05 and v["ranks_equal"]
    return dict(
        mode="pipeline", n_processes=world, keyframes=g.n_nodes, edges=g.n_edges, cross_session_loops=n_cross,
        gather_s=gather_s, **v, ok=bool(ok),
    )


def _run_pipeline(cfg: RunConfig, rank, world, dev):
    prm = pipeline_params(cfg.widths)
    info = dict(rank=rank)
    if cfg.feed == "synthetic":
        kfs = synthetic_keyframes(rank, prm)
    else:
        from liwslam_torch.frontend.driver import Frontend

        streams = pipeline_streams(rank, prm, cfg.widths)
        t0 = time.perf_counter()
        res = Frontend(prm, device=dev).run(streams, chunk_size=16)
        dt = time.perf_counter() - t0
        info.update(frames=len(res.t_us), frontend_s=dt, frames_per_s=len(res.t_us) / dt)
        kfs = [(int(res.t_us[f]), res.p[f], res.q[f], c) for f, c in zip(res.kf_indices, res.kf_corners)]
    # every rank's front-end numbers to rank 0 (this also aligns the ranks
    # before the timed keyframe exchange)
    infos = [None] * world
    dist.all_gather_object(infos, info)
    v = exchange_and_solve(kfs, prm, dev)
    if v is not None:
        v["ranks"] = infos
        v["feed"], v["widths"] = cfg.feed, cfg.widths
    return v


# --------------------------------------------------------- composed mode ----

PG_NODES, PG_EDGES = 1024, 4096  # the composed graph (__graft_entry__.py:126-171)
SOLVE_ITERS = dict(gn_iters=20, cg_iters=60)  # the float32 solve's caps, as the manager calls it
EXIT_ITERS = dict(gn_iters=200, cg_iters=200)  # the float64 solves, run to their own exit


def composed_params(widths="bench"):
    """bench.py's widths (``config.BENCH_WIDTHS``), or the reference
    entry's small ones (``config.TINY_WIDTHS``) with an 8-iteration init
    solve (the entry runs no init window; both sides of every comparison
    start from the same init states)."""
    if widths == "bench":
        return config.bench_params()
    return config.tiny_params().replace(init_solver_max_iterations=8)


def composed_streams(seed, prm, widths="bench", **extra):
    """Sequence ``seed - 1``'s streams: bench.py's office loop track at its
    rates (1080 beams at 10 Hz, IMU 200 Hz, wheel 20 Hz, noise), or at the
    small widths the L track at rates they hold (256 beams at 10 Hz, IMU
    50 Hz, wheel 20 Hz: at most 8 IMU and 4 wheel samples a frame).
    ``extra`` goes to ``sim.simulate`` (a camera's ``camera_hz`` and
    ``camera_wh``; the camera draws its noise last, so the other streams
    stay the same)."""
    from liwslam_torch.sim import world as sim

    if widths == "bench":
        return sim.simulate(sim.default_track("loop"), sim.square_room(size=12.0, obstacles=True, rich=True), prm,
                            imu_hz=200, wheel_hz=20, laser_hz=10, n_beams=1080, noise=True, seed=seed, **extra)
    return sim.simulate(sim.default_track("L"), sim.square_room(obstacles=True), prm, imu_hz=50, wheel_hz=20,
                        laser_hz=10, n_beams=256, noise=True, seed=seed, **extra)


def save_streams(directory, seed, streams):
    """Write one sequence's streams (every field of ``SimStreams``) as
    ``<directory>/seed<seed>.npz``, where ``RunConfig.streams`` reads them."""
    os.makedirs(directory, exist_ok=True)
    arrays = {f.name: getattr(streams, f.name) for f in dataclasses.fields(streams)}
    np.savez(os.path.join(directory, f"seed{seed}.npz"), **arrays)


def _load_streams(directory, seed):
    from liwslam_torch.sim import world as sim

    with np.load(os.path.join(directory, f"seed{seed}.npz")) as z:
        return sim.SimStreams(**{k: z[k] for k in z.files})


def composed_graph(p, q, T_imu_to_wheel, K=PG_NODES, E=PG_EDGES, seed=0):
    """The composed flow's pose graph (``__graft_entry__.py:126-171``), as
    :func:`~liwslam_torch.backend.posegraph.graph_from_numpy`'s arguments.
    The front ends' IMU-frame poses ``p``, ``q`` (B, F, 3), sequence after
    sequence, seed the first min(B*F, K) of K nodes, laid flat (each wheel frame's
    x, y and yaw kept, its height and tilt zeroed, so the ground rows agree
    with the edges); the trajectory goes on from the last of them 0.25 m a
    node along x with its yaw (the reference's zero rotation lays the wheel
    frame on its side, where the ground rows fight the edges).  Edges: K - 1
    sequential and K/2 loop edges (weight 10) between random nodes up to
    K/4 apart, all measured from those poses, padded to E slots.  The solve
    starts from the poses moved in their own frames by a seeded 2 cm in x
    and y and 2 mrad of yaw (the first node fixed): the correction it has
    to find."""
    T_iw = np.asarray(T_imu_to_wheel, np.float64)
    W = geo.make_tf(torch.as_tensor(np.asarray(p, np.float32).reshape(-1, 3)).double(),
                    torch.as_tensor(np.asarray(q, np.float32).reshape(-1, 3)).double()).numpy()[:K] @ T_iw
    n_fe = len(W)
    x = np.concatenate([W[:, 0, 3], W[-1, 0, 3] + 0.25 * np.arange(1, K - n_fe + 1)])
    y = np.concatenate([W[:, 1, 3], np.full(K - n_fe, W[-1, 1, 3])])
    yaw = np.arctan2(W[:, 1, 0], W[:, 0, 0])
    yaw = np.concatenate([yaw, np.full(K - n_fe, yaw[-1])])
    flat = lambda x, y, yaw: geo.make_tf(torch.as_tensor(np.stack([x, y, 0 * x], -1)),
                                         torch.as_tensor(np.stack([0 * yaw, 0 * yaw, yaw], -1))).numpy()
    T = flat(x, y, yaw) @ np.linalg.inv(T_iw)
    rng = np.random.default_rng(seed)
    n_loop = min(E - (K - 1), K // 2)
    a = rng.integers(0, K - 1, n_loop)
    b = np.minimum(a + rng.integers(2, K // 4, n_loop), K - 1)
    ei = np.concatenate([np.arange(K - 1), a])
    ej = np.concatenate([np.arange(1, K), b])
    n_e = len(ei)
    etf = np.concatenate([np.linalg.inv(T[ei]) @ T[ej], np.tile(np.eye(4), (E - n_e, 1, 1))])
    ew = np.concatenate([np.ones(K - 1), np.full(n_loop, 10.0), np.zeros(E - n_e)])
    noise = np.random.default_rng(seed + 1)
    dp = noise.normal(0, 0.02, (K, 3)) * [1.0, 1.0, 0.0]
    dyaw = noise.normal(0, 2e-3, K)
    dp[0], dyaw[0] = 0.0, 0.0
    p0, q0 = (t.numpy() for t in geo.log_SE3(torch.as_tensor(T @ flat(dp[:, 0], dp[:, 1], dyaw))))
    pad = lambda a: np.concatenate([a, np.zeros(E - n_e, a.dtype)])
    return dict(p=p0, q=q0, n_nodes=K, e_i=pad(ei), e_j=pad(ej), e_tf=etf, e_weight=ew, n_edges=n_e)


def pose_gap(a, b):
    """(max |dp| m, largest rotation angle rad) between two PoseGraphs'
    valid poses; the angle from the rotation matrices (2 sin(θ/2) =
    |Ra - Rb|_F / √2)."""
    K = a.n_nodes
    pa, pb = a.p[:K].cpu().double(), b.p[:K].cpu().double()
    Ra, Rb = (geo.make_tf(g.p[:K].cpu().double(), g.q[:K].cpu().double())[..., :3, :3] for g in (a, b))
    ang = 2 * torch.asin(torch.clamp(torch.linalg.matrix_norm(Ra - Rb) / 8**0.5, max=1.0))
    return float((pa - pb).abs().max()), float(ang.max())


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _front_ends(cfg, rank, world, dev, prm):
    """This rank's sequences simulated (or loaded), initialized and stepped
    one chunk; the poses gathered.  Returns (gathered {p, q} (B, F, 3),
    the rank's numbers, its initial states and inputs on the host)."""
    from liwslam_torch.frontend.driver import Frontend
    from liwslam_torch.ops import extract as ext
    from liwslam_torch.ops import track_solve as ts
    from liwslam_torch.parallel import multiseq

    B, F = cfg.sequences or 8 * world, cfg.frames
    fe = Frontend(prm, device=dev)
    run, shard = multiseq.batched_chunk_fn(fe.consts, fe.dcfg, fe.scfg, group=dist.group.WORLD)
    seeds = shard([1 + b for b in range(B)])
    t0 = time.perf_counter()
    streams = [_load_streams(cfg.streams, s) if cfg.streams else composed_streams(s, prm, cfg.widths) for s in seeds]
    sim_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seqs = fe.init_sequences(streams)
    _sync(dev)
    init_s = time.perf_counter() - t0
    if seqs.n_common < F:
        raise RuntimeError(f"composed: rank {rank}'s sequences have {seqs.n_common} common tracked frames < {F}")
    states, inputs = seqs.states, fe.stack_sequences(seqs, 0, F)
    host = tree_map(lambda t: t.cpu(), (states, inputs))
    ext.extract_lines_batched.launches = ts.lm_solve_track_batched.launches = 0
    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    _, out = run(states, inputs)
    _sync(dev)
    chunk_s = time.perf_counter() - t0
    b1, b2 = ts.lm_solve_track_batched.launches, ext.extract_lines_batched.launches
    t0 = time.perf_counter()
    g = multiseq.gather_outputs(out, dist.group.WORLD)
    _sync(dev)
    gather_s = time.perf_counter() - t0
    info = dict(
        rank=rank, device=str(dev), seeds=seeds, sim_s=sim_s, init_s=init_s, chunk_s=chunk_s,
        frames_per_s=len(seeds) * F / chunk_s, b1=b1, b2=b2, gather_s=gather_s,
    )
    return g, info, host


def _one_process_check(hosts, gathered, dev, prm):
    """One process's batched run of all B sequences (no group) from every
    rank's initial states and inputs, against the gathered poses."""
    from liwslam_torch.frontend.driver import Frontend
    from liwslam_torch.parallel import multiseq

    states, inputs = tree_map(lambda *xs: torch.cat(xs).to(dev), *hosts)
    fe = Frontend(prm, device=dev)
    _, ref = multiseq.batched_chunk_fn(fe.consts, fe.dcfg, fe.scfg)(states, inputs)
    gp, gq = gathered["p"], gathered["q"]
    return dict(
        fe_bit_equal=bool(torch.equal(gp, ref.p) and torch.equal(gq, ref.q)),
        fe_max_dp=float((gp - ref.p).abs().max()),
        fe_finite=bool(torch.isfinite(gp).all() and torch.isfinite(gq).all()),
    )


def _run_composed(cfg: RunConfig, rank, world, dev):
    prm = composed_params(cfg.widths)
    gathered, info, host = _front_ends(cfg, rank, world, dev, prm)
    infos = [None] * world
    dist.all_gather_object(infos, info)
    hosts = [None] * world
    dist.all_gather_object(hosts, host)
    # the gathered poses seed the graph, the same on every rank
    gr = composed_graph(gathered["p"].cpu().numpy(), gathered["q"].cpu().numpy(), prm.mat_T_imu_to_wheel())
    g = pg.graph_from_numpy(**gr, device=dev)
    c = pg.make_pg_consts(prm, dev)
    g64, c64 = to_dtype(g, c, torch.float64)
    K = g.n_nodes
    # the two checks that need one rank, side by side where there are two:
    # rank 0 reruns all B front ends in one process, the last rank solves the
    # float64 graph unsharded (the optimum the sharded solves are held to)
    # and broadcasts its poses, cost and seconds
    fe_v = {}
    if rank == 0:
        t0 = time.perf_counter()
        fe_v = _one_process_check(hosts, gathered, dev, prm)
        fe_v["one_process_s"] = time.perf_counter() - t0
    single = torch.empty(6 * K + 2, dtype=torch.float64, device=dev)
    if rank == world - 1:
        t0 = time.perf_counter()
        gu, cost_u = pg.solve_pcg(g64, c64, **EXIT_ITERS)
        cost_u = float(cost_u)
        tail = torch.tensor([cost_u, time.perf_counter() - t0], dtype=torch.float64, device=dev)
        single = torch.cat([gu.p[:K].reshape(-1), gu.q[:K].reshape(-1), tail])
    dist.broadcast(single, world - 1)
    st32 = {}
    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    g32, cost32 = pgd.solve_pcg_sharded(pgd.shard_edges(g, rank, world), c, **SOLVE_ITERS, stats=st32)
    p32 = g32.p.cpu()
    solve_s = time.perf_counter() - t0
    eq32 = _gathered_equal(torch.cat([g32.p, g32.q], 1))
    st64 = {}
    t0 = time.perf_counter()
    gs64, cost_s64 = pgd.solve_pcg_sharded(pgd.shard_edges(g64, rank, world), c64, **EXIT_ITERS, stats=st64)
    cost_s64 = float(cost_s64)
    solve64_s = time.perf_counter() - t0
    eq64 = _gathered_equal(torch.cat([gs64.p, gs64.q], 1))
    if rank != 0:
        return None
    gu64 = g64._replace(p=single[: 3 * K].view(K, 3), q=single[3 * K : 6 * K].view(K, 3))
    cost_u64, single64_s = single[6 * K :].tolist()
    dp64, dq64 = pose_gap(gs64, gu64)
    dp32, dq32 = pose_gap(g32, gu64)
    corr_p, corr_q = pose_gap(g, gu64)
    B, F = gathered["p"].shape[:2]
    chunk_s = max(i["chunk_s"] for i in infos)
    v = dict(
        mode="composed", n_processes=world, widths=cfg.widths, B=B, F=F, ranks=infos,
        frames_per_s=B * F / chunk_s, **fe_v,
        K=K, E=g.n_edges, cost_initial=graph_cost(g, c), cost_sharded=float(cost32),
        gn_iters=st32["gn_iters"], cg_iters=st32.get("cg_iters", 0), reductions=st32["reductions"], solve_s=solve_s,
        cost_sharded64=cost_s64, cost_single64=cost_u64, gn_iters64=st64["gn_iters"], solve64_s=solve64_s,
        single64_s=single64_s, correction_dp=corr_p, correction_dq=corr_q, max_dp64=dp64, max_dq64=dq64,
        max_dp32=dp32, max_dq32=dq32, ranks_equal=bool(eq32 and eq64),
        gathered_p=gathered["p"].cpu().numpy().tolist(), gathered_q=gathered["q"].cpu().numpy().tolist(),
        p_multi=p32[:K].numpy().tolist(),
    )
    v["ok"] = bool(
        v["fe_bit_equal"] and v["fe_finite"] and v["ranks_equal"] and dp64 <= 1e-9 and dq64 <= 1e-9
        and dp32 <= 2e-3 and dq32 <= 1e-4 and math.isfinite(v["cost_sharded"])
    )
    return v


# ---------------------------------------------------------------- launch ----


def _imports_reference():
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "liwslam"))


def _worker(rank, cfg: RunConfig, tmp):
    dev = torch.device(cfg.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    # the ranks share the host's cores (their host math, on the card too)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * cfg.num_processes)))
    dist.init_process_group(
        cfg.backend, init_method=f"file://{os.path.join(tmp, 'rdv')}", world_size=cfg.num_processes, rank=rank
    )
    try:
        run = dict(solve=_run_solve, pipeline=_run_pipeline, composed=_run_composed)[cfg.mode]
        v = run(cfg, rank, cfg.num_processes, dev)
        # what each rank imported: the port imports nothing of the reference
        loaded = [None] * cfg.num_processes
        dist.all_gather_object(loaded, _imports_reference())
        if rank == 0:
            v["reference_modules_loaded"] = sorted({m for ms in loaded for m in ms})
            v["ok"] = bool(v["ok"] and not v["reference_modules_loaded"])
            with open(os.path.join(tmp, "verdict.json"), "w") as fh:
                json.dump(v, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


def launch(cfg: RunConfig) -> dict:
    """Spawn ``cfg.num_processes`` ranks and return rank 0's verdict.  The
    device is resolved first (CUDA unless ``cfg.device`` is "cpu"; raises
    when CUDA is missing, and NCCL needs a device for each rank), and the kernels are built here, before the
    spawn, so that the ranks only load them.  A world of one runs in this
    process (its check of the modules loaded then covers the caller's)."""
    import torch.multiprocessing as mp

    dev = resolve_device(cfg.device)
    if cfg.backend == "nccl" and cfg.num_processes > torch.cuda.device_count():
        raise ValueError(
            f"dist_runner: NCCL takes one CUDA device a rank: {cfg.num_processes} ranks, "
            f"{torch.cuda.device_count()} devices; use --backend gloo or fewer --num-processes"
        )
    if cfg.mode == "composed" and cfg.sequences % cfg.num_processes:
        raise ValueError(f"dist_runner: {cfg.sequences} sequences do not split evenly over {cfg.num_processes} ranks")
    widths = ("bench", "tiny") if cfg.mode == "composed" else ("runner", "bench")
    if cfg.mode != "solve" and cfg.widths not in widths:
        raise ValueError(f"dist_runner: --mode {cfg.mode} takes --widths {' or '.join(widths)}, not {cfg.widths}")
    if dev.type == "cuda" and (cfg.mode == "composed" or cfg.mode == "pipeline" and cfg.feed == "frontend"):
        from liwslam_torch.ops import _build

        _build.load()
    with tempfile.TemporaryDirectory() as tmp:
        if cfg.num_processes == 1:
            _worker(0, cfg, tmp)  # a world of one runs in this process
        else:
            mp.spawn(_worker, args=(cfg, tmp), nprocs=cfg.num_processes, join=True)
        with open(os.path.join(tmp, "verdict.json")) as fh:
            return json.load(fh)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=("solve", "pipeline", "composed"), default="solve")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None, help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--nodes", type=int, default=64)
    ap.add_argument("--edges", type=int, default=128)
    ap.add_argument("--feed", choices=("frontend", "synthetic"), default="frontend")
    ap.add_argument("--widths", choices=("runner", "bench", "tiny"), default=None,
                    help="pipeline: runner (default) or bench; composed: bench (default) or tiny")
    ap.add_argument("--sequences", type=int, default=0, help="composed: B sequences (default 8 a rank)")
    ap.add_argument("--frames", type=int, default=32, help="composed: F frames in the chunk")
    a = ap.parse_args(argv)
    backend = a.backend or ("nccl" if a.device == "cuda" else "gloo")
    widths = a.widths or ("bench" if a.mode == "composed" else "runner")
    cfg = RunConfig(
        mode=a.mode, num_processes=a.num_processes, device=a.device, backend=backend, nodes=a.nodes,
        edges=a.edges, feed=a.feed, widths=widths, sequences=a.sequences, frames=a.frames,
    )
    v = launch(cfg)
    for k in ("p_multi", "gathered_p", "gathered_q"):
        v.pop(k, None)
    print(json.dumps(v), flush=True)
    return 0 if v["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
