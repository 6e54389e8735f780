"""What decides ``correct``: the program's answers held against the plain
reference (``benchmark/reference``), run on the CPU once the window has
closed.

The timed path's answers are sampled from the seed while the window runs
(:class:`Plan`): some sequences, stratified over blocks of the batch, at
one chunk of the replay.  For the sample the window keeps the program's state before it, its outputs and
its state after it.  The reference then

- solves the sampled tracks' init windows again from the same noisy frames
  and compares the window's optimized poses;
- steps each sampled sequence from the program's own state over the same
  inputs, following the program's answer from frame to frame (so one
  frame's rounding is never amplified over the next ones), and compares
  every frame's answer: pose, velocity and biases (also as the gap in the
  reference's own posterior standard deviations), the scan's lines and the
  keyframe's corners placed in the world, the matches;
- compares the state the program leaves after the sample: its reference
  submap placed in the world and the information of its marginalization
  prior.

Every number has a limit in ``limits/<cell>.json``; the run is correct when
every frame's pose is finite and every number is within its limit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

# ------------------------------------------------------------- sampling ----


@dataclass
class Plan:
    """Where the window keeps its sample: ``seqs`` (sequence indices, one
    from each of K equal blocks of the batch) at ``chunk`` (the replay's
    chunk ordinal); ``tracks``: the tracks whose init windows are
    checked."""

    seqs: list
    tracks: list
    chunk: int = 0


def make_plan(rng: np.random.Generator, B: int, S: int, spec: dict) -> Plan:
    """The samples of one run, drawn by ``rng``: ``spec["sequences"]``
    sequences, ``spec["inits"]`` tracks' init windows, and the replay's
    chunk (from 0 to ``spec["chunk_max"]``)."""
    K = min(spec["sequences"], B)
    edges = np.linspace(0, B, K + 1).astype(int)
    seqs = sorted(int(rng.integers(a, b)) for a, b in zip(edges[:-1], edges[1:]))
    tracks = sorted(int(t) for t in rng.choice(S, size=min(spec["inits"], S), replace=False))
    return Plan(seqs=seqs, tracks=tracks, chunk=int(rng.integers(0, spec["chunk_max"] + 1)))


def take(tree, idx: torch.Tensor):
    """Rows ``idx`` of every leaf (a copy)."""
    return tree_map(lambda x: x.index_select(0, idx), tree)


@dataclass
class Sample:
    """One kept sample: sequence indices, the program's state before, its
    (K, F, ...) outputs, its state after, and the frames' slice."""

    seqs: list
    frames: slice
    before: object
    outs: object
    after: object


# --------------------------------------------------------- conversions ----


def to_ref(tree, template):
    """A program tree (NamedTuples of tensors) as the reference's types,
    matched field by field by name, leaves on the CPU."""
    if hasattr(template, "_fields"):
        return type(template)(*[to_ref(getattr(tree, f), getattr(template, f)) for f in template._fields])
    return tree.detach().cpu()


def row(tree, i):
    return tree_map(lambda x: x[i], tree)


# --------------------------------------------------------------- numbers ----


def so3_gap(q_a, q_b, geo):
    """|log(R_b^T R_a)| for so3 vectors."""
    Ra, Rb = geo.exp_so3(q_a.double()), geo.exp_so3(q_b.double())
    return geo.log_SO3(Rb.transpose(-1, -2) @ Ra)


def greedy_gap(a: np.ndarray, b: np.ndarray, tol: float):
    """Greedy one-to-one alignment of rows of ``a`` to rows of ``b`` (each a
    point or a line's two endpoints, either orientation for lines): the
    largest gap among pairs within ``tol``, and how many rows of either side
    found no partner."""
    if len(a) == 0 or len(b) == 0:
        return 0.0, len(a) + len(b)
    if a.shape[1] == 4:
        d1 = np.maximum(
            np.linalg.norm(a[:, None, :2] - b[None, :, :2], axis=-1),
            np.linalg.norm(a[:, None, 2:] - b[None, :, 2:], axis=-1),
        )
        d2 = np.maximum(
            np.linalg.norm(a[:, None, :2] - b[None, :, 2:], axis=-1),
            np.linalg.norm(a[:, None, 2:] - b[None, :, :2], axis=-1),
        )
        d = np.minimum(d1, d2)
    else:
        d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    pairs = sorted((d[i, j], i, j) for i, j in zip(*np.nonzero(d <= tol)))
    used_a, used_b, worst = set(), set(), 0.0
    for g, i, j in pairs:
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        worst = max(worst, float(g))
    return worst, (len(a) - len(used_a)) + (len(b) - len(used_b))


def lines_world(p1, p2, valid, T):
    """Valid lines (laser frame) placed by the 4x4 ``T``: (n,4) xy xy."""
    p1, p2, valid, T = (np.asarray(x, np.float64) for x in (p1, p2, valid, T))
    v = valid.astype(bool)
    a = p1[v] @ T[:3, :3].T + T[:3, 3]
    b = p2[v] @ T[:3, :3].T + T[:3, 3]
    return np.concatenate([a[:, :2], b[:, :2]], 1)


def submap_world(sub, geo, T_il):
    """A reference submap's valid lines in the world: (n,4)."""
    T = (geo.make_tf(sub.pose_p.double(), sub.pose_q.double()) @ T_il.double()).numpy()
    return lines_world(sub.p1.numpy(), sub.p2.numpy(), sub.valid.numpy(), T)


class Numbers:
    """The compared numbers of one run.  A frame's (or a state's) numbers
    are kept as lists and read as their maximum, their median
    (``<name>.p50``), their 90th percentile (``<name>.p90``: a fault on a
    minority of the frames, which no sequence's median sees) and, by
    sampled sequence, the largest of the sequences' medians
    (``<name>.seqmed``);
    shares are kept as sums of their numerator and denominator."""

    def __init__(self):
        self.lists = {}
        self.sums = {}
        self.groups = {}
        self.group = None  # the sampled sequence the numbers being added belong to

    def add(self, name, x):
        x = float(x)
        x = math.inf if math.isnan(x) else x
        self.lists.setdefault(name, []).append(x)
        if self.group is not None:
            self.groups.setdefault(name, {}).setdefault(self.group, []).append(x)

    def share(self, name, num, den):
        n, d = self.sums.get(name, (0.0, 0.0))
        self.sums[name] = (n + float(num), d + float(den))

    def merge(self, other: "Numbers"):
        for name, xs in other.lists.items():
            self.lists.setdefault(name, []).extend(xs)
        for name, by in other.groups.items():
            for g, xs in by.items():
                self.groups.setdefault(name, {}).setdefault(g, []).extend(xs)
        for name, (n, d) in other.sums.items():
            self.share(name, n, d)

    def summary(self) -> dict:
        out = {}
        for name, xs in self.lists.items():
            out[name] = max(xs)
            if len(xs) > 1:
                out[name + ".p50"] = float(np.percentile(xs, 50))
                out[name + ".p90"] = float(np.percentile(xs, 90))
        for name, by in self.groups.items():
            out[name + ".seqmed"] = max(float(np.median(xs)) for xs in by.values())
        for name, (n, d) in self.sums.items():
            out[name] = n / d if d > 0 else 0.0
        return out


# ---------------------------------------------------------- the check ----


class Reference:
    """The plain reference at a configuration's parameters, on the CPU."""

    def __init__(self, cfg: dict):
        from benchmark.reference import factors, geometry, init, params, step

        self.rs, self.ri, self.geo = step, init, geometry
        self.prm = params.RefParams(cfg["params"])
        self.consts = factors.make_consts(self.prm)
        self.scfg = step.make_static_cfg(self.prm)
        self.dcfg = step.make_dyn_cfg(self.prm)
        z3 = torch.zeros(3)
        self.template = step.init_track_state(z3, z3, z3, torch.zeros(6), self.scfg)
        self.T_il = self.consts.T_imu_to_laser

    def check_init(self, nums: Numbers, frames: dict, prog_first: int, prog_p, prog_q, control=None):
        """The init window on the same noisy frames; with ``control`` (a
        Numbers) the control's init window is held against the reference's
        too."""
        from benchmark.harness import fleet
        from benchmark.reference import prec

        fl = fleet.frame_list(frames, self.rs.FrameInput)
        res = self.ri.initialize(fl, self.prm, self.consts, self.dcfg, self.scfg)
        self._compare_init(nums, prog_first, prog_p, prog_q, res)
        if control is not None:
            with prec.tf32_products():
                res_c = self.ri.initialize(fl, self.prm, self.consts, self.dcfg, self.scfg)
            self._compare_init(control, res_c.first, res_c.window.p, res_c.window.q, res)

    def _compare_init(self, nums, first, p, q, res):
        nums.add("init_first_apart", abs(res.first - first))
        if res.first == first:
            nums.add("init_p_gap_m", torch.linalg.norm(res.window.p.double() - p.cpu().double(), dim=-1).max())
            nums.add("init_q_gap_rad", torch.linalg.norm(so3_gap(q.cpu(), res.window.q, self.geo), dim=-1).max())

    def check_chain(self, nums: Numbers, job: "ChainJob", control=None):
        """Step one sequence over the job's frames from the program's state
        before them, following the program's answers, and compare; with
        ``control`` (a Numbers) the control, stepped alike beside the
        reference, is held against the reference too."""
        from benchmark.reference import prec

        nums.group = job.seq
        if control is not None:
            control.group = job.seq
        state = state_c = job.before
        for f in range(job.outs.p.shape[0]):
            inp = self.rs.FrameInput(*[t[f] for t in job.inputs])
            o = row(job.outs, f)
            follow = self.rs.Follow(p=o.p, q=o.q, v=o.v, bs=o.bs, is_keyframe=o.is_keyframe)
            with torch.no_grad():
                state_next, r, det = self.rs.tracking_step(state, inp, self.consts, self.dcfg, self.scfg, follow)
            self._compare_frame(nums, o, r, det)
            if control is not None:
                with torch.no_grad(), prec.tf32_products():
                    state_c, rc, _ = self.rs.tracking_step(state_c, inp, self.consts, self.dcfg, self.scfg, follow)
                self._compare_frame(control, rc, r, det)
            state = state_next
        self._compare_state(nums, job.after, state)
        if control is not None:
            self._compare_state(control, state_c, state)

    def _compare_frame(self, nums, o, r, det):
        """Frame answer ``o`` (the program's, or the control's) against the
        reference's ``r``."""
        geo = self.geo
        dq = so3_gap(o.q, r.q, geo)
        delta = torch.cat([(o.p - r.p).double(), dq, (o.v - r.v).double(), (o.bs - r.bs).double()])
        H = 0.5 * (det.info + det.info.T).double()
        nums.add("step_sigma", torch.sqrt(torch.clamp(delta @ H @ delta, min=0.0)))
        nums.add("step_p_gap_m", torch.linalg.norm(o.p.double() - r.p.double()))
        nums.add("step_q_gap_rad", torch.linalg.norm(dq))
        nums.add("step_v_gap_mps", torch.linalg.norm(o.v.double() - r.v.double()))
        nums.add("step_bias_gap", (o.bs.double() - r.bs.double()).abs().max())
        nums.share("matches_apart", (o.n_match - r.n_match).abs(), r.n_match)
        nums.share("kf_flags_apart", bool(o.is_keyframe) != bool(r.is_keyframe), 1)
        To = (geo.make_tf(o.p.double(), o.q.double()) @ self.T_il.double()).numpy()
        Tr = (geo.make_tf(r.p.double(), r.q.double()) @ self.T_il.double()).numpy()
        lo = lines_world(o.scan_p1, o.scan_p2, o.scan_line_valid, To)
        lr = lines_world(r.scan_p1, r.scan_p2, r.scan_line_valid, Tr)
        gap, miss = greedy_gap(lo, lr, 0.02)
        nums.add("scan_lines_world_gap_m", gap)
        nums.share("scan_lines_unmatched", miss, len(lo) + len(lr))
        if bool(o.is_keyframe) and bool(r.is_keyframe):
            co = o.kf_corners[o.kf_corner_valid].double().numpy()
            cr = r.kf_corners[r.kf_corner_valid].double().numpy()
            gap, miss = greedy_gap(co, cr, 0.05)
            nums.add("kf_corners_gap_m", gap)
            nums.share("kf_corners_unmatched", miss, len(co) + len(cr))
        nums.add("cost_gap", (o.solve_cost.double() - r.solve_cost.double()).abs() / r.solve_cost.double())

    def _compare_state(self, nums, prog, ref):
        """The state ``prog`` leaves after a sample against the reference's."""
        geo = self.geo
        nums.add("window_state_apart", sum(
            int(not torch.equal(getattr(prog.win, k)[-1], getattr(ref.win, k)[-1])) for k in ("p", "q", "v", "bs")))
        for name in ("ref", "spawning"):
            a = submap_world(getattr(prog.pair, name), geo, self.T_il)
            b = submap_world(getattr(ref.pair, name), geo, self.T_il)
            gap, miss = greedy_gap(a, b, 0.02)
            nums.add("submap_gap_m", gap)
            nums.share("submap_unmatched", miss, len(a) + len(b))
        Ho = prog.prior_J.double().T @ prog.prior_J.double()
        Hr = ref.prior_J.double().T @ ref.prior_J.double()
        nums.add("prior_info_gap", torch.linalg.norm(Ho - Hr) / torch.clamp(torch.linalg.norm(Hr), min=1e-30))


class InitJob(NamedTuple):
    """One track's init window: its noisy frames (numpy) and the program's
    first tracked frame and optimized window poses."""

    frames: dict
    first: int
    p: torch.Tensor
    q: torch.Tensor


class ChainJob(NamedTuple):
    """One sampled sequence, in the reference's types on the CPU: the
    program's state before the sample, its (F, ...) outputs, its state
    after, and the (F, ...) inputs."""

    before: object
    outs: object
    after: object
    inputs: object
    seq: int


def chain_jobs(ref: Reference, smp: Sample, inputs: dict) -> list:
    """A kept sample as one ChainJob a sequence; ``inputs`` holds the kept
    sequences' rows in ``smp.seqs``' order."""
    from benchmark.harness import fleet

    jobs = []
    for k, b in enumerate(smp.seqs):
        jobs.append(ChainJob(
            before=to_ref(row(smp.before, k), ref.template),
            outs=to_ref(row(smp.outs, k), ref.rs.FrameOutput(*ref.rs.FrameOutput._fields)),
            after=to_ref(row(smp.after, k), ref.template),
            inputs=ref.rs.FrameInput(*[inputs[n][b, smp.frames].detach().cpu() for n in fleet.FIELDS]),
            seq=b,
        ))
    return jobs


def run_job(cfg: dict, job, control: bool):
    """One job on this process's CPU: (Numbers, control Numbers or None)."""
    ref = Reference(cfg)
    nums, ctrl = Numbers(), (Numbers() if control else None)
    if isinstance(job, InitJob):
        ref.check_init(nums, job.frames, job.first, job.p, job.q, ctrl)
    else:
        ref.check_chain(nums, job, ctrl)
    return nums, ctrl


def _worker_init(root: str, threads: int):
    import sys

    if root not in sys.path:
        sys.path.insert(0, root)
    torch.set_num_threads(threads)


def run_jobs(cfg: dict, jobs: list, control: bool, workers: int):
    """Every job, in ``workers`` spawned processes on the CPU (in this one
    for ``workers`` <= 1), each pool closed and joined before it returns.
    Returns (Numbers, control Numbers or None)."""
    import multiprocessing as mp
    import os
    from concurrent.futures import ProcessPoolExecutor

    nums, ctrl = Numbers(), (Numbers() if control else None)
    if workers <= 1:
        outs = [run_job(cfg, j, control) for j in jobs]
    else:
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        threads = max(1, (os.cpu_count() or 2) // workers)
        with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn"), initializer=_worker_init,
                                 initargs=(root, threads)) as pool:
            futs = [pool.submit(run_job, cfg, j, control) for j in jobs]
            outs = [f.result() for f in futs]
    for n, c in outs:
        nums.merge(n)
        if control:
            ctrl.merge(c)
    return nums, ctrl


def verdict(nums: dict, limits: dict, nonfinite: int, missing: int):
    """(correct, checks): every compared number beside its limit, after the
    count of frames with a non-finite pose and of planned samples the
    window did not reach (limits 0).  A number with nothing to compare in
    this run (no keyframe in a sample) reads 0."""
    checks = {"nonfinite_frames": [nonfinite, 0], "samples_missing": [missing, 0]}
    ok = nonfinite == 0 and missing == 0
    for name, lim in limits.items():
        val = nums.get(name, 0.0)
        checks[name] = [val, lim]
        ok = ok and val <= lim
    return ok, checks
