"""The port's front end against the reference's on the bench track.

    python3 tools/parity_frontend.py [--steps] [--port-cpu] [--load chiprun_out/bench_frontend.npz]
    python3 tools/parity_frontend.py --card-steps    # on the GPU, the port alone

Runs the reference front end (``liwslam.frontend.driver.Frontend``, JAX on
the CPU, its CPU defaults: the XLA extraction chain and the Cholesky LM)
on chip_smoke.py's bench track (``bench_params`` / ``bench_streams``: the
office loop track, 1080 beams, noise on, seed 1) and prints its ATE over
exactly the frames ``chip_smoke.tracked_ate`` uses (every frame after the
init window).

``--port-cpu`` also runs the port's ``Frontend(device="cpu")`` (the
kernels' plain versions) on the same streams; ``--load`` reads the port's
result from the card (``tools/parity_backend.py --save``).  For each, it
prints the port's ATE over the same frames and where the two
trajectories part: |dp| per frame at its quantiles, and the first frame
whose gap passes 1e-4, 1e-3 and 3e-3 m.

``--steps`` steps the reference frame by frame (its jitted
``pipeline.tracking_step``) and, before each frame, carries the
reference's state into the port (``liwslam_torch.convert``) and runs one
port step on it, as tests/test_torch_pipeline.py does: one frame's gap
with no history behind it.  It prints the frames where one step parts
most, with their line and match counts, so that a fault in one stage of
the step shows as a frame, not as drift.

``--card-steps`` needs the GPU and runs the port alone (no JAX): the
port's front end steps on the card and, before each tracked frame, the
card's state is copied to the CPU and one CPU step (the kernels' plain
versions) runs on it.  It prints how often the two steps' line counts,
line endpoints, match counts and poses part, and the frames where they
part most: a systematic difference between the card and the CPU shows as
a stage that parts on many frames.

Like the tests, the other modes run the reference package beside the
port; the port itself imports neither JAX nor the reference.
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

THRESHOLDS = (1e-4, 1e-3, 3e-3)


def _ate(t_us, p, q, streams, n_init):
    """ATE (m, aligned) of the frames after the init window, as
    chip_smoke.tracked_ate computes it."""
    import torch

    from liwslam_torch.core import geometry as geo
    from liwslam_torch.eval import metrics

    t_us, p, q = t_us[n_init:], p[n_init:], q[n_init:]
    pairs = metrics.associate_by_time(t_us, streams.gt_t_us)
    assert len(pairs) == len(t_us), "frames without ground truth"
    est = geo.make_tf(torch.as_tensor(p, dtype=torch.float32), torch.as_tensor(q, dtype=torch.float32)).numpy()
    return float(metrics.ate_rmse(est[pairs[:, 0]], streams.gt_T_w_imu[pairs[:, 1]], align=True))


def _parting(name, ref, t_us, p):
    """Per-frame |dp| between the reference's trajectory and another on
    their common stamps."""
    common, ia, ib = np.intersect1d(ref["t_us"], t_us, return_indices=True)
    gap = np.linalg.norm(ref["p"][ia] - p[ib], axis=1)
    first = {
        f"{thr:g}": (int(np.flatnonzero(gap > thr)[0]) if np.any(gap > thr) else None) for thr in THRESHOLDS
    }
    out = dict(
        common_frames=len(common),
        gap_m={k: float(v) for k, v in zip(("median", "p90", "max"), np.quantile(gap, [0.5, 0.9, 1.0]))},
        first_frame_past=first,
    )
    print(f"{name} vs reference: {json.dumps(out)}", flush=True)
    return gap


def run_reference(jprm, streams, chunk_size=64):
    from liwslam.frontend.driver import Frontend as JFrontend

    t0 = time.perf_counter()
    res = JFrontend(jprm).run(streams, chunk_size=chunk_size)
    wall = time.perf_counter() - t0
    return dict(t_us=np.asarray(res.t_us), p=np.asarray(res.p), q=np.asarray(res.q)), wall


def run_steps(jprm, tprm, streams):
    """Reference steps one frame at a time; before each, one port step from
    the reference's state."""
    import jax
    import jax.numpy as jnp
    import torch

    from liwslam.frontend import pipeline as jpl
    from liwslam.frontend.driver import Frontend as JFrontend
    from liwslam_torch import convert
    from liwslam_torch.frontend import pipeline as tpl
    from liwslam_torch.frontend.driver import Frontend as TFrontend

    jfe = JFrontend(jprm)
    frames, lt = jfe.pack_frames(streams)
    jstate, k0, _, _, _ = jfe.initialize(frames, lt)
    jstep = jax.jit(lambda s, i: jpl.tracking_step(s, i, jfe.consts, jfe.dcfg, jfe.scfg))
    jstate = jax.tree_util.tree_map(jnp.asarray, jstate)
    tfe = TFrontend(tprm, device="cpu")
    rows = []
    for k in range(k0, len(frames)):
        state = convert.track_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
        inp = convert.frame_input_from_numpy(frames[k], "cpu")
        with torch.no_grad():
            _, out = tpl.tracking_step(state, inp, tfe.consts, tfe.dcfg, tfe.scfg)
        jstate, ref = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, frames[k]))
        rows.append((
            k - k0, float(np.linalg.norm(out.p.numpy() - np.asarray(ref.p))),
            int(out.n_lines), int(ref.n_lines), int(out.n_match), int(ref.n_match),
        ))
    gap = np.array([r[1] for r in rows])
    print(
        f"steps from the reference's state: {len(rows)} frames, one-step |dp| median {np.median(gap):.3e} "
        f"p90 {np.quantile(gap, 0.9):.3e} max {gap.max():.3e}; lines differ on "
        f"{sum(r[2] != r[3] for r in rows)}, matches on {sum(r[4] != r[5] for r in rows)}",
        flush=True,
    )
    for r in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  tracked frame {r[0]}: |dp| {r[1]:.3e}, lines port {r[2]} ref {r[3]}, matches port {r[4]} ref {r[5]}")
    return rows


def card_steps(tprm, streams):
    """The port on the card; one CPU step from the card's state before each
    tracked frame."""
    import torch
    from torch.utils._pytree import tree_map

    from liwslam_torch.frontend import pipeline as tpl
    from liwslam_torch.frontend.driver import Frontend as TFrontend, to_device

    fe, fc = TFrontend(tprm, device="cuda"), TFrontend(tprm, device="cpu")
    frames, lt = fe.pack_frames(streams)
    state, k0, _, _, _ = fe.initialize(frames, lt)
    rows = []
    for k in range(k0, len(frames)):
        cpu_state = tree_map(lambda t: t.cpu(), state)
        state, out = tpl.tracking_step(state, to_device(frames[k], "cuda"), fe.consts, fe.dcfg, fe.scfg)
        _, oc = tpl.tracking_step(cpu_state, to_device(frames[k], "cpu"), fc.consts, fc.dcfg, fc.scfg)
        og = tpl.FrameOutput(*[t.cpu() for t in out])
        same_lines = bool(torch.equal(og.scan_line_valid, oc.scan_line_valid))
        line_err = float((og.scan_p1 - oc.scan_p1).abs().max().max((og.scan_p2 - oc.scan_p2).abs().max())) if same_lines else float("nan")
        rows.append((
            k - k0, float(torch.linalg.norm(og.p - oc.p)), int(og.n_lines), int(oc.n_lines), line_err,
            int(og.n_match), int(oc.n_match),
        ))
    gap = np.array([r[1] for r in rows])
    le = np.array([r[4] for r in rows])
    print(
        f"card steps vs CPU steps from the card's state: {len(rows)} frames, one-step |dp| median "
        f"{np.median(gap):.3e} p90 {np.quantile(gap, 0.9):.3e} max {gap.max():.3e}; line counts differ on "
        f"{sum(r[2] != r[3] for r in rows)}, line sets on {int(np.isnan(le).sum())}, endpoints (same sets) max "
        f"{np.nanmax(le):.3e} median {np.nanmedian(le):.3e}; match counts differ on {sum(r[5] != r[6] for r in rows)} "
        f"(card more on {sum(r[5] > r[6] for r in rows)})",
        flush=True,
    )
    for r in sorted(rows, key=lambda r: -r[1])[:8]:
        print(
            f"  tracked frame {r[0]}: |dp| {r[1]:.3e}, lines card {r[2]} cpu {r[3]} (endpoints {r[4]:.2e}), "
            f"matches card {r[5]} cpu {r[6]}",
            flush=True,
        )
    return rows


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--load", help="the port's front-end result from the card (tools/parity_backend.py --save)")
    ap.add_argument("--port-cpu", action="store_true", help="also run the port's front end on the CPU")
    ap.add_argument("--steps", action="store_true", help="one port step from the reference's state at every frame")
    ap.add_argument("--card-steps", action="store_true", help="on the GPU: card steps against CPU steps (no JAX)")
    ap.add_argument("--seed", type=int, default=1, help="the track's noise seed (the bench track is seed 1)")
    args = ap.parse_args(argv)
    import chip_smoke as cs

    if args.card_steps:
        import torch

        torch.set_num_threads(4)
        card_steps(cs.bench_params(), cs.bench_streams(cs.bench_params(), seed=args.seed))
        return 0

    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from liwslam import config as jconfig
    from liwslam_torch import config as tconfig
    from liwslam_torch import convert

    torch.set_num_threads(4)
    jprm = jconfig.office().replace(**tconfig.BENCH_WIDTHS)
    tprm = convert.params_from_reference(dataclasses.asdict(jprm))
    assert tprm == cs.bench_params(), "the reference's bench parameters differ from the port's"
    streams = cs.bench_streams(tprm, seed=args.seed)
    # every run reports its init window (slide_window_size frames) first
    n_init = jprm.slide_window_size
    ref, wall = run_reference(jprm, streams)
    ate = _ate(ref["t_us"], ref["p"], ref["q"], streams, n_init)
    print(
        f"reference front end (CPU): frames={len(ref['t_us'])} init_window={n_init} "
        f"tracked={len(ref['t_us']) - n_init} ATE={ate:.6f}m wall={wall:.1f}s",
        flush=True,
    )
    if args.port_cpu:
        from liwslam_torch.frontend.driver import Frontend as TFrontend

        t0 = time.perf_counter()
        res = TFrontend(tprm, device="cpu").run(streams, chunk_size=64)
        print(
            f"port front end (CPU): tracked={len(res.t_us) - n_init} "
            f"ATE={_ate(res.t_us, res.p, res.q, streams, n_init):.6f}m "
            f"wall={time.perf_counter() - t0:.1f}s",
            flush=True,
        )
        _parting("port (CPU)", ref, res.t_us, res.p)
    if args.load:
        z = dict(np.load(args.load))
        print(f"port front end (card, saved): ATE={_ate(z['t_us'], z['p'], z['q'], streams, n_init):.6f}m", flush=True)
        _parting("port (card, saved)", ref, z["t_us"], z["p"])
    if args.steps:
        run_steps(jprm, tprm, streams)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
