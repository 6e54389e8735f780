"""B sequences in one batched tracking step (``liwslam_torch.parallel.
multiseq``) against each sequence's own single-stream step and against the
reference package's batched step.

Three sequences of the noisy L track from three seeds, the third cut
short, packed, initialized and stacked by the port's
``Frontend.init_sequences``; the reference steps from the same states
(carried across by field name).

(a) The port's batched step (``torch.func.vmap`` of ``tracking_step``) over
N_STEPS frames against each sequence's own ``run_chunk``: the same poses,
velocities, biases, counts and costs bit for bit on every frame (the step's
small products and decompositions are batch-invariant: ``geo.matmul``,
``gn.beside_identity``), and B1's plain version called once a step for all
three systems (the operator's vmap rule folds the sequences into its
batch).  (b) Against the reference's ``multiseq.batched_chunk_fn`` (no
mesh), the state carried across from the reference before every step, as
tests/test_torch_pipeline.py does: positions within 5e-3 m, line and match
counts within one.  (c) Identical sequences give identical outputs (the
reference's own check, tests/test_parallel.py:120-122).  Every batched run
raises on vmap's per-sample fallback.

(d) ``Frontend.init_sequences`` on the sequences of unequal length, and
(e) the FPS frame gate of ``Frontend.pack_frames`` against the reference's
on every sequence of a batch (tests/test_knobs.py:30-72)."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map

from liwslam import config as jconfig
from liwslam.frontend import matching as jmm
from liwslam.frontend import pipeline as jpl
from liwslam.frontend import preintegration as jpre
from liwslam.frontend.driver import Frontend as JFrontend
from liwslam.parallel import multiseq as jms
from liwslam.solve import factors as jfac
from liwslam_torch import convert
from liwslam_torch.core import geometry as geo
from liwslam_torch.frontend import pipeline as tpl
from liwslam_torch.frontend.driver import Frontend as TFrontend
from liwslam_torch.ops import track_solve
from liwslam_torch.parallel import multiseq
from liwslam_torch.sim import world as tsim
from liwslam_torch.solve import gn
from tests.test_frontend_e2e import small_params

SIM = dict(imu_hz=100, wheel_hz=20, laser_hz=5, n_beams=360, noise=True)
SEEDS = (1, 2, 3)
CUT = 7  # laser frames the third sequence lacks
N_STEPS = 2
# the reference's state classes, by name
_REF = {c.__name__: c for c in (jpl.TrackState, jfac.WindowState, jpre.ImuCarry, jpre.WheelCarry, jmm.SubmapPair, jmm.RefSubmap)}


def _to_reference(tree):
    """A state of the port (numpy leaves) as the reference's NamedTuples."""
    if hasattr(tree, "_fields"):
        return _REF[type(tree).__name__](*[_to_reference(v) for v in tree])
    return jnp.asarray(tree)


def _truncated(streams, n):
    """The stream with only its first n laser frames."""
    cut = lambda a: np.asarray(a)[:n]
    return dataclasses.replace(
        streams, laser_t_us=cut(streams.laser_t_us), laser_points=cut(streams.laser_points),
        laser_times_rel=cut(streams.laser_times_rel), laser_valid=cut(streams.laser_valid),
    )


@pytest.fixture(scope="session")
def batch():
    """Three sequences initialized and stacked by the port, their stacked
    states (numpy) and the first N_STEPS tracked frames of each as (B, F,
    ...)."""
    # both packages step from the port's init states, so a shorter init
    # solve serves as well as a converged one
    prm = small_params().replace(init_solver_max_iterations=8)
    fe = TFrontend(convert.params_from_reference(dataclasses.asdict(prm)), device="cpu")
    streams = [
        tsim.simulate(tsim.default_track("L"), tsim.square_room(obstacles=True), fe.params, seed=seed, **SIM)
        for seed in SEEDS
    ]
    streams[-1] = _truncated(streams[-1], len(streams[-1].laser_t_us) - CUT)
    seqs = fe.init_sequences(streams)
    st = tree_map(lambda t: t.numpy(), seqs.states)
    inp = tree_map(lambda t: t.numpy(), fe.stack_sequences(seqs, 0, N_STEPS))
    return JFrontend(prm), fe, seqs, st, inp


@pytest.fixture
def no_vmap_fallback():
    """vmap's per-sample fallback (a loop over the batch) raises."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def test_batched_step_matches_each_single_stream(batch, no_vmap_fallback, monkeypatch):
    _, fe, _, st, inp = batch
    states = convert.track_state_from_numpy(st, "cpu")
    inputs = convert.frame_input_from_numpy(inp, "cpu")
    systems = []
    plain = track_solve.lm_solve_track_plain

    def counted(inp_, **kw):
        systems.append(inp_.x0.shape[0])
        return plain(inp_, **kw)

    monkeypatch.setattr(track_solve, "lm_solve_track_plain", counted)
    _, out = multiseq.batched_chunk_fn(fe.consts, fe.dcfg, fe.scfg)(states, inputs)
    assert systems == [len(SEEDS)] * N_STEPS
    assert out.p.shape == (len(SEEDS), N_STEPS, 3) and out.is_keyframe.shape == (len(SEEDS), N_STEPS)
    for b in range(len(SEEDS)):
        one = convert.track_state_from_numpy(jax.tree_util.tree_map(lambda x: x[b], st), "cpu")
        _, ref = fe.run_chunk(one, tpl.FrameInput(*[t[b] for t in inputs]))
        # the same bits: every product and decomposition of the step is
        # batch-invariant (geo.matmul, gn.beside_identity)
        for name in ("p", "q", "v", "bs", "n_match", "n_lines", "is_keyframe", "solve_cost"):
            np.testing.assert_array_equal(getattr(out, name)[b].numpy(), getattr(ref, name).numpy(), err_msg=f"{name} {b}")


def test_small_products_are_batch_invariant():
    rng = np.random.default_rng(0)
    A = torch.as_tensor(rng.normal(size=(5, 15, 15)), dtype=torch.float32)
    B = torch.as_tensor(rng.normal(size=(5, 15, 15)), dtype=torch.float32)
    one = torch.stack([geo.matmul(a, b) for a, b in zip(A, B)])
    np.testing.assert_array_equal(torch.func.vmap(geo.matmul)(A, B).numpy(), one.numpy())
    np.testing.assert_array_equal(geo.matmul(A, B).numpy(), one.numpy())
    np.testing.assert_allclose(one.numpy(), (A.double() @ B.double()).numpy(), rtol=0, atol=1e-5)
    v = B[:, 0]
    np.testing.assert_array_equal(torch.func.vmap(geo.matvec)(A, v).numpy(), torch.stack([geo.matvec(a, x) for a, x in zip(A, v)]).numpy())
    # the decompositions see the same batched routine for one matrix as
    # for a batch: one identity beside each
    P = torch.as_tensor(np.eye(15) * 2.0, dtype=torch.float32)
    assert gn.beside_identity(P).shape == (2, 15, 15) and gn.beside_identity(A).shape == (5, 2, 15, 15)
    np.testing.assert_array_equal(gn.beside_identity(A)[:, 1].numpy(), np.broadcast_to(np.eye(15), (5, 15, 15)))


# products and decompositions of the library, by their torch function names
_PRODUCTS = {
    "matmul", "__matmul__", "__rmatmul__", "mm", "bmm", "mv", "dot", "vdot", "inner", "outer", "einsum",
    "tensordot", "addmm", "addmv", "addbmm", "baddbmm", "linalg_multi_dot", "chain_matmul", "linalg_vecdot",
}
_DECOMPOSITIONS = {
    "linalg_cholesky", "linalg_cholesky_ex", "cholesky", "linalg_eigh", "linalg_eigvalsh", "linalg_eig",
    "linalg_svd", "svd", "linalg_svdvals", "linalg_qr", "qr", "linalg_solve", "linalg_solve_ex", "linalg_inv",
    "linalg_inv_ex", "inverse", "linalg_lu_factor", "linalg_lu_factor_ex", "linalg_lstsq", "linalg_det",
    "linalg_solve_triangular", "cholesky_solve",
}


class _Calls(TorchFunctionMode):
    """Every torch function a region calls, with its arguments; an
    operator of the port (B1, B2) is one call, its inside not seen."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls.append((getattr(func, "__name__", str(func)), args))
        return func(*args, **(kwargs or {}))


def test_tracking_step_keeps_batch_invariant_forms(batch):
    """The forms that make a batched step equal each single-stream step
    on the card stay on the step's path: no library product (cuBLAS picks
    its kernel by the batch count; ``geo.matmul`` / ``geo.matvec`` instead)
    and no decomposition of a matrix without the identity beside it
    (cuSOLVER's routine for one matrix rounds otherwise than its batched
    one; ``gn.beside_identity``).  tools/probe_batch_invariance.py shows
    both on the card; this fails when a plain ``@`` or an unpaired
    decomposition comes back into ``tracking_step``."""
    _, fe, seqs, _, _ = batch
    state = tree_map(lambda t: t[0], seqs.states)
    frame = tpl.FrameInput(*[t[0, 0] for t in fe.stack_sequences(seqs, 0, 1)])
    with _Calls() as rec:
        tpl.tracking_step(state, frame, fe.consts, fe.dcfg, fe.scfg)
    names = [n for n, _ in rec.calls]
    assert "track_solve.default" in names and "extract_lines.default" in names
    assert not [n for n in names if n in _PRODUCTS]
    decomps = [(n, a[0]) for n, a in rec.calls if n in _DECOMPOSITIONS]
    assert {n for n, _ in decomps} == {"linalg_cholesky_ex", "linalg_solve_triangular", "linalg_eigh"}
    for n, A in decomps:
        eye = torch.eye(A.shape[-1], dtype=A.dtype).expand(A.shape[:-3] + A.shape[-2:])
        assert A.dim() >= 3 and A.shape[-3] == 2 and torch.equal(A[..., 1, :, :], eye), n


def test_batched_step_matches_reference_per_step(batch, no_vmap_fallback):
    jfe, fe, _, st, inp = batch
    jrun = jms.batched_chunk_fn(jfe.consts, jfe.dcfg, jfe.scfg)
    run = multiseq.batched_chunk_fn(fe.consts, fe.dcfg, fe.scfg)
    jstates = _to_reference(st)
    n_match = 0
    for i in range(N_STEPS):
        step_in = jax.tree_util.tree_map(lambda x: x[:, i : i + 1], inp)
        states = convert.track_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstates), "cpu")
        _, out = run(states, convert.frame_input_from_numpy(step_in, "cpu"))
        jstates, ref = jrun(jstates, jax.tree_util.tree_map(jnp.asarray, step_in))
        np.testing.assert_allclose(out.p.numpy(), np.asarray(ref.p), rtol=0, atol=5e-3, err_msg=f"frame {i}")
        assert np.abs(out.n_lines.numpy() - np.asarray(ref.n_lines)).max() <= 1, i
        assert np.abs(out.n_match.numpy() - np.asarray(ref.n_match)).max() <= 1, i
        n_match += int(np.asarray(ref.n_match).sum())
    assert n_match > 0


def test_identical_sequences_give_identical_outputs(batch, no_vmap_fallback):
    _, fe, _, st, inp = batch
    one = convert.track_state_from_numpy(jax.tree_util.tree_map(lambda x: x[0], st), "cpu")
    states = multiseq.replicate_track_states(one, 3)
    rep = jax.tree_util.tree_map(lambda x: np.broadcast_to(x[:1, :1], (3,) + x[:1, :1].shape[1:]).copy(), inp)
    _, out = multiseq.batched_chunk_fn(fe.consts, fe.dcfg, fe.scfg)(states, convert.frame_input_from_numpy(rep, "cpu"))
    assert np.isfinite(out.p.numpy()).all() and out.p.shape == (3, 1, 3)
    np.testing.assert_allclose(out.p[0].numpy(), out.p[-1].numpy(), rtol=0, atol=1e-5)


def test_init_sequences_stacks_sequences_of_unequal_length(batch):
    _, fe, seqs, st, inp = batch
    B = len(SEEDS)
    assert seqs.states.win.p.shape == (B, 2, 3) and seqs.states.pair.ref.p1.shape[0] == B
    lengths = [len(fr) - k0 for fr, k0 in zip(seqs.frames, seqs.first)]
    # the cut sequence sets the common prefix; each counts from its own
    # first tracked frame
    assert seqs.n_common == min(lengths) == lengths[-1] < lengths[0]
    assert [len(lt) for lt in seqs.stamps] == [len(fr) for fr in seqs.frames]
    assert inp.points.shape == (B, N_STEPS, fe.params.max_points, 3)
    for b in range(B):
        for j in range(N_STEPS):
            np.testing.assert_array_equal(inp.points[b, j], seqs.frames[b][seqs.first[b] + j].points)
            assert inp.dt_us[b, j] == seqs.frames[b][seqs.first[b] + j].dt_us


def _gate_streams(prm, seed):
    track = tsim.TwistTrack([(2.0, 0.0, 0.0, 0.0), (4.0, 0.3, 0.0, 0.0)])
    return tsim.simulate(track, tsim.square_room(size=10.0), prm, imu_hz=100, wheel_hz=20, laser_hz=10.0, n_beams=360, seed=seed)


@pytest.mark.parametrize("fps", [1000.0, 2.0, 0.5])
def test_frame_gate_matches_reference(fps):
    jprm = jconfig.office().replace(max_points=512, max_imu_per_frame=128, FPS=fps)
    tprm = convert.params_from_reference(dataclasses.asdict(jprm))
    for seed in SEEDS:  # every sequence of a batch goes through the gate
        streams = _gate_streams(tprm, seed)
        tf, tl = TFrontend(tprm, device="cpu").pack_frames(streams)
        jf, jl = JFrontend(jprm).pack_frames(streams)
        np.testing.assert_array_equal(tl, jl)
        assert len(tf) == len(jf) >= 1 and tl[0] == streams.laser_t_us[0]
        if fps == 2.0:
            assert len(tf) < 60 / 3 and np.all(np.diff(tl) >= 0.5e6)
        for a, b in zip(tf, jf):
            for name in a._fields:
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
