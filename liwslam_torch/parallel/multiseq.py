"""Batched multi-sequence front ends: B sequences in one tracking step.

Port of ``liwslam/parallel/multiseq.py``.  SLAM is sequential within a
stream (each frame depends on the previous state), so the throughput lever
is many streams at once: ``torch.func.vmap`` of the per-frame
``pipeline.tracking_step`` over a leading sequence dim.

One batched step launches about as many kernels as one sequence's step:
every elementwise and linear-algebra op runs once on (B, ...) tensors, and
the two kernels of the step are operators whose vmap rules fold the
sequences into their own batch grids (``ops/extract.extract_lines_batched``:
one block a scan; ``ops/track_solve.lm_solve_track_batched``: one block a
system), so B2 and B1 each launch once a frame for all B.  The laser path
only, as the reference's; each sequence's init window is its own host
solve (``frontend.driver.Frontend.init_sequences`` packs, initializes and
stacks B sequences).

Over several cards the sequences split as the reference's ``"dp"`` mesh
axis splits them: a ``torch.distributed`` process group of W ranks, one
card a rank (NCCL), or several ranks on one card (gloo).  Rank r steps the
contiguous slice r of the B sequences (:func:`shard_sequences`, B a
multiple of W, the reference's ``NamedSharding`` condition) with the same
vmapped step; the step has no collective, and :func:`gather_outputs`
brings the slices' poses back together in one ``all_gather``.  The step is
batch-invariant (``geo.matmul``, ``gn.beside_identity``, sums as the last
row of a cumsum), so sequence b's poses do not depend on W.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map

from liwslam_torch.frontend import pipeline as pl


def batched_chunk_fn(consts, dcfg, scfg, group=None):
    """``run(states, inputs) -> (states, outputs)`` over a leading sequence
    dim: states (B, ...) ``TrackState``, inputs (B, F, ...) ``FrameInput``,
    outputs (B, F, ...) ``FrameOutput``.

    With a process ``group`` of W ranks it returns ``(run, shard)``, as the
    reference returns ``(run, shard_batch)`` for a mesh: ``shard`` gives
    this rank its slice of B sequences (:func:`shard_sequences`; raises
    unless W divides B) and ``run`` steps that slice."""
    step = torch.func.vmap(lambda st, inp: pl.tracking_step(st, inp, consts, dcfg, scfg))

    def run(states, inputs):
        outs = []
        for i in range(inputs.dt_us.shape[1]):
            states, out = step(states, pl.FrameInput(*[t[:, i] for t in inputs]))
            outs.append(out)
        return states, pl.FrameOutput(*[torch.stack(f, 1) for f in zip(*outs)])

    if group is None:
        return run
    return run, lambda tree: shard_sequences(tree, group)


def shard_sequences(seqs, group):
    """This rank's contiguous slice of B sequences: of a tree of tensors
    with a leading sequence dim (a stacked ``TrackState``,
    ``Frontend.stack_sequences``' (B, F, ...) inputs) or of a list (seeds,
    streams).  Raises ``ValueError`` unless the group's W ranks divide B."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    leaves = [seqs] if isinstance(seqs, list) else tree_leaves(seqs)
    B = len(leaves[0])
    if B % world or any(len(t) != B for t in leaves):
        raise ValueError(
            f"multiseq: {B} sequences do not split evenly over {world} ranks "
            "(B must be a multiple of the process group's size, as the reference's NamedSharding needs)"
        )
    sl = slice(rank * (B // world), (rank + 1) * (B // world))
    return seqs[sl] if isinstance(seqs, list) else tree_map(lambda t: t[sl], seqs)


def gather_outputs(out, group, fields=("p", "q")):
    """The ``fields`` of every rank's (B/W, F, ...) ``FrameOutput`` slice in
    sequence order, {name: (B, F, ...)}, on every rank: one ``all_gather``
    of the fields side by side (float fields of one dtype)."""
    parts = [getattr(out, f) for f in fields]
    widths = [t.shape[-1] for t in parts]
    local = torch.cat(parts, -1).contiguous()
    bufs = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(bufs, local, group=group)
    return dict(zip(fields, torch.cat(bufs).split(widths, -1)))


def replicate_track_states(state, n):
    """Tile one TrackState into a batch of n identical sequence states."""
    return tree_map(lambda x: x[None].expand(n, *x.shape).clone(), state)


def stack_track_states(states):
    """Stack B TrackStates (one per sequence) along a new leading dim."""
    return tree_map(lambda *xs: torch.stack(xs), *states)
