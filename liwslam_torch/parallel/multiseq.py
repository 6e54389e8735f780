"""Batched multi-sequence front ends: B sequences in one tracking step.

Port of ``liwslam/parallel/multiseq.py``.  SLAM is sequential within a
stream (each frame depends on the previous state), so the throughput lever
is many streams at once: ``torch.func.vmap`` of the per-frame
``pipeline.tracking_step`` over a leading sequence dim.  The card is one
device, so the reference's ``mesh`` / ``shard_batch`` have no counterpart.

One batched step launches about as many kernels as one sequence's step:
every elementwise and linear-algebra op runs once on (B, ...) tensors, and
the two kernels of the step are operators whose vmap rules fold the
sequences into their own batch grids (``ops/extract.extract_lines_batched``:
one block a scan; ``ops/track_solve.lm_solve_track_batched``: one block a
system), so B2 and B1 each launch once a frame for all B.  The laser path
only, as the reference's; each sequence's init window is its own host
solve (``frontend.driver.Frontend.init_sequences`` packs, initializes and
stacks B sequences).
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from liwslam_torch.frontend import pipeline as pl


def batched_chunk_fn(consts, dcfg, scfg):
    """``run(states, inputs) -> (states, outputs)`` over a leading sequence
    dim: states (B, ...) ``TrackState``, inputs (B, F, ...) ``FrameInput``,
    outputs (B, F, ...) ``FrameOutput``."""
    step = torch.func.vmap(lambda st, inp: pl.tracking_step(st, inp, consts, dcfg, scfg))

    def run(states, inputs):
        outs = []
        for i in range(inputs.dt_us.shape[1]):
            states, out = step(states, pl.FrameInput(*[t[:, i] for t in inputs]))
            outs.append(out)
        return states, pl.FrameOutput(*[torch.stack(f, 1) for f in zip(*outs)])

    return run


def replicate_track_states(state, n):
    """Tile one TrackState into a batch of n identical sequence states."""
    return tree_map(lambda x: x[None].expand(n, *x.shape).clone(), state)


def stack_track_states(states):
    """Stack B TrackStates (one per sequence) along a new leading dim."""
    return tree_map(lambda *xs: torch.stack(xs), *states)
