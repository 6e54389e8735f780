"""The measured window: the replay's closed loop.

It drives ``Program.run`` (the port's batched chunk function) on inputs
that are resident on the card, copies every chunk's poses to the host,
keeps the check's sample (``check.Plan``), and can trace a chunk with the
profiler (``trace.Tracer``).  Nothing in it compiles or allocates a new
shape: set-up has run the same call.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from benchmark.harness import check


@dataclass
class WindowResult:
    seconds: float  # the window's length on the host clock
    frames: int  # sequence-frames with their pose on the host
    attempted: int  # sequence-frames due in the window
    failed: int  # of those: a non-finite pose
    nonfinite: int  # sequence-frames whose pose is not finite
    samples: list = field(default_factory=list)  # check.Sample
    steps: int = 0  # batched steps run in the window
    chunk_s: list = field(default_factory=list)  # each chunk's seconds, its poses on the host


def _sync(t: torch.Tensor):
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _nonfinite(out) -> int:
    p, q = out.p.cpu(), out.q.cpu()
    ok = torch.isfinite(p).all(-1) & torch.isfinite(q).all(-1)
    return int((~ok).sum())


def replay(prog, states0, inputs: dict, chunk: int, seconds: float, plan: check.Plan, tracer=None):
    """Chunks of ``chunk`` frames back to back from ``states0``; when every
    sequence has stepped its last frame, the next pass starts again from
    ``states0``.  The window closes at the first chunk boundary past
    ``seconds`` (and, when traced, past the traced chunk).  The tracer, if
    any, records the window's second chunk."""
    n_chunks = inputs["dt_us"].shape[1] // chunk
    B = inputs["dt_us"].shape[0]
    idx = torch.as_tensor(plan.seqs, device=inputs["dt_us"].device)
    states, c, j = states0, 0, 0
    res = WindowResult(0.0, 0, 0, 0, 0)
    kept = None
    _sync(inputs["dt_us"])
    t0 = t_prev = time.perf_counter()
    while True:
        sl = slice(c * chunk, (c + 1) * chunk)
        keep = j <= plan.chunk
        if keep:
            before = check.take(states, idx)
        if tracer is not None and j == 1:
            tracer.start()
        states, out = prog.run(states, prog.frame_input(inputs, sl))
        bad = _nonfinite(out)  # the poses on the host
        if tracer is not None and j == 1:
            tracer.stop(steps=chunk)
        t_now = time.perf_counter()
        res.chunk_s.append(t_now - t_prev)
        t_prev = t_now
        if keep:
            kept = check.Sample(plan.seqs, sl, before, check.take(out, idx), check.take(states, idx))
        res.frames += B * chunk
        res.nonfinite += bad
        res.steps += chunk
        j += 1
        c += 1
        if c == n_chunks:
            states, c = states0, 0
        if t_now - t0 >= seconds and (tracer is None or j >= 2):
            break
    res.seconds = t_now - t0
    res.attempted = res.frames
    res.failed = res.nonfinite
    res.samples = [kept]
    return res
