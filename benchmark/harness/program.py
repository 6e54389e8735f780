"""The system under test, as the benchmark drives it: ``liwslam_torch``'s
init window (``frontend.driver.Frontend.initialize``) and its batched
tracking step (``parallel.multiseq.batched_chunk_fn`` over
``frontend.pipeline.tracking_step``, with kernels B1 and B2 launched once a
step for all B sequences).  Everything the benchmark takes from the port
goes through this module."""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from benchmark.harness import fleet


class Program:
    """The port at a configuration's parameters on one device."""

    def __init__(self, cfg: dict, device):
        from liwslam_torch import config
        from liwslam_torch.frontend import pipeline as pl
        from liwslam_torch.frontend.driver import Frontend
        from liwslam_torch.parallel import multiseq

        self.pl = pl
        if pl.FrameInput._fields != fleet.FIELDS:
            raise RuntimeError(f"the port's FrameInput fields {pl.FrameInput._fields} are not {fleet.FIELDS}")
        self.params = config.Params.from_dict(cfg["params"])
        self.device = torch.device(device)
        self.frontend = Frontend(self.params, device=self.device)
        self.run = multiseq.batched_chunk_fn(self.frontend.consts, self.frontend.dcfg, self.frontend.scfg)

    def initialize(self, frames: dict):
        """Track s's init window on its noisy frames (numpy): (state, first
        tracked frame, the window's optimized p (W,3) and q (W,3))."""
        fl = fleet.frame_list(frames, self.pl.FrameInput)
        track, first, st, _, _ = self.frontend.initialize(fl, frames["stamps"])
        return track, first, st.p, st.q

    def frame_input(self, inputs: dict, sl):
        """The (B, F, ...) ``FrameInput`` of frames ``sl`` of every sequence."""
        return self.pl.FrameInput(*[inputs[k][:, sl] for k in fleet.FIELDS])

    @staticmethod
    def stack_states(states, B: int):
        """B states, sequence b's the state of track b mod S."""
        S = len(states)
        return tree_map(lambda *xs: torch.stack([xs[b % S] for b in range(B)]), *states)


class B1Recorder:
    """Keeps, for each launch of kernel B1 while it is open, its input bytes,
    its systems' laser-match capacity M and the LM iterations each system
    took (the kernel's own ``iters`` output, a device tensor read after the
    window): what B1's roofline counts its bytes and operations from.
    Wraps the port's launch function and restores it on close; where the
    port has no such function it records nothing."""

    def __init__(self):
        from liwslam_torch.ops import track_solve as ts

        self._ts = ts
        self._orig = getattr(ts, "_launch", None)
        self.launches = []
        if self._orig is None:
            return

        def launch(inp, *args):
            out = self._orig(inp, *args)
            nbytes = sum(t.numel() * t.element_size() for t in inp)
            self.launches.append((nbytes, int(inp.laser.shape[1]), out[4]))
            return out

        ts._launch = launch

    def close(self):
        if self._orig is not None:
            self._ts._launch = self._orig

    def read(self):
        """[(input bytes, M, iters (B,) numpy)] of every launch recorded."""
        return [(n, m, it.cpu().numpy()) for n, m, it in self.launches]
