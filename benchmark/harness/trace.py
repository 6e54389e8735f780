"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a few
steps of the window, reduced to plain lists that the per-layer readers
(``benchmark/metrics``) take their numbers from.

``Trace`` holds the device intervals (kernels and copies, by name), the
host's runtime calls (kernel launches, stream and device waits) and
operators, the traced steps, the traced window's seconds and the device's
busy seconds in it (the union of the device intervals: the port's
``chip_smoke._busy_s``), beside what the run knows of the cell (B, the
scan and line widths, kernel B1's launches, peak memory).
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

# host runtime calls that launch a kernel (the port's chip_smoke.LAUNCHES)
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")


@dataclass
class Trace:
    device: list = field(default_factory=list)  # (name, start_us, end_us)
    host: list = field(default_factory=list)  # (name, start_us, end_us)
    steps: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0
    cell: dict = field(default_factory=dict)  # B, N, L, b1 launches, window_peak_gib


def union_s(intervals) -> float:
    """Length of the union of (start_us, end_us) intervals, in seconds."""
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6


def gaps(intervals, lo_us, hi_us):
    """The idle gaps (start_us, end_us) between merged intervals within
    [lo_us, hi_us]."""
    out, cur = [], lo_us
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi_us)))
        cur = max(cur, b)
    if hi_us > cur:
        out.append((cur, hi_us))
    return [(a, b) for a, b in out if b > a]


class Tracer:
    """Profiles the window between :meth:`start` and :meth:`stop`; with
    ``record_b1`` also keeps kernel B1's launches meanwhile
    (``program.B1Recorder``), which its roofline counts from."""

    def __init__(self, record_b1: bool = False):
        self.prof = None
        self.trace = Trace()
        self.record_b1 = record_b1
        self.b1 = None

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        if self.record_b1:
            from benchmark.harness.program import B1Recorder

            self.b1 = B1Recorder()
        self._t0 = time.perf_counter()

    def stop(self, steps: int):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.trace.window_s = time.perf_counter() - self._t0
        if self.b1 is not None:
            self.b1.close()
        self.prof.__exit__(None, None, None)
        self.trace.steps = steps

    def read(self) -> Trace:
        """The profiled events as plain lists (after the window)."""
        tr = self.trace
        for e in self.prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if b > a:
                    tr.device.append((e.name, a, b))
            else:
                tr.host.append((e.name, a, b))
        tr.busy_s = union_s([(a, b) for _, a, b in tr.device])
        tr.cell["b1_launches"] = self.b1.read() if self.b1 is not None else []
        self.prof = None
        return tr


def breakdown(tr: Trace, n: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps'
    seconds by what the host was doing when each began (the innermost host
    event under the gap's start), each at most ``n`` entries."""
    by_op = {}
    for name, a, b in tr.device:
        by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
    if tr.device:
        lo = min(min(a for _, a, _ in tr.device), min((a for _, a, _ in tr.host), default=0))
        hi = max(b for _, _, b in tr.device)
    else:
        return {"device_ops": [], "idle_gaps": []}
    host = sorted(tr.host, key=lambda h: h[1])
    by_host = {}
    starts = [h[1] for h in host]
    for ga, gb in gaps([(a, b) for _, a, b in tr.device], lo, hi):
        i = bisect.bisect_right(starts, ga)
        best = None
        for name, a, b in reversed(host[max(0, i - 400):i]):
            if a <= ga < b and (best is None or b - a < best[2] - best[1]):
                best = (name, a, b)
        label = best[0] if best else "host (outside any operator)"
        by_host[label] = by_host.get(label, 0.0) + (gb - ga) / 1e6
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}
