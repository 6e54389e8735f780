"""Per-stage timing statistics and scalar series (tracing parity).

The port's own copy of ``liwslam/utils/record.py``.

Reference counterpart: the ``record`` class (``src/utilies/record.h``):
a stack of microsecond timers (``begin_record``/``end_record(stage)``),
scalar counters (``add_record``), and a markdown stats table
(count/max/min/mean/variance per stage) written at shutdown.  Identical
surface here; used by the CLI (``liwslam_torch.run``).
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class _Series:
    count: int = 0
    total: float = 0.0
    total2: float = 0.0
    vmax: float = float("-inf")
    vmin: float = float("inf")

    def add(self, v: float):
        self.count += 1
        self.total += v
        self.total2 += v * v
        self.vmax = max(self.vmax, v)
        self.vmin = min(self.vmin, v)

    def stats(self):
        mean = self.total / max(self.count, 1)
        var = self.total2 / max(self.count, 1) - mean * mean
        return self.count, self.vmax, self.vmin, mean, max(var, 0.0)


class Record:
    """Stacked scoped timers + scalar series -> markdown table."""

    def __init__(self, name: str = "record"):
        self.name = name
        self._stack: list[float] = []
        self._series: dict[str, _Series] = defaultdict(_Series)

    def begin_record(self):
        self._stack.append(time.perf_counter())

    def end_record(self, stage: str):
        t0 = self._stack.pop()
        self._series[f"{stage} (ms)"].add((time.perf_counter() - t0) * 1e3)

    def add_record(self, name: str, value: float):
        self._series[name].add(float(value))

    class _Scope:
        def __init__(self, rec, stage):
            self.rec, self.stage = rec, stage

        def __enter__(self):
            self.rec.begin_record()

        def __exit__(self, *a):
            self.rec.end_record(self.stage)

    def scope(self, stage: str):
        """with rec.scope("solve"): ...   (RAII timer, timer.h:33-92)"""
        return Record._Scope(self, stage)

    def to_markdown(self) -> str:
        lines = [
            f"# record: {self.name}",
            "",
            "| stage | count | max | min | mean | variance |",
            "|---|---|---|---|---|---|",
        ]
        for k in sorted(self._series):
            c, mx, mn, mean, var = self._series[k].stats()
            lines.append(f"| {k} | {c} | {mx:.4f} | {mn:.4f} | {mean:.4f} | {var:.4f} |")
        return "\n".join(lines) + "\n"

    def dump(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, f"{self.name}.md")
        with open(path, "w") as f:
            f.write(self.to_markdown())
        return path
