"""Cut-down cells for the benchmark's CPU tests: a cell of BENCHMARK.json
with its traffic shrunk to a few sequences and frames."""

from __future__ import annotations

import copy
import time

from benchmark import run


OFFICE, CORRIDOR = "office.replay-b8192", "corridor.replay-b4096"


def tiny_cell(name: str, **mix):
    """Cell ``name`` with a replay of two sequences and four frames."""
    cell = copy.deepcopy(run.load_cell(name))
    cell["mix"].update(sequences=2, tracks=1, frames=4, chunk=4,
                       check={"sequences": 2, "inits": 1, "chunk_max": 0, "workers": 1})
    cell["mix"].update(mix)
    return cell


def run_tiny(cell, seed=2**31 + 7, seconds=0.5, control=False):
    from benchmark.harness import runner

    t0 = time.perf_counter()
    return runner.run_cell(cell, seed, seconds, False, "cpu", lambda: time.perf_counter() - t0, control=control)
