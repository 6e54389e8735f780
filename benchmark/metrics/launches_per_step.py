"""Kernel launches a batched step: the host's launch calls in the traced
steps over the steps (layer: the batched step)."""

from benchmark.harness.trace import LAUNCHES


def read(tr):
    if tr.steps <= 0:
        return None
    n = sum(1 for name, _, _ in tr.host if name in LAUNCHES)
    return n / tr.steps if n else None
