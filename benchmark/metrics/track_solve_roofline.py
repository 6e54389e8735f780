"""Kernel B1's share of its roofline in the traced steps, %: the launches'
least time (bytes over HBM bandwidth or float32 operations over the
float32 rate, counted from each launch's inputs and each system's LM
iterations) over their device time (layer: the kernels)."""

from benchmark.harness import peaks

KERNEL = "track_solve_kernel"


def read(tr):
    durs = [(b - a) / 1e6 for name, a, b in tr.device if name == KERNEL or KERNEL + "(" in name]
    launches = tr.cell.get("b1_launches") or []
    if not durs or not launches:
        return None
    least = [peaks.least_s(*peaks.track_solve(n, m, iters)) for n, m, iters in launches]
    return 100.0 * (sum(least) / len(least)) / (sum(durs) / len(durs))
