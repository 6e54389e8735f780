"""Kernel B2's share of its roofline in the traced steps, %: the launches'
least time (bytes over HBM bandwidth or float32 operations over the
float32 rate, counted from B scans of N points and L lines) over their
device time (layer: the kernels)."""

from benchmark.harness import peaks

KERNEL = "extract_lines_kernel"


def read(tr):
    durs = [(b - a) / 1e6 for name, a, b in tr.device if name == KERNEL or KERNEL + "(" in name]
    if not durs:
        return None
    nbytes, nops = peaks.extract_lines(tr.cell["B"], tr.cell["N"], tr.cell["L"])
    return 100.0 * peaks.least_s(nbytes, nops) / (sum(durs) / len(durs))
