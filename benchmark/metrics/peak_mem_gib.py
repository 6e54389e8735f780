"""Peak device memory over the measured window, GiB: the allocator's
``max_memory_allocated`` after a reset at the window's start (layer: the
device)."""


def read(tr):
    return tr.cell.get("window_peak_gib")
