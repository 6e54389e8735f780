"""The device's idle share of the traced window, in %: 100 x (1 - the
union of its kernel and copy intervals over the window's host-clock
length) (layer: the device)."""


def read(tr):
    if tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
