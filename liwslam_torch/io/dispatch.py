"""Deterministic sensor-stream dispatcher (pure Python).

The port's own copy of ``merge_numpy`` from ``liwslam/io/dispatch.py``:
the reference dispatch_queue semantics (``dispatch.h:59-258``: per-sensor
monotonicity filtering, watermark gating, strict global time order).  The
port does not load the reference package's native dispatcher.
"""

from __future__ import annotations

import numpy as np


def merge_numpy(sensor_times, enabled, watermark=40, drain=True):
    """Pure-python oracle with identical semantics."""
    from collections import deque

    n = len(sensor_times)
    bufs = [deque() for _ in range(n)]
    last_acc = [-np.inf] * n
    nxt = [0] * n
    last_dispatch = -np.inf
    out_s, out_i = [], []

    def feed_one():
        best, best_t = -1, np.inf
        for s in range(n):
            if nxt[s] < len(sensor_times[s]) and sensor_times[s][nxt[s]] < best_t:
                best_t = sensor_times[s][nxt[s]]
                best = s
        if best < 0:
            return False
        t = sensor_times[best][nxt[best]]
        nxt[best] += 1
        if t <= last_dispatch:
            return True
        if bufs[best] and bufs[best][-1][0] >= t:
            return True
        if t <= last_acc[best]:
            return True
        last_acc[best] = t
        bufs[best].append((t, nxt[best] - 1))
        return True

    def watermark_ok():
        return all(
            not enabled[s] or len(bufs[s]) >= watermark for s in range(n)
        )

    feeding = True
    while True:
        while not watermark_ok() and feeding:
            feeding = feed_one()
        if not watermark_ok() and not drain:
            break
        oldest, oldest_t = -1, np.inf
        empty_enabled = False
        for s in range(n):
            if not enabled[s]:
                continue
            if not bufs[s]:
                empty_enabled = True
                continue
            if bufs[s][0][0] < oldest_t:
                oldest_t = bufs[s][0][0]
                oldest = s
        if empty_enabled and feeding:
            feeding = feed_one()
            if feeding:
                continue
        if oldest < 0:
            # everything enabled is empty: drain disabled-sensor leftovers
            for s in range(n):
                if bufs[s] and bufs[s][0][0] < oldest_t:
                    oldest_t = bufs[s][0][0]
                    oldest = s
            if oldest < 0 or not drain:
                break
        t, idx = bufs[oldest].popleft()
        if t <= last_dispatch:
            continue
        last_dispatch = t
        out_s.append(oldest)
        out_i.append(idx)
    return np.asarray(out_s, np.int32), np.asarray(out_i, np.int64)
