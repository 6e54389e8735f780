"""Deterministic sensor-stream dispatcher.

The reference dispatch_queue semantics (``dispatch.h:59-258``: per-sensor
monotonicity filtering, watermark gating, strict global time order), as in
``liwslam/io/dispatch.py``: :func:`merge` runs the port's own copy of the
native merge (``liwslam_torch/native/dispatch.cpp``), built with
``g++ -O2 -shared -fPIC`` at first use into ``liwslam_torch/_build/``
(named by a hash of the source and the flags) and bound with ``ctypes``;
:func:`merge_numpy` is the pure-Python form with the same semantics, kept
as its oracle.  A failed build raises: there is no fallback to Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "dispatch.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ("-O2", "-shared", "-fPIC")
_lib = None


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libdispatch.{h.hexdigest()[:16]}.so")


def native_lib():
    """The native dispatcher (``ctypes.CDLL``), built when missing or
    stale; raises when ``g++`` fails, with its output in the message."""
    global _lib
    if _lib is not None:
        return _lib
    path = _lib_path()
    if not os.path.isfile(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        out = subprocess.run(["g++", *FLAGS, SOURCE, "-o", tmp], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"liwslam_torch: building the native dispatcher failed (g++ exit {out.returncode})\n{out.stdout}{out.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.dispatch_merge.restype = ctypes.c_long
    lib.dispatch_merge.argtypes = [
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return lib


def merge(sensor_times, enabled=None, watermark=40, drain=True):
    """Merge per-sensor timestamp arrays into a dispatch order, natively.

    sensor_times: list of float64 arrays (seconds), one per sensor, in
    arrival order.  Returns (sensor_ids (N,) int32, indices (N,) int64)."""
    n = len(sensor_times)
    enabled = [True] * n if enabled is None else enabled
    lib = native_lib()
    arrs = [np.ascontiguousarray(np.asarray(t, np.float64)) for t in sensor_times]
    ptrs = (ctypes.POINTER(ctypes.c_double) * n)(*[a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) for a in arrs])
    counts = (ctypes.c_long * n)(*[len(a) for a in arrs])
    en = (ctypes.c_uint8 * n)(*[1 if e else 0 for e in enabled])
    total = sum(len(a) for a in arrs)
    out_s = np.zeros(total, np.int32)
    out_i = np.zeros(total, np.int64)
    n_out = lib.dispatch_merge(
        ptrs, counts, n, en, watermark, 1 if drain else 0,
        out_s.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out_s[:n_out], out_i[:n_out]


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
