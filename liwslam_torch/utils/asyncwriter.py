"""Asynchronous output writer — the reference's visualization thread.

The port's own copy of ``liwslam/utils/asyncwriter.py``.

The reference decouples all rendering/publishing from the compute path
through a worker thread with task deques (``src/utilies/visualization.h:
57-67``, consumer ``visualization.cpp:557-691``).  liwslam's outputs are
files, so the equivalent is a single writer thread draining a queue of
``(fn, args)`` thunks: producers never block on disk or PNG encoding.
"""

from __future__ import annotations

import queue
import threading
import traceback


class AsyncWriter:
    def __init__(self, maxsize=256):
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._errors: list = []
        self._thread.start()

    def submit(self, fn, *args, **kw):
        """Enqueue a write.  If the queue is full the producer blocks —
        backpressure instead of unbounded memory (the reference's deques
        grow unboundedly; this is the one deliberate difference)."""
        self._q.put((fn, args, kw))

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, kw = item
            try:
                fn(*args, **kw)
            except Exception:  # debug output must never kill the run
                self._errors.append(traceback.format_exc())

    def close(self):
        """Drain and stop; returns collected error tracebacks (if any)."""
        self._q.put(None)
        self._thread.join()
        return self._errors
