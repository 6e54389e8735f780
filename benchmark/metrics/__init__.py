"""Per-layer metric readers: ``<metric name>.py`` (or, for a name with a
suffix after a dot, ``<name before the dot>.py``), each with
``read(trace) -> float | None`` over a ``harness.trace.Trace``.  A reader
that finds nothing to read returns None, and the run leaves the metric
out."""
