"""The benchmark's harness: the traffic generator (``sim``, ``fleet``), the
system under test as the benchmark drives it (``program``), the measured
windows (``windows``), the trace (``trace``, ``peaks``), the check against
the plain reference (``check``) and one run of a cell (``runner``)."""
