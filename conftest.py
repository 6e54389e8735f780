"""pytest settings for the tests under ``tests/``: one thread for OpenBLAS
and torch in every test process, and a time limit for every test.

``tests/conftest.py`` holds the JAX package's own harness (the virtual
8-device CPU mesh).  What is here acts only on items under ``tests/``,
so that other test directories (``python -m pytest benchmark``) keep their
own setup.

Threads.  The suite runs as six xdist workers on eight cores.  OpenBLAS
(behind numpy's small matrix calls, e.g. the 4x4 inverses of a keyframe
feed) and torch's OpenMP pool each start one thread a core, and their
threads spin-wait between calls.  Six workers' spinning pools
oversubscribe the cores, and a test of many small calls then runs 10-20x
slower than alone: tests/test_knobs.py::test_verify_loop_rate_gates_manager
took 32 s alone and 692 s in the suite, and six copies of it started at
once each ran past 400 s; with one OpenBLAS thread the six finish in
~31 s each.  So the first test of a process bounds the process:

- numpy's OpenBLAS is loaded before any conftest (the jaxtyping plugin
  imports numpy), after it read its environment, so its pool is cut to
  one thread at run time through ``threadpoolctl``; torch's through
  ``torch.set_num_threads``.
- ``OPENBLAS_NUM_THREADS=1`` and ``OMP_NUM_THREADS=1`` bound what the
  process loads later and every process a test spawns (the multi-rank
  tests, the CLI subprocesses).

XLA's own CPU pools are left as they are: with six workers the JAX
package's compile- and execution-heavy tests contend for the memory
system, not for threads (six copies of tests/test_loop_aliasing.py, each
pinned to a core of its own, took ~570 s each against 161 s alone).

Time limit.  Every test's setup, call and teardown each run under a
``signal.alarm`` of ``TIME_LIMIT_S`` seconds in the worker's main thread;
past it the phase fails with its traceback, and the rest of the suite
runs on.  A test that runs a subprocess passes it a ``timeout=`` shorter
than the limit, so that the subprocess's error is the one reported.
"""

import contextlib
import functools
import os
import signal
import sys
from pathlib import Path

import pytest
import threadpoolctl

TESTS = Path(__file__).resolve().parent / "tests"

# The slowest phase of a cold run with six workers took 396-492 s (the
# setups of the module fixtures of tests/test_multirobot_e2e.py and
# tests/test_loop_aliasing.py); a hung test fails after ~2.5 times that.
TIME_LIMIT_S = 1200

# A raise from the alarm's handler inside a garbage-collection callback or
# a __del__ is swallowed; the handler fires again this much later while the
# phase still runs, leaving the phase's remaining finalizers and ``finally:``
# blocks (rank joins, process-group teardown) room to finish.
REFIRE_S = 60


@functools.cache
def _one_thread():
    os.environ["OPENBLAS_NUM_THREADS"] = "1"
    os.environ["OMP_NUM_THREADS"] = "1"
    threadpoolctl.threadpool_limits(1, user_api="blas")
    if "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(1)


@contextlib.contextmanager
def _bounded(item, phase):
    if not item.path.resolve().is_relative_to(TESTS):
        yield
        return
    _one_thread()
    message = f"{item.nodeid}: {phase} ran past its time limit of {TIME_LIMIT_S} s"
    expired = False

    def expire(signum, frame):
        nonlocal expired
        expired = True
        signal.alarm(REFIRE_S)
        pytest.fail(message)

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
    if expired:
        pytest.fail(message)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _bounded(item, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _bounded(item, "call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with _bounded(item, "teardown"):
        return (yield)
