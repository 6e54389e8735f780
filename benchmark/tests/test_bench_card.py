"""One run of a cell on the card, as a check of the benchmark makes it: the result line's
keys, its device and ``correct``.  Skips without a CUDA device."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_one_run_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100)")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = json.load(f)["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 11), "--seconds", "5",
         "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert res["correct"], res["checks"]
    if trace:
        assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0


def test_no_card_no_result():
    """Without a CUDA device the run exits with another code than 0 and
    prints no result."""
    code = (
        "import sys, torch; torch.cuda.is_available = lambda: False; sys.argv = ['run.py', '--workload', "
        "'office.replay-b8192', '--seed', '1', '--seconds', '1', '--trace', '0']; sys.path.insert(0, %r); "
        "from benchmark import run; sys.exit(run.main())" % ROOT
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
