"""What a run loads: no module whose top-level name is JAX's, its
libraries' or the JAX package's (compared whole: ``liwslam_torch`` is the
port, ``liwslam`` the JAX package), and nothing of the port in the plain
reference."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUN_TINY = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.tests.cells import tiny_cell, run_tiny
res, _ = run_tiny(tiny_cell("office.replay-b8192"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from benchmark.reference import extract, factors, geometry, gn, init, matching, params, prec
from benchmark.reference import preintegration, scan, step, track_solve
from benchmark.harness import check
with open({cfg!r}) as f:
    cfg = json.load(f)
ref = check.Reference(cfg)
z = torch.zeros(3)
st = step.init_track_state(z, z, z, torch.zeros(6), ref.scfg)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_forbidden_names_are_compared_whole():
    from benchmark import run

    names = {"liwslam_torch", "benchmark", "torch"}
    assert not names & set(run.FORBIDDEN)
    assert "liwslam" in run.FORBIDDEN and "jax" in run.FORBIDDEN


def test_a_run_loads_no_jax_and_no_jax_package():
    mods = _modules(RUN_TINY.format(root=ROOT))
    assert "liwslam_torch" in mods  # the port is what runs
    assert not mods & {"jax", "jaxlib", "flax", "liwslam"}, mods & {"jax", "jaxlib", "flax", "liwslam"}


def test_the_reference_loads_nothing_of_the_port():
    cfg = os.path.join(ROOT, "benchmark", "configs", "corridor.json")
    mods = _modules(REFERENCE_ONLY.format(root=ROOT, cfg=cfg))
    assert not mods & {"jax", "jaxlib", "flax", "liwslam", "liwslam_torch"}, mods


def test_reference_sources_import_nothing_of_the_port():
    here = os.path.join(ROOT, "benchmark", "reference")
    for name in os.listdir(here):
        if name.endswith(".py"):
            with open(os.path.join(here, name)) as f:
                src = f.read()
            for line in src.splitlines():
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    top = s.split()[1].split(".")[0]
                    assert top not in ("liwslam", "liwslam_torch", "jax", "jaxlib", "flax"), (name, line)
