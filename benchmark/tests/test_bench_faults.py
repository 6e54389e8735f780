"""``correct`` on the CPU at a test's size: true for the port as it is,
false with the timed path broken underneath (each fault a one-chip cell
can have), and false for the control (the reference with TF32 products in
the program's place).  These drive all of a run but the look for a card:
set-up, the window, the samples and the check against the reference."""

import pytest
import torch
from torch.utils._pytree import tree_map

from benchmark.harness import program
from benchmark.tests.cells import CORRIDOR, OFFICE, run_tiny, tiny_cell


def _broken(monkeypatch, fault):
    real_init = program.Program.__init__

    def init(self, cfg, device):
        real_init(self, cfg, device)
        real_run = self.run

        def run(states, inp):
            new, out = real_run(states, inp)
            if fault == "state_unchanged":
                return states, out
            if fault == "half_batch":
                # the second half's answers and states are the first half's
                half = out.p.shape[0] // 2
                dup = lambda t: torch.cat([t[:half], t[:half]]) if t.shape[0] == 2 * half else t
                return tree_map(dup, new), tree_map(dup, out)
            if fault == "answer_altered":
                return new, out._replace(p=out.p + 1e-3)
            if fault == "minority_altered":
                # the first frame of every chunk of four: a quarter of the
                # frames, under each sequence's median
                p = out.p.clone()
                p[:, ::4] += 2e-2
                return new, out._replace(p=p)
            raise ValueError(fault)

        self.run = run

    monkeypatch.setattr(program.Program, "__init__", init)


@pytest.mark.parametrize("name", [OFFICE, CORRIDOR])
def test_sound_run_is_correct(name):
    res, checks = run_tiny(tiny_cell(name))
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered", "minority_altered"])
@pytest.mark.parametrize("name", [OFFICE, CORRIDOR])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    _broken(monkeypatch, fault)
    res, checks = run_tiny(tiny_cell(name, frames=8, chunk=4), seconds=1.0)
    assert not res["correct"], checks
    if fault == "minority_altered":
        # a high quantile of the frames catches what no sequence's median sees
        assert any(k.endswith(".p90") and v > lim for k, (v, lim) in checks.items()), checks


@pytest.mark.parametrize("name", [OFFICE, CORRIDOR])
def test_control_is_not_correct(name):
    """The control's readings against the cell's limits: at least one
    number out of its limit."""
    from benchmark.harness import check

    cell = tiny_cell(name)
    res, _ = run_tiny(cell, control=True)
    ctrl = res["control_readings"]
    ok, checks = check.verdict(ctrl, cell["limits"], 0, 0)
    assert not ok, checks
