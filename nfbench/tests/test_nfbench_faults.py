"""A run of each cell on the CPU with the timed path broken underneath
must come out not correct: a step that returns its state unchanged, half
of the batch left out of the step, and an answer altered where it is
produced.  (One chip: no exchange between chips to leave out.)"""

import pytest
import torch

from nfbench import program, run

from .conftest import CELLS, tiny_cell


def _leaf(dep, suffix):
    return dict(dep.leaves())[suffix]


def unchanged(dep, before):
    for (p, x), (_, y) in zip(dep.leaves(), before):
        x.copy_(y)


def half_left_out(dep, before):
    for (p, x), (_, y) in zip(dep.leaves(), before):
        if p.startswith("classes.NPC."):
            n = x.shape[0] // 2
            x[n:].copy_(y[n:])


def one_hp_altered(dep, before):
    i32 = _leaf(dep, "classes.NPC.i32")
    col = dep.layout().i32["NPC"]["HP"]
    i32[0, col] += 1


FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out,
          "answer_altered": one_hp_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_broken_step_is_not_correct(workload, fault, monkeypatch, cpu_threads):
    cls = program.KINDS[run.find_cell(run.load_benchmark(), workload)["config"]["kind"]]
    frame = cls.frame
    breaks = FAULTS[fault]

    def broken(self, entry):
        before = [(p, x.clone()) for p, x in self.leaves()]
        out = frame(self, entry)
        breaks(self, before)
        return out

    monkeypatch.setattr(cls, "frame", broken)
    res = run.run_cell(tiny_cell(workload), 31, 0.2, False, torch.device("cpu"),
                       lambda: 1.0, log=lambda s: None)
    assert res["correct"] is False
    assert res["checks"]["cells_off"]["value"] > 0
