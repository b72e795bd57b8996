"""A run of each cell on the CPU with the timed path broken underneath
must come out not correct: a step that returns its state unchanged, half
of the batch left out of the step, and an answer altered where it is
produced.  (One chip: no exchange between chips to leave out.)  Each
deployment kind names its batch (``batch``) and one answer its step
produces (``answer``), so the faults hit what the contract means there."""

import pytest
import torch

from nfbench import run
from nfbench.deployments import world

from .conftest import CELLS, tiny_cell


def unchanged(kind, dep, before):
    for (p, x), (_, y) in zip(dep.leaves(), before):
        x.copy_(y)


def half_left_out(kind, dep, before):
    """The second half of the batch's rows keeps its state from before
    the step."""
    rows = set(kind.batch(dep))
    assert rows
    for (p, x), (_, y) in zip(dep.leaves(), before):
        if p in rows:
            n = x.shape[0] // 2
            x[n:].copy_(y[n:])


def one_answer_altered(kind, dep, before):
    path, index = kind.answer(dep)
    x = dict(dep.leaves())[path]
    x[index] = ~x[index] if x.dtype == torch.bool else x[index] + 1


FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out,
          "answer_altered": one_answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_broken_step_is_not_correct(workload, fault, monkeypatch, cpu_threads):
    found = tiny_cell(workload)
    kind, ent, _chk = run.parts(found)
    frame = ent.frame
    breaks = FAULTS[fault]

    def broken(dep):
        before = [(p, x.clone()) for p, x in dep.leaves()]
        frame(dep)
        breaks(kind, dep, before)

    monkeypatch.setattr(ent, "frame", broken)
    res = run.run_cell(found, 31, 0.2, False, torch.device("cpu"),
                       lambda: 1.0, log=lambda s: None)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
    if found["config"]["kind"] == "world":
        assert res["checks"]["cells_off"]["limit"] == 0
        assert res["checks"]["cells_off"]["value"] > 0


def test_the_world_faults_hit_its_npc_rows_and_an_hp_cell(cpu_threads):
    """The world's batch is its NPC rows, every leaf of them, and its
    altered answer is the first NPC row's HP."""
    found = tiny_cell("world_1m.frames")
    dep = world.deploy(found["config"], 5, torch.device("cpu"))
    try:
        paths = [p for p, _ in dep.leaves()]
        rows = world.batch(dep)
        assert rows == [p for p in paths if p.startswith("classes.NPC.")]
        assert "classes.NPC.i32" in rows and "classes.NPC.vec" in rows
        n = found["config"]["rows"]["NPC"]
        assert all(dict(dep.leaves())[p].shape[0] == n for p in rows)
        assert world.answer(dep) == ("classes.NPC.i32", (0, dep.layout().i32["NPC"]["HP"]))
    finally:
        dep.close()
