"""The port's elastic-mesh game day (scripts/torch_reshard_smoke.py)
against the JAX package's (scripts/reshard_smoke.py), the short campaign
of tests/test_drill.py (4 sessions, 2 chat bursts): grow 2 -> 4 under
surge, drain a shard, heal.  The port's meshes are virtual CPU meshes
(``make_mesh(n, device="cpu", virtual=True)``).

Every check of the port's run holds, with zero violations and each step
fired at its tick.  What the campaign fixes across the packages (each
check's name, the campaign's steps and its constants) is compared on the
two scripts' text: tests/test_drill.py runs the JAX campaign and holds
every check true, and under the tier-1 run's six workers a second JAX
run here would take ~85 s.  The ``slow`` case runs both packages' short
campaigns and compares what they fix (each check's verdict, the
campaign, the fired steps, the violation count).  Left out, as in
tests/test_torch_drill.py: the drill's tick total, the rows each reshard
moved and the exodus ticks (both follow which pump the chat frames
landed in), and the seconds."""

from __future__ import annotations

import ast

import pytest

from test_torch_drill import PKGS, REPO, run_campaign
from test_torch_parity import one_intra_op_thread  # noqa: F401

CONSTANTS = ("NPCS", "GROW_TICK", "DRAIN_TICK", "HEAL_TICK", "GROW_TO", "DRAIN_DEVICE")


def fixed_text(name: str) -> dict:
    """A script's campaign as its text fixes it: the module constants,
    the ``campaign = (...)`` expression and every ``checks[...]`` key."""
    tree = ast.parse((REPO / "scripts" / f"{name}.py").read_text())
    consts = {t.id: ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name) and t.id in CONSTANTS}
    campaign = [ast.dump(n.value) for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "campaign" for t in n.targets)]
    checks = [ast.dump(n.slice) for n in ast.walk(tree) if isinstance(n, ast.Subscript)
              and isinstance(n.ctx, ast.Store) and isinstance(n.value, ast.Name)
              and n.value.id == "checks"]
    return {"constants": consts, "campaign": campaign, "checks": checks}


def test_reshard_short_campaign(monkeypatch, tmp_path):
    port = run_campaign(monkeypatch, PKGS["torch"], "torch_reshard_smoke",
                        tmp_path, seed=7, sessions=4, chats=2, device="cpu")
    failed = [name for name, ok in port["checks"].items() if not ok]
    assert not failed
    assert port["violations"] == 0
    assert [(f[0], f[1]) for f in port["fired"]] == [
        (0, "note"), (6, "grow_mesh"), (120, "drain_device"), (160, "heal")]
    assert [s["at_tick"] for s in port["campaign"]["steps"]] == [0, 6, 120, 160]
    ours, ref = fixed_text("torch_reshard_smoke"), fixed_text("reshard_smoke")
    assert ours == ref
    assert len(ref["checks"]) == len(port["checks"]) and len(ref["campaign"]) == 1


@pytest.mark.slow
def test_reshard_short_campaign_equals_jax(monkeypatch, tmp_path):
    port = run_campaign(monkeypatch, PKGS["torch"], "torch_reshard_smoke",
                        tmp_path / "torch", seed=7, sessions=4, chats=2, device="cpu")
    ref = run_campaign(monkeypatch, PKGS["jax"], "reshard_smoke",
                       tmp_path / "jax", seed=7, sessions=4, chats=2)
    assert not [name for name, ok in ref["checks"].items() if not ok]
    assert port == ref
