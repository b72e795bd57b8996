"""The port's cluster smokes (scripts/torch_{chaos,failover,persist,replay,
pipeline}_smoke.py) on the CPU, held against the JAX package's scripts.

Each port script's ``run`` (``device="cpu"``) must pass every check, and
its check names must be the JAX script's: the same ``checks[...]`` keys
in the two scripts' text, compared by their AST (order aside), and, where
the JAX script also runs here, the same keys at run time.  The chaos and
failover scenarios cost the JAX package under ~15 s in the tier-1 run, so
their tests run the JAX script too and compare what the two runs fix:
the revived world's NPC banks, tick and rng against the other package's
fault-free control at the same tick (chaos), and each re-homed player's
Name, Level and Gold on the survivor (failover).  The surge, persist,
replay and pipeline scenarios cost the JAX package 20-56 s there; their
JAX runs stay in tests/test_failover.py, test_writebehind.py,
test_replay.py and test_pipeline.py.

In the two runs against JAX, both packages' leases are widened (chaos
1.5 s / 3 s against the script's 0.6 s / 1.2 s, failover 3 s / 6 s
against 1 s / 2 s), as tests/test_torch_chaos.py and
tests/test_torch_failover.py widen them: beside the other test workers
the JAX game's first compile stalls the pump past the scripts' leases,
and a healthy game then goes DOWN and its sessions re-home early."""

from __future__ import annotations

import ast
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_parity import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def load(name: str):
    """scripts/<name>.py as a module (registered under its name, as the
    scripts import each other)."""
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def check_names(name: str) -> list:
    """Every check name a script's text fixes: the key of each
    ``checks[...] = ...`` and of a ``checks = {...}`` literal, as AST
    dumps, sorted."""
    tree = ast.parse((REPO / "scripts" / f"{name}.py").read_text())
    out = []
    for n in ast.walk(tree):
        if (isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store)
                and isinstance(n.value, ast.Name) and n.value.id == "checks"):
            out.append(ast.dump(n.slice))
        elif (isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
              and any(isinstance(t, ast.Name) and t.id == "checks" for t in n.targets)):
            out.extend(ast.dump(k) for k in n.value.keys)
    return sorted(out)


def all_true(checks: dict) -> None:
    failed = [k for k, ok in checks.items() if not ok]
    assert not failed, f"checks failed: {failed}"


@pytest.mark.parametrize("name", ["chaos_smoke", "failover_smoke", "persist_smoke",
                                  "replay_smoke", "pipeline_smoke"])
def test_check_names_are_the_jax_scripts(name):
    ours, ref = check_names(f"torch_{name}"), check_names(name)
    assert ref and ours == ref


def wide_leases(monkeypatch, suspect: float, down: float) -> None:
    """Both packages' LocalCluster built with these lease times."""
    from noahgameframe_tpu.net.roles.cluster import LocalCluster as JCluster
    from noahgameframe_tpu_torch.net.roles.cluster import LocalCluster

    for cls in (LocalCluster, JCluster):
        def init(self, *a, _init=cls.__init__, **kw):
            kw.update(lease_suspect_seconds=suspect, lease_down_seconds=down)
            _init(self, *a, **kw)

        monkeypatch.setattr(cls, "__init__", init)


def _flat(P, world) -> dict:
    return P.checkpoint._flatten_state(world.kernel.state)


def _banks_equal(a: dict, b: dict) -> bool:
    keys = sorted(k for k in b if k.startswith("c/NPC/"))
    return (bool(keys) and sorted(k for k in a if k.startswith("c/NPC/")) == keys
            and int(a["tick"]) == int(b["tick"])
            and np.array_equal(np.asarray(a["rng"]), np.asarray(b["rng"]))
            and all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in keys))


def test_chaos_smoke_equals_jax(monkeypatch, tmp_path):
    """Both scripts pass the same 15 checks; each package's revived world
    equals the other package's fault-free control ticked to its tick."""
    import chip_smoke as cs

    wide_leases(monkeypatch, 1.5, 3.0)
    runs = {}
    for pkg, name in (("noahgameframe_tpu_torch", "torch_chaos_smoke"),
                      ("noahgameframe_tpu", "chaos_smoke")):
        mod = load(name)
        built = []
        build = mod.build_world
        monkeypatch.setattr(mod, "build_world",
                            lambda *a, _b=build, **kw: built.append(_b(*a, **kw)) or built[-1])
        kw = {"device": "cpu"} if pkg.endswith("torch") else {}
        checks = mod.run(tmp_path / name, **kw)
        runs[pkg] = (mod, checks, built)
    (tmod, tchecks, tbuilt), (jmod, jchecks, jbuilt) = runs.values()
    all_true(tchecks)
    all_true(jchecks)
    assert list(tchecks) == list(jchecks) and len(tchecks) == 15
    # the port builds the substrate and the control before the live world
    trevived, jrevived = tbuilt[0], jbuilt[1]
    TP, JP = cs.cluster_package("noahgameframe_tpu_torch"), cs.cluster_package("noahgameframe_tpu")
    jcontrol = jmod.build_world(7)
    jmod._drive_control(jcontrol, trevived.kernel.tick_count)
    assert _banks_equal(_flat(TP, trevived), _flat(JP, jcontrol))
    tcontrol = tmod.build_world(7, "cpu")
    tmod._drive_control(tcontrol, jrevived.kernel.tick_count)
    assert _banks_equal(_flat(JP, jrevived), _flat(TP, tcontrol))


def _rehomed(monkeypatch, cluster_cls):
    """Record, as each cluster shuts, every session's Name, Level and Gold
    on the survivor (game 16)."""
    seen = {}
    shut = cluster_cls.shut

    def recording(self):
        for g in self.games:
            if g.config.server_id != 16:
                continue
            for s in g.sessions.values():
                if s.guid is not None:
                    seen[s.account] = tuple(
                        g.kernel.get_property(s.guid, p) for p in ("Name", "Level", "Gold"))
        return shut(self)

    monkeypatch.setattr(cluster_cls, "shut", recording)
    return seen


def test_failover_smoke_equals_jax(monkeypatch, tmp_path):
    """Both scripts pass the same 23 checks, and both survivors hold the
    same re-homed players (Name, Level, Gold)."""
    from noahgameframe_tpu.net.roles.cluster import LocalCluster as JCluster
    from noahgameframe_tpu_torch.net.roles.cluster import LocalCluster

    wide_leases(monkeypatch, 3.0, 6.0)
    tseen = _rehomed(monkeypatch, LocalCluster)
    jseen = _rehomed(monkeypatch, JCluster)
    tchecks = load("torch_failover_smoke").run(tmp_path / "torch", device="cpu")
    jchecks = load("failover_smoke").run(tmp_path / "jax")
    all_true(tchecks)
    all_true(jchecks)
    assert list(tchecks) == list(jchecks) and len(tchecks) == 23
    assert tseen == jseen == {"ada": ("Ada", 9, 4242), "bob": ("Bob", 9, 777)}


def test_failover_surge_passes_every_check(tmp_path):
    """Six round trips of the handoff surge under the fault plan, Game1
    journaled and replayed digest-clean (tests/test_failover.py's size)."""
    checks = load("torch_failover_smoke").surge(tmp_path, rounds=6, device="cpu")
    all_true(checks)
    assert list(checks) == ["client entered game 6", "all switches completed",
                            "proxy re-pointed with the session",
                            "replay digest-identical under surge", "replayed ticks"]


def test_persist_smoke_passes_every_check(tmp_path):
    checks = load("torch_persist_smoke").run(tmp_path, device="cpu")
    all_true(checks)
    assert len(checks) == 31


def test_replay_smoke_passes_every_check(tmp_path):
    checks = load("torch_replay_smoke").run(tmp_path, device="cpu")
    all_true(checks)
    assert len(checks) == 17


def test_pipeline_smoke_passes_every_check(tmp_path):
    checks = load("torch_pipeline_smoke").run(tmp_path, device="cpu")
    all_true(checks)
    assert len(checks) == 19
