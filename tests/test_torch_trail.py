"""The port's PropertyTrailModule (game/trail.py) against the JAX package
on the CPU: tests/test_trail.py's five cases, each run on both packages'
kernels over tests/fixtures.base_registry() (the port's through
test_torch_scene.port_registry), guids pinned; the trail's log lines must
be equal, line for line.  Plus the port's capture count: one trail start
on a captured tick costs one re-capture, not one per forced column."""

from __future__ import annotations

import pytest

from fixtures import base_registry
from test_torch_middleware import PKGS
from test_torch_scene import port_registry


class CaptureLog:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


def poke_phase(P, cname, prop, value):
    """A device phase setting one int column of a class to ``value``, in
    either package's arrays."""
    def phase(state, ctx):
        col = ctx.store.spec(cname).slots[prop].col
        cs = state.classes[cname]
        if P.port:
            i32 = cs.i32.clone()
            i32[:, col] = value
        else:
            i32 = cs.i32.at[:, col].set(value)
        return state.replace(classes={**state.classes, cname: cs.replace(i32=i32)})
    return phase


def build(P, *extra):
    reg = base_registry()
    log = CaptureLog()
    pm = P.kernel.PluginManager()
    kernel = P.kernel.Kernel(
        port_registry(reg) if P.port else reg,
        P.world.StoreConfig(default_capacity=16, capacities={"NPC": 16, "Player": 16}),
        dt=1.0, class_names=["IObject", "Player", "NPC"], **P.kw)
    trail = P.game.PropertyTrailModule(logger=log)
    pm.register_plugin(P.kernel.Plugin("TrailPlugin", [kernel, trail, *extra]))
    pm.start()
    kernel.store.guids.pin(9000)
    return pm, kernel, trail, log


def poker(P, cname, prop, value):
    class Poke(P.kernel.Module):
        name = "Poke"

        def init(self):
            self.add_phase("poke", poke_phase(P, cname, prop, value), order=10)

    return Poke()


def start_trail_dumps_then_follows_changes(P):
    pm, kernel, trail, log = build(P)
    g = kernel.create_object("Player", {"Name": "ann", "HP": 50})
    other = kernel.create_object("Player", {"Name": "bob", "HP": 70})
    trail.start_trail(g)
    assert trail.is_trailing(g)
    dump = "\n".join(log.lines)
    assert f"{g} Player.HP = 50" in dump and f"{g} Player.Name = 'ann'" in dump
    assert "Position" in dump
    n_dump = len(log.lines)
    kernel.set_property(g, "HP", 42)
    kernel.set_property(other, "HP", 99)
    changes = log.lines[n_dump:]
    assert any("Player.HP -> 42" in ln for ln in changes)
    assert not any(str(other) in ln for ln in changes)
    return log.lines


def end_trail_stops_logging(P):
    pm, kernel, trail, log = build(P)
    g = kernel.create_object("Player", {"HP": 5})
    trail.start_trail(g)
    trail.end_trail(g)
    assert not trail.is_trailing(g)
    n = len(log.lines)
    kernel.set_property(g, "HP", 6)
    assert len(log.lines) == n
    return log.lines


def trail_sees_device_tick_changes(P):
    pm, kernel, trail, log = build(P, poker(P, "Player", "HP", 77))
    g = kernel.create_object("Player", {"HP": 10})
    trail.start_trail(g)
    n = len(log.lines)
    pm.run_once()
    assert any("Player.HP -> 77" in ln for ln in log.lines[n:])
    return log.lines


def destroyed_object_releases_trail(P):
    pm, kernel, trail, log = build(P)
    g = kernel.create_object("Player", {"HP": 1})
    trail.start_trail(g)
    kernel.destroy_object(g)
    assert not trail.is_trailing(g)
    trail.end_trail(g)
    g2 = kernel.create_object("Player", {"HP": 2})
    assert not trail.is_trailing(g2)
    n = len(log.lines)
    kernel.set_property(g2, "HP", 3)
    assert len(log.lines) == n
    return log.lines


def trail_sees_unflagged_property_tick_changes(P):
    pm, kernel, trail, log = build(P, poker(P, "NPC", "HPREGEN", 13))
    g = kernel.create_object("NPC", {"HPREGEN": 1})
    trail.start_trail(g)
    n = len(log.lines)
    pm.run_once()
    assert any("NPC.HPREGEN -> 13" in ln for ln in log.lines[n:])
    return log.lines


@pytest.mark.parametrize("case", [start_trail_dumps_then_follows_changes,
                                  end_trail_stops_logging, trail_sees_device_tick_changes,
                                  destroyed_object_releases_trail,
                                  trail_sees_unflagged_property_tick_changes],
                         ids=lambda c: c.__name__)
def test_trail_case(case):
    """Each case on both packages: the same trail log, line for line."""
    a = case(PKGS["noahgameframe_tpu"])
    b = case(PKGS["noahgameframe_tpu_torch"])
    assert len(a) > 0 and a == b


def test_trail_start_costs_one_recapture():
    """On a world whose tick was already captured, starting a trail forces
    every property of the class into the diff (one invalidation each);
    the next dispatch captures once, and the tick after replays."""
    P = PKGS["noahgameframe_tpu_torch"]
    pm, kernel, trail, log = build(P, poker(P, "NPC", "HPREGEN", 13))
    g = kernel.create_object("NPC", {"HPREGEN": 1})
    pm.run_once()
    entry = kernel.costbook.entries["kernel.step"]
    before = entry.compiles
    trail.start_trail(g)
    assert len(kernel._forced_diff["NPC"]) == len(kernel.store.spec("NPC").prop_order)
    kernel.set_property(g, "HPREGEN", 1)
    pm.run_once()
    pm.run_once()
    assert entry.compiles == before + 1
    assert list(entry.causes) == ["static:forced_diff"]
    assert any("NPC.HPREGEN -> 13" in ln for ln in log.lines)
