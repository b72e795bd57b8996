"""The port's component system (kernel/component.py) and plugin manager
(kernel/plugin.py) against the JAX package on the CPU: the cases of
tests/test_component.py, each run on both packages with the guids pinned
(schema attach at CREATE_FINISH, detach at BEFORE_DESTROY, enable flags,
per-frame execute order, manual attach, a scripted component over the
device world), compared trace for trace and state tree for state tree.
Plus the plugin manager's find, manifest load and hot reload.
Tolerance 0."""

from __future__ import annotations

import sys
import types

import numpy as np
import pytest

import noahgameframe_tpu.kernel as jk
from noahgameframe_tpu.core.store import StoreConfig as JStoreConfig
from noahgameframe_tpu_torch.core.store import StoreConfig, state_to_numpy
from noahgameframe_tpu_torch.kernel import component as tc
from noahgameframe_tpu_torch.kernel import plugin as tp
from noahgameframe_tpu_torch.kernel.kernel import Kernel
from noahgameframe_tpu_torch.kernel.module import Module

from test_component import component_registry
from test_torch_parity import assert_tree_equal, jax_tree
from test_torch_scene import port_registry
from test_torch_parity import one_intra_op_thread  # noqa: F401


def _pkg(jax_side: bool):
    base = jk.ObjectComponent if jax_side else tc.Component
    log = []

    class Trace(base):
        def init(self):
            log.append((self.name, "init", str(self.guid)))

        def after_init(self):
            log.append((self.name, "after_init", str(self.guid)))

        def execute(self):
            log.append((self.name, "execute", str(self.guid)))

        def before_shut(self):
            log.append((self.name, "before_shut", str(self.guid)))

    class Guard(Trace):
        name = "Guard"

    class Berserk(Trace):
        name = "Berserk"

    class RageDriver(base):
        name = "RageDriver"

        def execute(self):
            rage = self.kernel.get_property(self.guid, "Rage")
            if self.kernel.get_property(self.guid, "HP") < 5:
                self.kernel.set_property(self.guid, "Rage", rage + 1)

    if jax_side:
        k = jk.Kernel(component_registry(), JStoreConfig(default_capacity=32))
        cm, pm = jk.ComponentModule(), jk.PluginManager(app_name="test")
        plugin = jk.Plugin
    else:
        k = Kernel(port_registry(component_registry()), StoreConfig(default_capacity=32),
                   device="cpu")
        cm, pm = tc.ComponentModule(), tp.PluginManager(app_name="test")
        plugin = tp.Plugin
    cm.register(Guard)
    cm.register(Berserk)
    pm.register_plugin(plugin("KernelPlugin", [k]))
    pm.register_plugin(plugin("LogicPlugin", [cm]))
    pm.start()
    k.store.guids.pin(900)
    return types.SimpleNamespace(k=k, cm=cm, pm=pm, log=log, RageDriver=RageDriver)


def case_schema_attach_on_create_finish(w, out):
    g = w.k.create_object("NPC", {"HP": 10})
    comps = w.cm.components_of(g)
    out += [[(c.name, c.enabled, c.has_init) for c in comps], list(w.log)]
    assert [c.name for c in comps] == ["Guard", "Berserk"]


def case_execute_runs_enabled_components_each_frame(w, out):
    a = w.k.create_object("NPC", {})
    b = w.k.create_object("NPC", {})
    w.log.clear()
    w.pm.run_once()
    out.append([e for e in w.log if e[1] == "execute"])
    w.cm.set_enable(a, "Berserk", True)
    w.cm.set_enable(b, "Guard", False)
    out.append(w.cm.set_enable(b, "Nope", True))
    w.log.clear()
    w.pm.run_once()
    out += [[e for e in w.log if e[1] == "execute"], w.pm.frame]
    assert [e[0] for e in out[-2]] == ["Guard", "Berserk"]


def case_detach_on_destroy_calls_before_shut(w, out):
    g = w.k.create_object("NPC", {})
    w.log.clear()
    w.k.destroy_object(g)
    out += [list(w.log), w.cm.components_of(g), w.cm.find(g, "Guard") is None]
    assert [e[1] for e in w.log] == ["before_shut", "before_shut"]


def case_manual_attach_and_find(w, out):
    g = w.k.create_object("IObject", {})
    out.append(w.cm.components_of(g))
    inst = w.cm.attach(g, "Guard")
    out += [inst is not None and w.cm.find(g, "Guard") is inst, w.cm.attach(g, "Nope"),
            type(w.cm.attach(g, inst)).__name__, len(w.cm.components_of(g)), list(w.log)]
    assert out[1] is True and out[2] is None


def case_scripted_component_drives_device_world(w, out):
    w.cm.register(w.RageDriver)
    hurt = w.k.create_object("NPC", {"HP": 3})
    fine = w.k.create_object("NPC", {"HP": 50})
    for g in (hurt, fine):
        w.cm.attach(g, "RageDriver")
    for _ in range(4):
        w.pm.run_once()
    col = w.k.store.spec("NPC").slot("Rage").col
    out += [w.k.get_property(hurt, "Rage"), w.k.get_property(fine, "Rage"),
            int(np.asarray(w.k.state.classes["NPC"].i32[:, col]).sum())]
    assert out == [4, 0, 4]


CASES = {f.__name__[5:]: f for f in (
    case_schema_attach_on_create_finish,
    case_execute_runs_enabled_components_each_frame,
    case_detach_on_destroy_calls_before_shut,
    case_manual_attach_and_find,
    case_scripted_component_drives_device_world,
)}


@pytest.mark.parametrize("case", list(CASES))
def test_component_case_matches_jax(case):
    a, b = _pkg(True), _pkg(False)
    oa, ob = [], []
    CASES[case](a, oa)
    CASES[case](b, ob)
    assert ob == oa
    assert_tree_equal(jax_tree(a.k.state), state_to_numpy(b.k.state))


class _Counter(Module):
    """A module with one device phase that bumps tick-visible state."""

    name = "CounterModule"

    def __init__(self, step):
        super().__init__()
        self.step = step
        self.add_phase("count", lambda st, ctx: st, order=10)


def test_plugin_manager_find_manifest_and_reload(tmp_path, monkeypatch):
    """find_module / find_module_by_name, a Plugin.xml manifest loading a
    plugin from an import path, and a hot reload that swaps the plugin's
    modules and rebuilds the phase chain (the captured tick is dropped)."""
    src = tmp_path / "nf_plugin_probe.py"
    src.write_text(
        "from noahgameframe_tpu_torch.kernel.plugin import Plugin\n"
        "from test_torch_component import _Counter\n"
        "STEP = 1\n"
        "def create_plugin(pm):\n"
        "    return Plugin('ProbePlugin', [_Counter(STEP)])\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    (tmp_path / "Plugin.xml").write_text(
        '<XML><Plugin Name="nf_plugin_probe"/></XML>')
    w = _pkg(False)
    assert w.pm.load_manifest(tmp_path / "Plugin.xml") == 1
    assert w.pm.find_module(_Counter).step == 1
    assert w.pm.find_module_by_name("ComponentModule") is w.cm
    with pytest.raises(KeyError):
        w.pm.find_module(tp.PluginManager)
    with pytest.raises(ValueError, match="already registered"):
        w.pm.register_plugin(tp.Plugin("LogicPlugin"))
    with pytest.raises(KeyError, match="import path"):
        w.pm.reload_plugin("LogicPlugin")
    w.pm.run_once()
    gen = w.k.costbook.generation
    src.write_text(src.read_text().replace("STEP = 1", "STEP = 2"))
    sys.modules.pop("nf_plugin_probe", None)
    w.pm.reload_plugin("ProbePlugin")
    assert w.pm.find_module(_Counter).step == 2
    assert [p.name for p in w.k._composed] == ["CounterModule.count"]
    assert w.k.costbook.generation == gen + 1
    w.pm.run_once()
    w.pm.shutdown()
