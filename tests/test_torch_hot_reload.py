"""End-to-end hot reload on the port after tests/test_hot_reload.py:
rewrite a plugin's source on disk, reload it live, and the next tick
runs the new phase while world state survives (reference
NFCPluginManager::ReLoadPlugin).  The plugin writes its column on a
clone of the bank, the port's form of JAX's ``.at[...].add``."""

import sys
import textwrap
from pathlib import Path

import numpy as np

from noahgameframe_tpu_torch.core import StoreConfig
from noahgameframe_tpu_torch.kernel import Kernel, Plugin, PluginManager

from fixtures import base_registry
from test_torch_scene import port_registry
from test_torch_parity import one_intra_op_thread  # noqa: F401

PLUGIN_V1 = """
from noahgameframe_tpu_torch.kernel.module import Module
from noahgameframe_tpu_torch.core.store import with_class
from noahgameframe_tpu_torch.kernel.plugin import Plugin

GAIN = {gain}


class GainModule(Module):
    name = "GainModule"

    def __init__(self):
        super().__init__()
        self.add_phase("gain", self._phase, order=10)

    def _phase(self, state, ctx):
        cs = state.classes["Player"]
        spec = ctx.store.spec("Player")
        col = spec.slot("EXP").col
        i32 = cs.i32.clone()
        i32[:, col] += GAIN
        return with_class(state, "Player", cs.replace(i32=i32))


def create_plugin(pm):
    return Plugin("GainPlugin", [GainModule()])
"""


def test_hot_reload_swaps_device_phase(tmp_path):
    pkg = tmp_path / "hotreload_torch_pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    mod = pkg / "gain_plugin.py"
    mod.write_text(textwrap.dedent(PLUGIN_V1.format(gain=1)))
    sys.path.insert(0, str(tmp_path))
    try:
        pm = PluginManager()
        kernel = Kernel(
            port_registry(base_registry()), StoreConfig(default_capacity=16),
            class_names=["IObject", "Player", "NPC"], device="cpu",
        )
        pm.register_plugin(Plugin("KernelPlugin", [kernel]))
        pm.load_plugin_module("hotreload_torch_pkg.gain_plugin")
        pm.start()
        g = kernel.create_object("Player", {"Name": "R"})
        kernel.tick()
        kernel.tick()
        assert kernel.get_property(g, "EXP") == 2  # +1 per tick

        # rewrite the source on disk; reload; the tick recompiles
        mod.write_text(textwrap.dedent(PLUGIN_V1.format(gain=10)))
        pm.reload_plugin("GainPlugin")
        kernel.tick()
        assert kernel.get_property(g, "EXP") == 12  # +10 now
        # identity survived the reload
        assert kernel.get_property(g, "Name") == "R"
        assert kernel.state.classes["Player"].alive.sum() == 1
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("hotreload_torch_pkg.gain_plugin", None)
        sys.modules.pop("hotreload_torch_pkg", None)
