"""Plugin template — the NFMidWare-style extension point, on the PyTorch port.

The port's counterpart of examples/plugin_template.py.  The reference
ships 11 nearly-identical middleware plugin skeletons (`NFMidWare/`,
SURVEY §2.9); this file is the equivalent template for the port.  Copy
it, rename the module, and either:

- register it programmatically:   pm.register_plugin(create_plugin(pm))
- or list it in a Plugin.xml manifest and call pm.load_manifest(path):
      <XML><Plugin Name="torch_plugin_template"/></XML>
  (the manifest imports the module by name: put its folder on sys.path)

A module can hook the world three ways, shown below:
1. host lifecycle + per-frame `execute()` (control plane),
2. kernel events/property subscriptions (reactive),
3. a device phase inside the world's tick (data plane): plain tensor ops
   on the banks, captured with the rest of the tick into its CUDA graph.
   It reads no value back to the host (no `.item()`, no `bool(t)`), builds
   no tensor from Python data, and takes no `Tensor.view(dtype)`.
"""

from __future__ import annotations

import torch

from noahgameframe_tpu_torch.core.store import WorldState, set_column, with_class
from noahgameframe_tpu_torch.kernel import Module, Plugin, PluginManager


class MyGameplayModule(Module):
    name = "MyGameplayModule"

    def __init__(self, drain_per_tick: int = 1) -> None:
        super().__init__()
        self.drain_per_tick = drain_per_tick
        # (3) a device phase: runs inside the tick, vectorized over every
        # entity.  Order picks its slot in the phase chain
        # (movement=30..50, combat=40, buffs=55, stat recompute=60).
        self.add_phase("mp_drain", self._drain_phase, order=58)

    # -- (1) host lifecycle ------------------------------------------------
    def init(self) -> None:
        # declare timers/schemas here; cross-module lookups via
        # self.kernel or a PluginManager.find_module(...) in after_init
        pass

    def after_init(self) -> None:
        # (2) reactive hooks: class events + property subscriptions
        self.kernel.register_property_event(
            "Player", "MP", self._on_mp_changed
        )

    def execute(self) -> None:
        # per-frame host work (network, persistence drains) — keep light
        pass

    def capture_key(self) -> dict:
        # host values the device phase closes over: a change captures the
        # tick's graph again
        return {"drain_per_tick": self.drain_per_tick}

    # -- handlers ----------------------------------------------------------
    def _on_mp_changed(self, cname: str, pname: str, rows) -> None:
        # rows: numpy indices of entities whose MP changed this frame
        pass

    # -- the device phase --------------------------------------------------
    def _drain_phase(self, state: WorldState, ctx) -> WorldState:
        """Example: every entity loses `drain_per_tick` MP per tick,
        floored at 0 — one fused vector op for the whole class."""
        cname = "Player"
        if cname not in ctx.store.class_index:
            return state
        spec = ctx.store.spec(cname)
        if not spec.has_property("MP"):
            return state
        cs = state.classes[cname]
        col = spec.slot("MP").col
        mp = cs.i32[:, col]
        # only touch live rows; dead rows keep their values
        new_mp = torch.where(cs.alive, torch.clamp_min(mp - self.drain_per_tick, 0), mp)
        return with_class(state, cname, cs.replace(i32=set_column(cs.i32, col, new_mp)))


def create_plugin(pm: PluginManager) -> Plugin:
    """Entry point the manifest loader calls (DllStartPlugin parity)."""
    return Plugin("MyGameplayPlugin", [MyGameplayModule()])
