"""Regen module: HPREGEN/MPREGEN/SPREGEN applied on a heartbeat.

Counterpart of ``noahgameframe_tpu/game/regen.py``: one ``Regen`` timer
slot per class drives a fused phase — fired & alive & HP>0 rows add their
regen stats, clamped to the MAX stats.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.store import WorldState, set_column, with_class
from ..kernel.module import Module

REGEN_TIMER = "Regen"
_CHANNELS = (("HP", "MAXHP", "HPREGEN"), ("MP", "MAXMP", "MPREGEN"), ("SP", "MAXSP", "SPREGEN"))


class RegenModule(Module):
    name = "RegenModule"

    def __init__(self, classes: Sequence[str] = ("Player", "NPC"),
                 period_s: float = 1.0, order: int = 40):
        super().__init__()
        self.classes = tuple(classes)
        self.period_s = float(period_s)
        self.add_phase("regen", self._regen_phase, order=order)

    def init(self) -> None:
        for cname in self.classes:
            self.kernel.schedule.register_timer(cname, REGEN_TIMER)

    def arm_all(self, class_name: str) -> None:
        k = self.kernel
        rows = np.flatnonzero(k.state.classes[class_name].alive.cpu().numpy())
        k.state = k.schedule.set_timer_rows(
            k.state, class_name, rows, REGEN_TIMER, self.period_s)

    def arm(self, guid) -> None:
        k = self.kernel
        k.state = k.schedule.set_timer(k.state, k.store, guid, REGEN_TIMER, self.period_s)

    def _regen_phase(self, state: WorldState, ctx) -> WorldState:
        for cname in self.classes:
            if cname not in ctx.store.class_index:
                continue
            spec = ctx.store.spec(cname)
            if not spec.has_property("HPREGEN"):
                continue
            cs = state.classes[cname]
            fired = ctx.fired(cname, REGEN_TIMER) & cs.alive
            live = fired & (cs.i32[:, spec.slot("HP").col] > 0)  # the dead don't regenerate
            i32 = cs.i32
            for cur, mx, rg in _CHANNELS:
                if not (spec.has_property(cur) and spec.has_property(rg)):
                    continue
                c, m, r = (spec.slot(n).col for n in (cur, mx, rg))
                val, cap, reg = i32[:, c], i32[:, m], i32[:, r]
                regened = torch.minimum(val + reg, torch.maximum(cap, val))
                i32 = set_column(i32, c, torch.where(live & (reg > 0), regened, val))
            state = with_class(state, cname, cs.replace(i32=i32))
        return state
