"""Property module: stat groups, derived-stat recompute, HP/MP/SP/wallet.

Counterpart of ``noahgameframe_tpu/game/stats.py`` (reference
NFCPropertyModule, NFCPropertyModule.cpp:117-240): per-entity stat
contributions live in the CommPropertyValue record bank
``[C, NPG_ALL, S]``, so the whole class's recompute is one sum over the
group axis and one write into the property columns, every tick.  The host
API mirrors the reference's imperative one: group values, the (job,
level) base refresh, an immediate recompute, and add/consume/enough of
HP, MP, SP, money and diamond.  Each host write is a functional update of
the banks it touches.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.datatypes import Guid
from ..core.store import WorldState, set_column, with_class
from ..kernel.module import Module
from .defines import COMM_PROPERTY_RECORD, PropertyGroup, STAT_NAMES
from .property_config import PropertyConfigModule

STAT_ORDER = {n: i for i, n in enumerate(STAT_NAMES)}


class PropertyModule(Module):
    """Derived-stat recompute for every class that carries the
    CommPropertyValue record (Player, NPC)."""

    name = "PropertyModule"

    def __init__(self, classes: Sequence[str] = ("Player", "NPC"), order: int = 60):
        super().__init__()
        self.classes = tuple(classes)
        self._stat_cols: Dict[str, torch.Tensor] = {}  # class -> i32 prop cols
        self._rec_cols: Dict[str, torch.Tensor] = {}  # class -> record i32 cols
        self._rec_cols_host: Dict[str, np.ndarray] = {}
        self.add_phase("recompute", self._recompute_phase, order=order)

    def after_init(self) -> None:
        store = self.kernel.store
        for cname in self.classes:
            if cname not in store.class_index:
                continue
            spec = store.spec(cname)
            if COMM_PROPERTY_RECORD not in spec.records:
                continue
            rs = spec.records[COMM_PROPERTY_RECORD]
            dev = self.kernel.device
            self._stat_cols[cname] = torch.from_numpy(
                np.asarray([spec.slot(n).col for n in STAT_NAMES], np.int64)).to(dev)
            self._rec_cols_host[cname] = np.asarray(
                [rs.cols[n].col for n in STAT_NAMES], np.int64)
            self._rec_cols[cname] = torch.from_numpy(self._rec_cols_host[cname]).to(dev)

    def _recompute_phase(self, state: WorldState, ctx) -> WorldState:
        for cname, prop_cols in self._stat_cols.items():
            cs = state.classes[cname]
            rec = cs.records[COMM_PROPERTY_RECORD]
            # [C, NPG_ALL, S_rec] -> [C, S_rec]; unused rows are zero
            totals = torch.sum(rec.i32, dim=1, dtype=torch.int32)
            i32 = set_column(cs.i32, prop_cols, totals[:, self._rec_cols[cname]])
            state = with_class(state, cname, cs.replace(i32=i32))
        return state

    # -- group mutation (host control plane) ---------------------------------

    def set_group_value(self, guid: Guid, stat: str, group: PropertyGroup,
                        value: int) -> None:
        k = self.kernel
        k.state = k.store.record_set(k.state, guid, COMM_PROPERTY_RECORD, int(group),
                                     stat, int(value))

    def get_group_value(self, guid: Guid, stat: str, group: PropertyGroup) -> int:
        k = self.kernel
        return int(k.store.record_get(k.state, guid, COMM_PROPERTY_RECORD, int(group), stat))

    def add_group_value(self, guid: Guid, stat: str, group: PropertyGroup,
                        value: int) -> None:
        self.set_group_value(guid, stat, group,
                             self.get_group_value(guid, stat, group) + int(value))

    def sub_group_value(self, guid: Guid, stat: str, group: PropertyGroup,
                        value: int) -> None:
        self.add_group_value(guid, stat, group, -int(value))

    def refresh_base_property(self, guid: Guid, config: PropertyConfigModule) -> None:
        """Write the (job, level) base-stat row into NPG_JOBLEVEL
        (reference RefreshBaseProperty): one record write per stat."""
        k = self.kernel
        job = int(k.get_property(guid, "Job"))
        level = int(k.get_property(guid, "Level"))
        for stat in STAT_NAMES:
            self.set_group_value(guid, stat, PropertyGroup.JOBLEVEL,
                                 config.calculate_base_value(job, level, stat))

    def recompute_now(self, guid: Guid) -> None:
        """Fold one entity's group sums into its final properties now, for
        callers that read after writing before the next tick."""
        k = self.kernel
        cname, row = k.store.row_of(guid)
        rec = k.state.classes[cname].records[COMM_PROPERTY_RECORD]
        totals = torch.sum(rec.i32[row], dim=0, dtype=torch.int32).cpu().numpy()
        for stat in STAT_NAMES:
            rcol = self._rec_cols_host[cname][STAT_ORDER[stat]]
            k.set_property(guid, stat, int(totals[rcol]))

    # -- HP/MP/SP + wallet (reference NFIPropertyModule API) -----------------

    def full_hp_mp(self, guid: Guid) -> None:
        k = self.kernel
        for cur, mx in (("HP", "MAXHP"), ("MP", "MAXMP")):
            m = int(k.get_property(guid, mx))
            if m > 0:
                k.set_property(guid, cur, m)

    def full_sp(self, guid: Guid) -> None:
        k = self.kernel
        m = int(k.get_property(guid, "MAXSP"))
        if m > 0:
            k.set_property(guid, "SP", m)

    def _add(self, guid: Guid, prop: str, maxprop: Optional[str], value: int) -> bool:
        if value <= 0:
            return False
        k = self.kernel
        cur = int(k.get_property(guid, prop))
        if maxprop is not None:
            if cur <= 0:
                return True  # reference AddHP no-ops on dead entities
            cur = min(cur + value, int(k.get_property(guid, maxprop)))
        else:
            cur += value
        k.set_property(guid, prop, cur)
        return True

    def _consume(self, guid: Guid, prop: str, value: int) -> bool:
        k = self.kernel
        cur = int(k.get_property(guid, prop))
        if value <= 0 or cur < value:
            return False
        k.set_property(guid, prop, cur - value)
        return True

    def _enough(self, guid: Guid, prop: str, value: int) -> bool:
        return int(self.kernel.get_property(guid, prop)) >= value > 0

    def add_hp(self, g: Guid, v: int) -> bool:
        return self._add(g, "HP", "MAXHP", int(v))

    def consume_hp(self, g: Guid, v: int) -> bool:
        return self._consume(g, "HP", int(v))

    def enough_hp(self, g: Guid, v: int) -> bool:
        return self._enough(g, "HP", int(v))

    def add_mp(self, g: Guid, v: int) -> bool:
        return self._add(g, "MP", "MAXMP", int(v))

    def consume_mp(self, g: Guid, v: int) -> bool:
        return self._consume(g, "MP", int(v))

    def enough_mp(self, g: Guid, v: int) -> bool:
        return self._enough(g, "MP", int(v))

    def add_sp(self, g: Guid, v: int) -> bool:
        return self._add(g, "SP", "MAXSP", int(v))

    def consume_sp(self, g: Guid, v: int) -> bool:
        return self._consume(g, "SP", int(v))

    def enough_sp(self, g: Guid, v: int) -> bool:
        return self._enough(g, "SP", int(v))

    def add_money(self, g: Guid, v: int) -> bool:
        return self._add(g, "Gold", None, int(v))

    def consume_money(self, g: Guid, v: int) -> bool:
        return self._consume(g, "Gold", int(v))

    def enough_money(self, g: Guid, v: int) -> bool:
        return self._enough(g, "Gold", int(v))

    def add_diamond(self, g: Guid, v: int) -> bool:
        return self._add(g, "Money", None, int(v))

    def consume_diamond(self, g: Guid, v: int) -> bool:
        return self._consume(g, "Money", int(v))

    def enough_diamond(self, g: Guid, v: int) -> bool:
        return self._enough(g, "Money", int(v))
