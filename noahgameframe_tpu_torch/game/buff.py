"""Buffs: timed stat modifiers, expired and folded entirely on device.

Counterpart of ``noahgameframe_tpu/game/buff.py`` (reference NFCBuffModule,
``NFServer/NFGameLogicPlugin/NFCBuffModule.cpp``, which applies a buff's
property deltas per object and reverts them on a timer callback).

Active buffs are rows of the ``BuffList`` record (ConfigIdx into a
``[n_buffs, n_stats]`` config table, ExpireTick).  One phase per tick
computes, for every entity at once:

    active[C, R]  = used & (expire > tick)
    contrib[C, S] = sum_R table[clip(cfg[C, R])] * active
    RUNTIME_BUFF row of CommPropertyValue <- contrib

and clears the expired rows' used flags.  The stat recompute (order 60)
folds the group row into final stats; this phase runs at order 55.

The JAX package forms the ``[C, R, S]`` product and sums it; at 2^20 rows
that intermediate is about 1 GB, so here the sum accumulates over the R
record rows into a ``[C, S]`` int32 accumulator, one gathered row at a
time.  Integer addition does not depend on order, so the result is the
same bits.  The table is a device tensor the captured tick closes over;
``define_buff`` and ``restore_state`` replace it, so its contents are part
of :meth:`BuffModule.capture_key` and a re-capture names
``BuffModule.table`` as its cause.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.datatypes import Guid
from ..core.store import WorldState, with_class
from ..kernel.module import Module
from .defines import COMM_PROPERTY_RECORD, PropertyGroup, STAT_NAMES

BUFF_RECORD = "BuffList"


class BuffModule(Module):
    name = "BuffModule"

    def __init__(self, classes: Sequence[str] = ("Player", "NPC"),
                 order: int = 55) -> None:
        super().__init__()
        self.classes = tuple(classes)
        self._defs: Dict[str, int] = {}  # buff id -> config index
        self._durations: List[float] = []
        self._stats: List[List[int]] = []
        self._table: Optional[torch.Tensor] = None
        self._table_key: tuple = ()
        # class -> (stat record's i32 cols [S], ConfigIdx col, ExpireTick col)
        self._rec_cols: Dict[str, tuple] = {}
        self.add_phase("buffs", self._buff_phase, order=order)

    # ------------------------------------------------------- definitions
    def define_buff(self, buff_id: str, duration_s: float,
                    stats: Dict[str, int]) -> int:
        """Register (or redefine) a buff kind; returns its config index.
        The table is closed over by the captured tick, so any change
        invalidates it."""
        idx = self._defs.get(buff_id)
        if idx is None:
            idx = len(self._durations)
            self._defs[buff_id] = idx
            self._durations.append(0.0)
            self._stats.append([0] * len(STAT_NAMES))
        self._durations[idx] = float(duration_s)
        self._stats[idx] = [0] * len(STAT_NAMES)
        for stat, v in stats.items():
            self._stats[idx][STAT_NAMES.index(stat)] = int(v)
        self._rebuild_table()
        if self.kernel is not None:
            self.kernel.invalidate()
        return idx

    def _rebuild_table(self) -> None:
        """Build the config table on the host and move it to the world's
        device once, outside the tick."""
        rows = self._stats or [[0] * len(STAT_NAMES)]
        self._table_key = tuple(tuple(r) for r in rows)
        dev = self.kernel.device if self.kernel is not None else "cpu"
        self._table = torch.from_numpy(np.asarray(rows, np.int32)).to(dev)

    def capture_key(self) -> dict:
        return {"BuffModule.table": self._table_key}

    # ------------------------------------------------- checkpoint/resume
    def checkpoint_state(self) -> dict:
        return {
            "defs": self._defs,
            "durations": self._durations,
            "stats": self._stats,
        }

    def restore_state(self, data: dict) -> None:
        self._defs = {k: int(v) for k, v in data.get("defs", {}).items()}
        self._durations = [float(d) for d in data.get("durations", [])]
        self._stats = [[int(x) for x in row] for row in data.get("stats", [])]
        self._rebuild_table()
        if self.kernel is not None:
            self.kernel.invalidate()

    def after_init(self) -> None:
        self._rebuild_table()
        store = self.kernel.store
        for cname in self.classes:
            if cname not in store.class_index:
                continue
            spec = store.spec(cname)
            if BUFF_RECORD not in spec.records:
                continue
            if COMM_PROPERTY_RECORD not in spec.records:
                continue
            rs = spec.records[COMM_PROPERTY_RECORD]
            bs = spec.records[BUFF_RECORD]
            cols = torch.from_numpy(
                np.asarray([rs.cols[n].col for n in STAT_NAMES], np.int64)
            ).to(self.kernel.device)
            self._rec_cols[cname] = (cols, bs.cols["ConfigIdx"].col,
                                     bs.cols["ExpireTick"].col)

    # ------------------------------------------------------- host API
    def apply_buff(self, guid: Guid, buff_id: str) -> bool:
        """Add (or refresh) a timed buff on one entity.  Reads the world's
        tick off the device (a host call, never inside the tick)."""
        idx = self._defs.get(buff_id)
        if idx is None:
            return False
        k = self.kernel
        cname, _ = k.store.row_of(guid)
        if BUFF_RECORD not in k.store.spec(cname).records:
            return False
        expire = int(k.state.tick) + max(
            1, int(round(self._durations[idx] / k.schedule.dt))
        )
        rows = k.store.record_find_rows(k.state, guid, BUFF_RECORD,
                                        "ConfigIdx", idx)
        if rows:  # re-apply refreshes the expiry
            k.state = k.store.record_set(k.state, guid, BUFF_RECORD,
                                         rows[0], "ExpireTick", expire)
            return True
        try:
            k.state, _ = k.store.record_add_row(
                k.state, guid, BUFF_RECORD,
                {"ConfigIdx": idx, "ExpireTick": expire},
            )
        except RuntimeError:
            return False
        return True

    def active_buffs(self, guid: Guid) -> List[str]:
        k = self.kernel
        by_idx = {v: b for b, v in self._defs.items()}
        out = []
        cname, row = k.store.row_of(guid)
        if BUFF_RECORD not in k.store.spec(cname).records:
            return out
        rec = k.state.classes[cname].records[BUFF_RECORD]
        rs = k.store.spec(cname).records[BUFF_RECORD]
        used = rec.used[row].cpu().numpy()
        cfg = rec.i32[row, :, rs.cols["ConfigIdx"].col].cpu().numpy()
        exp = rec.i32[row, :, rs.cols["ExpireTick"].col].cpu().numpy()
        tick = int(k.state.tick)
        for r in np.flatnonzero(used & (exp > tick)):
            name = by_idx.get(int(cfg[r]))
            if name:
                out.append(name)
        return out

    # ------------------------------------------------------- device phase
    def _buff_phase(self, state: WorldState, ctx) -> WorldState:
        table = self._table
        if table is None:  # phase run before after_init (bare kernel)
            return state
        hi = table.shape[0] - 1
        for cname, (rec_cols, cfg_col, exp_col) in self._rec_cols.items():
            cs = state.classes[cname]
            buf = cs.records[BUFF_RECORD]
            cfg = buf.i32[:, :, cfg_col].clamp(0, hi)  # [C, R]
            active = buf.used & (buf.i32[:, :, exp_col] > ctx.tick)
            # gather each row's stat vector, mask, accumulate over R
            contrib = torch.zeros((cfg.shape[0], table.shape[1]),
                                  dtype=torch.int32, device=cfg.device)
            for r in range(cfg.shape[1]):
                contrib += table[cfg[:, r]] * active[:, r, None]
            stats_rec = cs.records[COMM_PROPERTY_RECORD]
            i32 = stats_rec.i32.clone()
            i32[:, int(PropertyGroup.RUNTIME_BUFF), rec_cols] = contrib
            records = {
                **cs.records,
                COMM_PROPERTY_RECORD: stats_rec.replace(i32=i32),
                BUFF_RECORD: buf.replace(used=active),  # expiry frees rows
            }
            state = with_class(state, cname, cs.replace(records=records))
        return state
