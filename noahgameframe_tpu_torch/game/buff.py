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
that intermediate is about 1 GB.  Here the fold is ``ops/buff_cuda.py``'s
:func:`~..ops.buff_cuda.buff_fold`: on a card one launch of
``buff_fold_kernel``, on the CPU a sum over the R record rows into a
``[C, S]`` int32 accumulator, one gathered row at a time.  Integer
addition does not depend on order, so both give the same bits.  The
phase counts ``buffs_active`` (rows active after it) and
``buffs_expired`` (rows it freed) in the tick's counter bank.  The table
is a device tensor the captured tick closes over; ``define_buff`` and
``restore_state`` replace it, so its contents are part of
:meth:`BuffModule.capture_key` and a re-capture names
``BuffModule.table`` as its cause.

:meth:`BuffModule.apply_buffs` applies many buffs at once, leaving the
state that one application at a time, in order, would leave, with one
read of the touched entities' lists and one device write of each bank;
:meth:`BuffModule.apply_buff` is one such application.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.datatypes import Guid
from ..core.store import RecordOp, WorldState, with_class
from ..kernel.module import Module
from ..ops.buff_cuda import buff_fold
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
        """Add (or refresh) a timed buff on one entity: :meth:`apply_buffs`
        of one application lasting the kind's duration.  Reads the world's
        tick off the device (a host call, never inside the tick)."""
        idx = self._defs.get(buff_id)
        if idx is None:
            return False
        k = self.kernel
        cname, row = k.store.row_of(guid)
        ticks = int(round(self._durations[idx] / k.schedule.dt))
        return bool(self.apply_buffs(cname, [row], [idx], [ticks])[0])

    def apply_buffs(self, class_name: str, rows, kinds, ticks) -> np.ndarray:
        """Apply many timed buffs at once: application ``i`` gives entity
        row ``rows[i]`` of ``class_name`` the buff of config index
        ``kinds[i]``, lasting ``ticks[i]`` ticks (at least 1).  The
        applications take effect one after another in the order given, as
        upstream's AddRow/SetInt would: a used row of the same kind has its
        expiry refreshed (an UPDATE record event on ``ExpireTick``), else
        the first unused row takes the buff from the row's defaults (an ADD
        event), else (a full list) the application fails.  The touched
        entities' lists are read once and each bank written once.  Returns
        which applications took, as a bool array."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        kinds = np.asarray(kinds, np.int64).reshape(-1)
        took = np.zeros(rows.shape[0], bool)
        k = self.kernel
        spec = k.store.spec(class_name)
        if BUFF_RECORD not in spec.records or rows.size == 0:
            return took
        expire = int(k.state.tick) + np.maximum(1, np.asarray(ticks, np.int64).reshape(-1))
        known = np.flatnonzero((kinds >= 0) & (kinds < len(self._durations)))
        ents, ent_of = np.unique(rows[known], return_inverse=True)
        rs = spec.records[BUFF_RECORD]
        ci, ei = rs.cols["ConfigIdx"].col, rs.cols["ExpireTick"].col
        rec = k.state.classes[class_name].records[BUFF_RECORD]
        idx = torch.from_numpy(ents).to(k.device)
        i32 = rec.i32[idx].cpu().numpy()  # [E, R, cols]
        used = rec.used[idx].cpu().numpy()  # [E, R]
        # each application's turn among its entity's, in the order given;
        # turn j of every entity runs as one vectorized step
        order = np.argsort(ent_of, kind="stable")
        starts = np.searchsorted(ent_of[order], ent_of[order], side="left")
        turn = np.empty_like(ent_of)
        turn[order] = np.arange(order.size) - starts
        for j in range(int(turn.max()) + 1 if turn.size else 0):
            app = known[turn == j]
            e = ent_of[turn == j]
            same = used[e] & (i32[e, :, ci] == kinds[app][:, None])
            free = ~used[e]
            refresh = same.any(axis=1)
            slot = np.where(refresh, same.argmax(axis=1), free.argmax(axis=1))
            ok = refresh | free.any(axis=1)
            e, slot, app, refresh = e[ok], slot[ok], app[ok], refresh[ok]
            i32[e[~refresh], slot[~refresh]] = 0  # an added row starts from defaults
            i32[e, slot, ci] = kinds[app]
            i32[e, slot, ei] = expire[app]
            used[e, slot] = True
            took[app] = True
            for op, sel, tags in ((RecordOp.ADD, ~refresh, None),
                                  (RecordOp.UPDATE, refresh, ("ExpireTick",))):
                for r in np.unique(slot[sel]):
                    k.store._fire_record(class_name, BUFF_RECORD, op,
                                         rows[app[sel & (slot == r)]], int(r), tags)
        if ents.size:
            rec = rec.replace(
                i32=rec.i32.index_copy(0, idx, torch.from_numpy(i32).to(k.device)),
                used=rec.used.index_copy(0, idx, torch.from_numpy(used).to(k.device)))
            cs = k.state.classes[class_name]
            k.state = with_class(k.state, class_name,
                                 cs.replace(records={**cs.records, BUFF_RECORD: rec}))
        return took

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
        for cname, (rec_cols, cfg_col, exp_col) in self._rec_cols.items():
            cs = state.classes[cname]
            buf = cs.records[BUFF_RECORD]
            contrib, active = buff_fold(buf.i32, buf.used, table, ctx.tick, cfg_col, exp_col)
            ctx.count("buffs_active", active)
            ctx.count("buffs_expired", buf.used & ~active)
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
