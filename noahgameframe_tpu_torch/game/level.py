"""Level module: the batched level-up phase.

Counterpart of the device phase of ``noahgameframe_tpu/game/level.py``:
exp accrued in the ``EXP`` column converts to (level, rem) through one
searchsorted over cumulative MAXEXP thresholds
(PropertyConfigModule.level_from_total_exp).  On a level change the
NPG_JOBLEVEL stat row is rewritten from the (job, level) table and
HP/MP/SP refill from the new maxima; ON_LEVEL_UP is emitted with the
old/new levels.  The host ``add_exp`` does the same for one entity at
once, with the reference's loop (NFCLevelModule.cpp:38-69).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.datatypes import Guid
from ..core.store import WorldState, set_column, with_class
from ..kernel.module import Module
from .defines import COMM_PROPERTY_RECORD, GameEvent, PropertyGroup, STAT_NAMES
from .property_config import PropertyConfigModule
from .stats import PropertyModule


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[c, idx[c]] for every row c."""
    return torch.gather(table, 1, idx.long()[:, None])[:, 0]


class LevelModule(Module):
    name = "LevelModule"

    def __init__(self, config: PropertyConfigModule,
                 properties: Optional[PropertyModule] = None,
                 class_name: str = "Player", order: int = 50):
        super().__init__()
        self.config = config
        self.properties = properties
        self.class_name = class_name
        # before the stat recompute (order 60) so a level-up's new JOBLEVEL
        # row lands in the same tick's final stats
        self.add_phase("level", self._level_phase, order=order)
        self._rec_cols: Optional[torch.Tensor] = None  # stat columns of the record

    def after_init(self) -> None:
        spec = self.kernel.store.spec(self.class_name)
        if COMM_PROPERTY_RECORD in spec.records:
            rs = spec.records[COMM_PROPERTY_RECORD]
            self._rec_cols = torch.tensor(
                [rs.cols[n].col for n in STAT_NAMES], device=self.kernel.device)

    def _level_phase(self, state: WorldState, ctx) -> WorldState:
        cname = self.class_name
        store = ctx.store
        cfg = self.config
        if cname not in store.class_index:
            return state
        spec = store.spec(cname)
        if not spec.has_property("Job") or cfg.cum_exp is None:
            return state
        cs = state.classes[cname]
        job = store.column(state, cname, "Job")
        level_col = spec.slot("Level").col
        exp_col = spec.slot("EXP").col
        maxexp_col = spec.slot("MAXEXP").col

        old_level = cs.i32[:, level_col]
        exp_in_level = cs.i32[:, exp_col]
        # total accumulated exp = cum threshold of current level + exp within
        j = job.clamp(0, cfg.n_jobs - 1).long()
        lvl_idx = old_level.clamp(0, cfg.max_level)
        total = _take(cfg.cum_exp[j], lvl_idx) + exp_in_level
        new_level, rem = cfg.level_from_total_exp(job, total)
        # a job with no MAXEXP configured at the current level cannot level
        can_level = cs.alive & (_take(cfg.max_exp[j], lvl_idx) > 0)
        new_level = torch.where(can_level, torch.maximum(new_level, old_level), old_level)
        rem = torch.where(can_level, rem, exp_in_level)

        leveled = new_level != old_level
        i32 = set_column(cs.i32, level_col, new_level)
        i32[:, exp_col] = rem
        i32[:, maxexp_col] = _take(cfg.max_exp[j], new_level.clamp(0, cfg.max_level))
        cs = cs.replace(i32=i32)

        # refresh the NPG_JOBLEVEL row of leveled entities and refill
        # HP/MP/SP from the new maxima (the recompute phase folds the row
        # into MAXHP etc.; the maxima come from the group sums here)
        if COMM_PROPERTY_RECORD in spec.records:
            rs = spec.records[COMM_PROPERTY_RECORD]
            rec = cs.records[COMM_PROPERTY_RECORD]
            rec_cols = self._rec_cols
            grp = int(PropertyGroup.JOBLEVEL)
            job_row = rec.i32[:, grp, :]
            updated = job_row.clone()
            updated[:, rec_cols] = cfg.base_stats_for(job, new_level)
            rec_i32 = rec.i32.clone()
            rec_i32[:, grp, :] = torch.where(leveled[:, None], updated, job_row)
            rec = rec.replace(i32=rec_i32)
            totals = torch.sum(rec_i32, dim=1, dtype=torch.int32)  # [C, S_rec]
            i32 = cs.i32.clone()
            for cur, mx in (("HP", "MAXHP"), ("MP", "MAXMP"), ("SP", "MAXSP")):
                if not spec.has_property(cur):
                    continue
                mcol = totals[:, rs.cols[mx].col]
                ccol = spec.slot(cur).col
                i32[:, ccol] = torch.where(leveled & (mcol > 0), mcol, i32[:, ccol])
            cs = cs.replace(i32=i32, records={**cs.records, COMM_PROPERTY_RECORD: rec})

        ctx.emit(int(GameEvent.ON_LEVEL_UP), cname, leveled & cs.alive,
                 old_level=old_level, new_level=new_level)
        return with_class(state, cname, cs)

    # -- host API (reference NFILevelModule) ---------------------------------

    def add_exp(self, guid: Guid, exp: int) -> int:
        """Immediate AddExp with full level-up semantics; returns the
        level.  The device phase does the same batch-wise at the next
        tick."""
        k = self.kernel
        job = int(k.get_property(guid, "Job"))
        level = int(k.get_property(guid, "Level"))
        cur = int(k.get_property(guid, "EXP")) + int(exp)
        max_exp = self.config.calculate_base_value(job, level, "MAXEXP")
        leveled = False
        while max_exp > 0 and cur >= max_exp and level < self.config.max_level:
            cur -= max_exp
            level += 1
            leveled = True
            max_exp = self.config.calculate_base_value(job, level, "MAXEXP")
        k.set_property(guid, "EXP", cur)
        if leveled:
            k.set_property(guid, "Level", level)
            k.set_property(guid, "MAXEXP", max_exp)
            if self.properties is not None:
                self.properties.refresh_base_property(guid, self.config)
                self.properties.recompute_now(guid)
                self.properties.full_hp_mp(guid)
                self.properties.full_sp(guid)
        return level
