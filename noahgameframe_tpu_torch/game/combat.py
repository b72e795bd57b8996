"""Combat: AoE damage resolution, NPC death & respawn, and skill use.

Counterpart of ``CombatModule`` and ``SkillModule`` in
``noahgameframe_tpu/game/combat.py``.
Every alive entity is binned once into the cell tables (ops/stencil.py,
under the ``NF_BINNING`` engine, or through the Verlet cache of
ops/verlet.py when a skin is set); every entity then pulls incoming damage
from the nine neighbor cells within the skill radius, applies ``max(sum_atk - def, 0)``
(a hit always chips 1), and stamps the strongest in-range attacker as
LastAttacker.  The death sweep emits one batched BE_KILLED event and arms
the device-side respawn (HP restored after ``respawn_s``, keeping the row).

Engines (``use_pallas``, else the ``NF_PALLAS`` environment knob):

- ``0``: the plain PyTorch fold over the split victim/attacker tables
  (``ops.stencil_cuda.combat_fold_plain``).  On the card it runs only when
  asked for, as the anchor the kernels are held against.
- ``1``: the hand-written CUDA fold over the same split tables
  (``ops.stencil_cuda.combat_fold``).  The default on a CUDA device.
- ``2``: the fused CUDA kernel, gathering straight from an ``[N, 6]``
  feature bank through the slot assignments; it also yields the AOI
  occupancy count, which appears as the ``aoi_interest_pairs`` counter
  exactly when engine 2 ran.

On the CPU, engines 1 and 2 run their kernels' plain versions and the
default is 0.  Unlike the JAX package, engine 2 has no size gate: it
gathers from global memory, and at 1M rows the bank (about 24 MB) sits in
the H100's 50 MB L2, so it runs at 1M where the JAX package falls back to
engine 0 for lack of VMEM.  All engines give bit-identical state.

``verlet_skin`` (else ``NF_VERLET_SKIN``; <= 0 is off) widens the cells to
``max(cell_size, radius + skin)`` and gates the binning on displacement;
the cache rides ``WorldState.aux`` as ``verlet/<class>``, and the tick
counts ``grid_rebuilds``, ``grid_reuses`` and ``grid_cache_age``.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Optional

import numpy as np
import torch

from ..core.datatypes import Guid
from ..core.store import HANDLE_ROW_BITS, WorldState, set_column, with_class
from ..kernel.module import Module
from ..ops.stencil import (
    auto_bucket,
    binning_mode,
    build_cell_slots_pair,
    build_cell_table_pair,
    pull_slots,
    slots_from_assignment,
)
from ..ops.stencil_cuda import combat_fold, combat_fold_plain, fused_neighborhood
from ..ops.verlet import full_table, init_cache, refresh, skin_from_env, sub_slots, sub_table
from .defines import GameEvent

ATTACK_TIMER = "Attack"


class CombatModule(Module):
    """Batched AoE combat + death/respawn for one fighter class."""

    name = "CombatModule"

    def __init__(
        self,
        class_name: str = "NPC",
        extent: float = 512.0,
        radius: float = 4.0,
        cell_size: Optional[float] = None,
        bucket: Optional[int] = None,
        respawn_s: float = 5.0,
        attack_period_s: float = 1.0,
        order: int = 30,
        emit_events: bool = True,
        use_pallas: Optional[int] = None,
        verlet_skin: Optional[float] = None,
    ):
        super().__init__()
        self.class_name = class_name
        self.extent = float(extent)
        self.radius = float(radius)
        # None = the NF_VERLET_SKIN knob; a positive skin widens the cells
        # so the 3x3 stencil covers the radius from positions up to skin/2
        # stale
        self.verlet_skin = float(verlet_skin if verlet_skin is not None else skin_from_env())
        self.cell_size = float(cell_size if cell_size is not None else max(radius, 1.0))
        if self.verlet_skin > 0.0:
            self.cell_size = max(self.cell_size, self.radius + self.verlet_skin)
        self.width = max(1, int(self.extent / self.cell_size))
        # None = size buckets from capacity/cell density
        self.bucket = None if bucket is None else int(bucket)
        self.respawn_s = float(respawn_s)
        self.attack_period_s = float(attack_period_s)
        # False mutes the tick's overflow, be-killed and respawn events
        self.emit_events = emit_events
        # overflow surfacing: the tick emits ON_COMBAT_TABLE_OVERFLOW; the
        # host counts it, alerts past the budget and (auto_resize) doubles
        # the bucket so the drops stop
        self.overflow_budget = 1e-4  # dropped/alive alert threshold
        self.auto_resize = True
        self.max_bucket_boost = 8
        self._bucket_boost = 1
        self.overflow_last = (0, 0)  # (victims, attackers) of the latest tick
        self.overflow_total = 0
        self.overflow_alerts = 0
        self._overflow_log_muted = False
        self.use_pallas = use_pallas
        # fraction of the population the attacker table is sized for:
        # arm_all(stagger=True) lowers it to dt/attack_period
        self._attacker_duty = 1.0
        self.add_phase("aoe", self._combat_phase, order=order)
        self.add_phase("death", self._death_phase, order=order + 5)

    # -- lifecycle -----------------------------------------------------------

    def init(self) -> None:
        self.kernel.schedule.register_timer(self.class_name, ATTACK_TIMER)
        if self.verlet_skin > 0.0:
            # a never-built cache rebuilds on the first tick; invalidate()
            # (a bucket boost) drops it with the captured tick
            k = self.kernel
            k.register_aux(self.aux_key,
                           lambda: init_cache(k.store.capacity(self.class_name), k.device))

    @property
    def aux_key(self) -> str:
        return f"verlet/{self.class_name}"

    def capture_key(self) -> dict:
        if self.class_name not in self.kernel.store.class_index:
            return {}
        cap = self.kernel.store.capacity(self.class_name)
        return {"engine": self.resolved_engine(), "binning": binning_mode(),
                "emit_events": self.emit_events,
                "verlet_skin": self.verlet_skin, "bucket": self.resolved_bucket(cap),
                "att_bucket": self.resolved_att_bucket(cap)}

    def after_init(self) -> None:
        if self.emit_events:
            self.kernel.events.subscribe_batch(
                int(GameEvent.ON_COMBAT_TABLE_OVERFLOW), self._on_overflow)

    def execute(self) -> None:
        # the overflow event fires only on drops: a drop-free frame reads
        # (0, 0) (module execute runs before the frame's device step)
        self.overflow_last = (0, 0)

    def _on_overflow(self, cname: str, _mask, params) -> None:
        """Host side of the overflow signal: count it, and on a budget
        breach alert and (``auto_resize``) double the bucket, up to
        ``max_bucket_boost``, invalidating the kernel, which drops the
        captured tick and the Verlet cache built for the old bucket.  The
        terminal state is logged once."""
        dv = int(params["dropped_victims"][0])
        da = int(params["dropped_attackers"][0])
        self.overflow_last = (dv, da)
        self.overflow_total += dv + da
        alive = int(self.kernel.store._hosts[cname].alloc_mask.sum())
        if alive <= 0 or (dv + da) / alive <= self.overflow_budget:
            return
        self.overflow_alerts += 1
        log = logging.getLogger("nf.combat")
        if self.auto_resize and self._bucket_boost < self.max_bucket_boost:
            self._bucket_boost *= 2
            self.kernel.invalidate()
            log.warning(
                "combat cell-table overflow: dropped %d/%d victims+attackers "
                "(budget %.4f%%) — bucket boosted x%d",
                dv + da, alive, self.overflow_budget * 100, self._bucket_boost)
        elif not self._overflow_log_muted:
            self._overflow_log_muted = True
            log.warning(
                "combat cell-table overflow: dropped %d/%d victims+attackers "
                "(budget %.4f%%) — auto-resize %s; further breaches are "
                "counted (overflow_alerts) but not logged",
                dv + da, alive, self.overflow_budget * 100,
                "exhausted" if self.auto_resize else "disabled")

    def arm_all(self, stagger: bool = True) -> None:
        """Arm the attack heartbeat on every live row; stagger=True spreads
        first firings over the attack period (``1 + row % interval``).  A
        duty change resizes the attacker table, so it invalidates the
        kernel (the captured tick and the Verlet cache)."""
        k = self.kernel
        rows = np.flatnonzero(k.state.classes[self.class_name].alive.cpu().numpy())
        interval = k.schedule.ticks_of(self.attack_period_s)
        delays = 1 + (rows % interval) if (stagger and interval > 1) else None
        k.state = k.schedule.set_timer_rows(
            k.state, self.class_name, rows, ATTACK_TIMER, self.attack_period_s,
            start_delay_ticks=delays)
        new_duty = (1.0 / interval) if delays is not None else 1.0
        if new_duty != self._attacker_duty:
            self._attacker_duty = new_duty
            k.invalidate()

    def resolved_bucket(self, capacity: int) -> int:
        """The victim cell-table bucket size the combat phase uses."""
        base = self.bucket if self.bucket is not None else auto_bucket(capacity, self.width)
        return min(int(base * self._bucket_boost), max(capacity, 1))

    def resolved_att_bucket(self, capacity: int) -> int:
        """The attacker table bucket: sized for the instantaneous attacker
        density (capacity * duty), never larger than the victim bucket."""
        if self._attacker_duty >= 1.0:
            return self.resolved_bucket(capacity)
        eff = max(1, int(math.ceil(capacity * self._attacker_duty)))
        return min(auto_bucket(eff, self.width, lo=4, align=2) * self._bucket_boost,
                   self.resolved_bucket(capacity))

    def resolved_engine(self) -> int:
        """0, 1 or 2 (see the module docstring).  ``use_pallas`` wins when
        set; otherwise ``NF_PALLAS``; unset means 1 on a CUDA device and 0
        on the CPU.  Unknown values raise."""
        mode = self.use_pallas
        if mode is None:
            raw = os.environ.get("NF_PALLAS", "").strip()
            if raw not in ("", "0", "1", "2"):
                raise ValueError(f"NF_PALLAS={raw!r}: expected one of '', '0', '1', '2'")
            if raw:
                return int(raw)
            return 1 if self.kernel.device.type == "cuda" else 0
        mode = int(mode)
        if mode not in (0, 1, 2):
            raise ValueError(f"use_pallas={mode!r}: expected 0, 1 or 2")
        return mode

    # -- device phases -------------------------------------------------------

    def _combat_phase(self, state: WorldState, ctx) -> WorldState:
        cname = self.class_name
        store = ctx.store
        if cname not in store.class_index:
            return state
        spec = store.spec(cname)
        cs = state.classes[cname]
        pos = cs.vec[:, spec.slot("Position").col, :2]
        hp_col = spec.slot("HP").col
        hp = cs.i32[:, hp_col]
        atk = cs.i32[:, spec.slot("ATK_VALUE").col]
        deff = cs.i32[:, spec.slot("DEF_VALUE").col]
        camp = (cs.i32[:, spec.slot("Camp").col] if spec.has_property("Camp")
                else torch.zeros_like(hp))

        attacking = ctx.fired(cname, ATTACK_TIMER) & cs.alive & (hp > 0)
        if spec.has_property("SKILL_GATE"):
            attacking = attacking & (cs.i32[:, spec.slot("SKILL_GATE").col] == 0)

        n = pos.shape[0]
        bucket = self.resolved_bucket(n)
        att_bucket = self.resolved_att_bucket(n)
        engine = self.resolved_engine()
        f32 = torch.float32
        camp_f = camp.to(f32)
        scene_f = cs.i32[:, spec.slot("SceneID").col].to(f32)
        group_f = cs.i32[:, spec.slot("GroupID").col].to(f32)
        eff_atk = torch.where(attacking, atk, 0).to(f32)
        nbr = None
        # the split tables' features; the fused engine gathers from one
        # bank instead (the attacker row is the gather index)
        vic_feats = att_feats = None
        if engine != 2:
            rows_f = torch.arange(n, dtype=f32, device=pos.device)
            vic_feats = torch.stack([pos[:, 0], pos[:, 1], camp_f, scene_f, group_f], -1)
            att_feats = torch.stack(
                [pos[:, 0], pos[:, 1], eff_atk, camp_f, scene_f, group_f, rows_f], -1)
        if self.verlet_skin > 0.0:
            # displacement-gated binning (ops/verlet.py): the folds mask by
            # the true radius on current positions, so results equal a
            # rebuild every tick
            cache, rebuilt = refresh(state.aux[self.aux_key], pos, cs.alive, self.cell_size,
                                     self.width, bucket, self.verlet_skin)
            n_cells = self.width * self.width
            if engine == 2:
                vic_bin = slots_from_assignment(cs.alive, cache.slot_of, n_cells,
                                                self.cell_size, self.width, bucket)
                att_bin = slots_from_assignment(
                    attacking, sub_slots(cache, attacking, n_cells, att_bucket), n_cells,
                    self.cell_size, self.width, att_bucket)
            else:
                vic_bin = full_table(cache, vic_feats, cs.alive, n_cells, self.cell_size,
                                     self.width, bucket)
                att_bin = sub_table(cache, attacking, att_feats, n_cells, self.cell_size,
                                    self.width, att_bucket)
            ctx.count("grid_rebuilds", rebuilt)
            ctx.count("grid_reuses", 1 - rebuilt)
            ctx.count("grid_cache_age", cache.age)
            state = state.replace(aux={**state.aux, self.aux_key: cache})
        elif engine == 2:
            # one key pass feeds both slot assignments, no payloads
            vic_bin, att_bin = build_cell_slots_pair(
                pos, cs.alive, attacking, self.cell_size, self.width, bucket, att_bucket)
        else:
            # TWO tables from one key pass: every alive entity is resident
            # as a victim, only this tick's attackers ride the scanned side
            vic_bin, att_bin = build_cell_table_pair(
                pos, cs.alive, vic_feats, attacking, att_feats,
                self.cell_size, self.width, bucket, att_bucket)
        if engine == 2:
            bank = torch.stack([pos[:, 0], pos[:, 1], camp_f, scene_f, group_f, eff_atk], -1)
            inc, bestr, nbr = fused_neighborhood(bank, vic_bin, att_bin, self.radius)
        else:
            fold = combat_fold if engine == 1 else combat_fold_plain
            inc, bestr = fold(vic_bin, att_bin, self.radius)
        if self.emit_events:
            # row 0 carries the overflow flag; padded out of place, so it
            # batches under torch.func.vmap
            mask0 = torch.nn.functional.pad(
                ((vic_bin.dropped + att_bin.dropped) > 0).reshape(1), (0, n - 1))
            ctx.emit(
                int(GameEvent.ON_COMBAT_TABLE_OVERFLOW), cname, mask0,
                dropped_victims=vic_bin.dropped.expand(n),
                dropped_attackers=att_bin.dropped.expand(n),
            )
        ctx.count("aoi_victim_overflow_drops", vic_bin.dropped)
        ctx.count("aoi_attacker_overflow_drops", att_bin.dropped)
        pulled = pull_slots(vic_bin.slot_of, torch.stack([inc, bestr], dim=-1), fill=(0, -1))
        if nbr is not None:
            # the AOI occupancy count is a counter, not state, so digests
            # stay bit-identical across engines
            ctx.count("aoi_interest_pairs", pull_slots(vic_bin.slot_of, nbr, fill=0))
        # dead-but-not-yet-respawned victims take no damage
        incoming = torch.where(cs.alive & (hp > 0), pulled[:, 0], 0)
        dmg = torch.clamp(incoming - deff, min=0)
        dmg = torch.where(incoming > 0, torch.clamp(dmg, min=1), 0)  # a hit always chips
        ctx.count("combat_hits", incoming > 0)
        ctx.count("combat_damage_total", dmg)
        i32 = set_column(cs.i32, hp_col, torch.clamp(hp - dmg, min=0))

        if spec.has_property("LastAttacker"):
            # strongest in-range attacker, packed as an object handle
            handle = (store.class_index[cname] << HANDLE_ROW_BITS) | torch.clamp(pulled[:, 1], min=0)
            la_col = spec.slot("LastAttacker").col
            i32[:, la_col] = torch.where(incoming > 0, handle, i32[:, la_col])
        return with_class(state, cname, cs.replace(i32=i32))

    def _death_phase(self, state: WorldState, ctx) -> WorldState:
        cname = self.class_name
        store = ctx.store
        if cname not in store.class_index:
            return state
        spec = store.spec(cname)
        if not spec.has_property("DeadTick"):
            return state
        cs = state.classes[cname]
        hp_col = spec.slot("HP").col
        dead_col = spec.slot("DeadTick").col
        hp = cs.i32[:, hp_col]
        dead_tick = cs.i32[:, dead_col]

        just_died = cs.alive & (hp <= 0) & (dead_tick == 0)
        if self.emit_events:
            params = {}
            if spec.has_property("LastAttacker"):
                params["killer"] = cs.i32[:, spec.slot("LastAttacker").col]
            ctx.emit(int(GameEvent.ON_OBJECT_BE_KILLED), cname, just_died, **params)
        # DeadTick stores tick+1 so tick 0 deaths are distinguishable from 0
        i32 = set_column(cs.i32, dead_col, torch.where(just_died, ctx.tick + 1, dead_tick))

        respawn_ticks = max(1, int(round(self.respawn_s / ctx.dt)))
        due = (dead_tick > 0) & (ctx.tick + 1 - dead_tick >= respawn_ticks) & cs.alive
        if spec.has_property("MAXHP"):
            maxhp = cs.i32[:, spec.slot("MAXHP").col]
            # no MAXHP stat -> nothing to restore -> stay dead
            due = due & (maxhp > 0)
            i32[:, hp_col] = torch.where(due, maxhp, i32[:, hp_col])
        else:
            due = torch.zeros_like(due)
        i32[:, dead_col] = torch.where(due, 0, i32[:, dead_col])
        ctx.count("respawns", due)
        if self.emit_events:
            ctx.emit(int(GameEvent.ON_NPC_RESPAWN), cname, due)
        return with_class(state, cname, cs.replace(i32=i32))


class SkillModule(Module):
    """Host-side targeted skill use (reference NFCSkillModule parity)."""

    name = "SkillModule"

    def __init__(self, skill_damage: int = 10):
        super().__init__()
        self.skill_damage = int(skill_damage)

    def use_skill(self, attacker: Guid, skill_id: str, target: Guid) -> bool:
        """Validate the skill element, damage the target by
        ``skill_damage`` (floor 0) and stamp LastAttacker
        (NFCSkillModule.cpp:113-139)."""
        k = self.kernel
        if not k.elements.exists(skill_id):
            return False
        if target not in k.store.guid_map:
            return False
        tclass, _ = k.store.row_of(target)
        cur = int(k.get_property(target, "HP"))
        if cur <= 0:
            return False
        if k.store.spec(tclass).has_property("LastAttacker"):
            k.set_property(target, "LastAttacker", attacker)
        k.set_property(target, "HP", max(cur - self.skill_damage, 0))
        return True
