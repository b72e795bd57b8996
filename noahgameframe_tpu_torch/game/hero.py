"""Hero system: collection, leveling, stars, skills/talents, battle
line-up, and clone-scene summons.

Reference: NFCHeroModule (`NFServer/NFGameLogicPlugin/NFCHeroModule.cpp`,
443 LoC) over the PlayerHero record (Class/Player.xml:70-93) and the
PlayerFightHero line-up record (`:94-97`):
- AddHero (`:49-70`) appends a hero row;
- AddHeroExp (`:72-127`) levels on a progressive curve — each level
  costs (level+1) x ONCELEVEEXP, capped at HERO_MAXLEVEL
  (NFIHeroModule.h:21-23);
- HeroStarUp (`:129-161`) +1 star up to HERO_MAXSTAR;
- HeroSkillUp / HeroTalentUp (`:162-250`) walk the config chain via the
  skill/talent element's AfterUpID;
- SetFightHero (`:252-293`) places a hero at a battle position in
  PlayerFightHero;
- CreateHero / DestroyHero (`:295-367`) summon the hero as an NPC
  entity (MasterID = owner, owner's camp) in CLONE scenes only;
- HeroWearSkill (`:389-426`) picks the fight skill from the owned
  Skill1-5 set.

Design differences, on purpose: heroes are identified by their record
ROW (the reference's per-row GUID column exists only to find rows
again); add_hero dedupes by ConfigID and a duplicate add raises the
star instead (card-stacking — the reference appends duplicate rows);
the stat fold sums EVERY positioned fight hero's config stats x level
into the FIGHTING_HERO group (the reference's own NPG slot for the hero
lineup contribution, distinct from equipment's EQUIP_AWARD).

A copy of ``noahgameframe_tpu/game/hero.py``, which imports no jax: the
port keeps its own.  Record reads fetch the one entity's row to the host
(``_cpu``), so they work on a card's tensors too.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.datatypes import Guid
from ..kernel.module import Module
from .defines import STAT_NAMES, PropertyGroup

HERO_RECORD = "PlayerHero"
FIGHT_RECORD = "PlayerFightHero"
HERO_MAXLEVEL = 100  # NFIHeroModule.h:21
HERO_MAXSTAR = 100  # NFIHeroModule.h:22
ONCE_LEVEL_EXP = 100  # NFIHeroModule.h:23
SKILL_SLOTS = ("Skill1", "Skill2", "Skill3", "Skill4", "Skill5")
TALENT_SLOTS = ("Talent1", "Talent2", "Talent3", "Talent4", "Talent5")


class HeroModule(Module):
    name = "HeroModule"

    def __init__(self, properties, exp_per_level: int = ONCE_LEVEL_EXP,
                 max_level: int = HERO_MAXLEVEL,
                 max_star: int = HERO_MAXSTAR) -> None:
        super().__init__()
        self.properties = properties  # game.stats.PropertyModule
        self.exp_per_level = exp_per_level
        self.max_level = max_level
        self.max_star = max_star
        # owner -> summoned entity guid by hero row (transient control
        # plane; summons are entities, not persistent state)
        self._summons: Dict[Guid, Dict[int, Guid]] = {}
        self.scene_process = None  # wired by the world assembly

    def after_init(self) -> None:
        from ..kernel.kernel import ObjectEvent

        def on_player(guid: Guid, _cn: str, ev) -> None:
            if ev == ObjectEvent.DESTROY:
                self._summons.pop(guid, None)  # no growth on dead owners

        self.kernel.register_class_event(on_player, "Player")

    # ----------------------------------------------------------- helpers
    def _get(self, guid: Guid, row: int, tag: str):
        k = self.kernel
        return k.store.record_get(k.state, guid, HERO_RECORD, row, tag)

    def _set(self, guid: Guid, row: int, tag: str, value) -> None:
        k = self.kernel
        k.state = k.store.record_set(k.state, guid, HERO_RECORD, row,
                                     tag, value)

    def _hero_rows(self, guid: Guid) -> List[int]:
        k = self.kernel
        return k.store.record_used_rows(k.state, guid, HERO_RECORD)

    def hero_row_of(self, guid: Guid, config_id: str) -> Optional[int]:
        """GetHeroGUID analog: find the hero row by config
        (NFCHeroModule.cpp:369-387)."""
        rows = self.kernel.store.record_find_rows(
            self.kernel.state, guid, HERO_RECORD, "ConfigID", config_id)
        return rows[0] if rows else None

    # ------------------------------------------------------- collection
    def add_hero(self, guid: Guid, config_id: str) -> Optional[int]:
        """Add a hero; a duplicate ConfigID stacks a star instead of a
        second row (card-stacking; see module docstring).  Skill/talent
        slots initialize from the hero element config when present."""
        k = self.kernel
        existing = self.hero_row_of(guid, config_id)
        if existing is not None:
            self.hero_star_up(guid, existing)
            return existing
        values = {"ConfigID": config_id, "Level": 1, "Exp": 0, "Star": 1}
        elems = k.elements
        if elems.exists(config_id):
            cfg = elems.element(config_id).values
            for slot in SKILL_SLOTS + TALENT_SLOTS:
                v = str(cfg.get(slot, "") or "")
                if v:
                    values[slot] = v
        try:
            k.state, row = k.store.record_add_row(
                k.state, guid, HERO_RECORD, values)
        except RuntimeError:
            return None
        return row

    def hero_level(self, guid: Guid, row: int) -> int:
        return int(self._get(guid, row, "Level"))

    def add_hero_exp(self, guid: Guid, row: int, exp: int) -> int:
        """Progressive curve: level N -> N+1 costs (N+1) x exp_per_level,
        capped at max_level (AddHeroExp, NFCHeroModule.cpp:72-127);
        returns the hero's new level (0 on a bad row/exp)."""
        if exp <= 0 or row not in self._hero_rows(guid):
            return 0
        level = self.hero_level(guid, row)
        total = int(self._get(guid, row, "Exp")) + exp
        while level < self.max_level:
            need = (level + 1) * self.exp_per_level
            if total < need:
                break
            total -= need
            level += 1
        self._set(guid, row, "Exp", total)
        self._set(guid, row, "Level", level)
        if row in self._fight_rows(guid).values():
            self._refresh_fight_stats(guid)
        return level

    def hero_star(self, guid: Guid, row: int) -> int:
        return int(self._get(guid, row, "Star"))

    def hero_star_up(self, guid: Guid, row: int) -> bool:
        """+1 star, capped (HeroStarUp, NFCHeroModule.cpp:129-161)."""
        if row not in self._hero_rows(guid):
            return False
        self._set(guid, row, "Star",
                  min(self.hero_star(guid, row) + 1, self.max_star))
        return True

    # -------------------------------------------------- skills / talents
    def _chain_up(self, guid: Guid, row: int, slot: str) -> bool:
        """Shared HeroSkillUp/HeroTalentUp shape: the slot's current
        element names its successor via AfterUpID
        (NFCHeroModule.cpp:162-250)."""
        if row not in self._hero_rows(guid):
            return False
        cur = str(self._get(guid, row, slot))
        elems = self.kernel.elements
        if not cur or not elems.exists(cur):
            return False
        nxt = str(elems.element(cur).values.get("AfterUpID", "") or "")
        if not nxt:
            return False  # already the best in the chain
        self._set(guid, row, slot, nxt)
        return True

    def hero_skill_up(self, guid: Guid, row: int, index: int) -> bool:
        if not 1 <= index <= len(SKILL_SLOTS):
            return False
        return self._chain_up(guid, row, SKILL_SLOTS[index - 1])

    def hero_talent_up(self, guid: Guid, row: int, index: int) -> bool:
        if not 1 <= index <= len(TALENT_SLOTS):
            return False
        return self._chain_up(guid, row, TALENT_SLOTS[index - 1])

    def hero_wear_skill(self, guid: Guid, row: int, skill_id: str) -> bool:
        """FightSkill must be one of the hero's owned Skill1-5
        (HeroWearSkill, NFCHeroModule.cpp:389-426)."""
        if row not in self._hero_rows(guid):
            return False
        owned = {str(self._get(guid, row, s)) for s in SKILL_SLOTS}
        if not skill_id or skill_id not in owned:
            return False
        self._set(guid, row, "FightSkill", skill_id)
        return True

    # -------------------------------------------------- battle line-up
    def _fight_rows(self, guid: Guid) -> Dict[int, int]:
        """fight position -> hero record row, from PlayerFightHero."""
        k = self.kernel
        cname, erow = k.store.row_of(guid)
        rec = k.state.classes[cname].records.get(FIGHT_RECORD)
        if rec is None:
            return {}
        rs = k.store.spec(cname).records[FIGHT_RECORD]
        used = rec.used[erow].cpu().numpy()
        hero_col = rec.i32[erow, :, rs.cols["HeroRow"].col].cpu().numpy()
        return {
            int(p): int(hero_col[p]) - 1
            for p in np.flatnonzero(used)
            if hero_col[p] > 0
        }

    def set_fight_hero(self, guid: Guid, row: int, pos: int = 0) -> bool:
        """Place a hero at a battle position (SetFightHero,
        NFCHeroModule.cpp:252-293); re-placing a position overwrites it."""
        if row not in self._hero_rows(guid):
            return False
        k = self.kernel
        cname, erow = k.store.row_of(guid)
        spec = k.store.spec(cname)
        if not 0 <= pos < spec.records[FIGHT_RECORD].rec.max_rows:
            return False
        rec = k.state.classes[cname].records[FIGHT_RECORD]
        if bool(rec.used[erow, pos]):
            k.state = k.store.record_set(k.state, guid, FIGHT_RECORD, pos,
                                         "HeroRow", row + 1)
        else:
            k.state = k.store.record_restore_row(
                k.state, guid, FIGHT_RECORD, pos,
                {"HeroRow": row + 1, "FightPos": pos})
        self._refresh_fight_stats(guid)
        return True

    def fight_hero(self, guid: Guid, pos: int = 0) -> Optional[int]:
        return self._fight_rows(guid).get(pos)

    def _refresh_fight_stats(self, guid: Guid) -> None:
        """Sum of every positioned hero's config stats x level into the
        FIGHTING_HERO group (NFCHeroPropertyModule recompute shape)."""
        k = self.kernel
        elems = k.elements
        totals = {n: 0 for n in STAT_NAMES}
        for row in set(self._fight_rows(guid).values()):
            config_id = str(self._get(guid, row, "ConfigID"))
            level = self.hero_level(guid, row)
            vals = (elems.element(config_id).values
                    if elems.exists(config_id) else {})
            for n in STAT_NAMES:
                totals[n] += int(vals.get(n, 0) or 0) * level
        for n in STAT_NAMES:
            self.properties.set_group_value(
                guid, n, PropertyGroup.FIGHTING_HERO, totals[n]
            )

    # ------------------------------------------------------- summoning
    def create_hero(self, guid: Guid, row: int) -> Optional[Guid]:
        """Summon the hero as an NPC entity in the owner's scene —
        CLONE scenes only, owner's camp, MasterID = owner (CreateHero,
        NFCHeroModule.cpp:295-337)."""
        if row not in self._hero_rows(guid):
            return None
        k = self.kernel
        scene = int(k.get_property(guid, "SceneID"))
        group = int(k.get_property(guid, "GroupID"))
        from .scene_process import SCENE_TYPE_CLONE

        if (self.scene_process is not None
                and self.scene_process.scene_type(scene) != SCENE_TYPE_CLONE):
            return None
        live = self._summons.get(guid, {}).get(row)
        if live is not None and live in k.store.guid_map:
            return None  # already summoned
        # a summon destroyed from outside destroy_hero (clone-group
        # release, combat death) must not block re-summoning
        self._summons.get(guid, {}).pop(row, None)
        config_id = str(self._get(guid, row, "ConfigID"))
        npc = k.create_object(
            "NPC",
            {
                "ConfigID": config_id,
                "Camp": int(k.get_property(guid, "Camp")),
                "MasterID": guid,
                "Position": tuple(k.get_property(guid, "Position")),
            },
            scene=scene, group=group,
        )
        self._summons.setdefault(guid, {})[row] = npc
        return npc

    def destroy_hero(self, guid: Guid, row: int) -> bool:
        """Unsummon (DestroyHero, NFCHeroModule.cpp:339-367)."""
        npc = self._summons.get(guid, {}).pop(row, None)
        if npc is None or npc not in self.kernel.store.guid_map:
            return False
        self.kernel.destroy_object(npc)
        return True

    # ------------------------------------------------- checkpoint/resume
    def checkpoint_state(self) -> dict:
        # line-up and heroes live in records; summons are transient
        return {}

    def restore_state(self, data: dict) -> None:
        self._summons = {}
        # legacy round-4 checkpoints carried a fight_hero dict; replay it
        # into the PlayerFightHero record at position 0
        from ..core.datatypes import Guid as _Guid

        for g, row in data.get("fight_hero", {}).items():
            guid = _Guid.parse(g)
            if guid in self.kernel.store.guid_map:
                self.set_fight_hero(guid, int(row), 0)
