"""Items: bag CRUD, use/consume dispatch, equipment stat contribution.

Reference modules (all in `NFServer/NFGameLogicPlugin/`):
- NFCPackModule — BagItemList (stackables keyed by ConfigID) and
  BagEquipList (unique rows with their own GUID) CRUD;
- NFCItemModule — `OnUseItem`: looks up the item element's ItemType and
  dispatches to the registered consume-process module for that family
  (`NFCItemModule.cpp:320-370`, ConsumeLegal → ConsumeProcess);
- NFCPotionItemConsumeProcessModule etc. — family-specific effects;
- NFCEquipModule / NFCEquipPropertyModule — wearing an equip folds its
  element-config stats into the NPG_EQUIP group, the stat recompute sums
  groups into final stats.

Item definitions are elements (per-instance config) with `ItemType`,
`ItemSubType`, `AwardValue` and optional stat columns — the same shape
the reference's Item.xlsx rows take.

A copy of ``noahgameframe_tpu/game/items.py``, which imports no jax: the
port keeps its own.  Record reads fetch the one entity's row to the host
(``_cpu``), so they work on a card's tensors too.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from ..core.datatypes import Guid
from ..kernel.module import Module
from .defines import STAT_NAMES, ItemSubType, ItemType, PropertyGroup

BAG_ITEMS = "BagItemList"
BAG_EQUIP = "BagEquipList"

# consume processor: (player guid, item config id, target) -> success.
# `target` is family-specific — a hero record row for card/hero awards,
# an equip record row for gems, None for self-targeted consumables —
# mirroring the reference's NFIDataList targetID parameter
# (NFCItemModule.cpp ConsumeProcess).
ConsumeFn = Callable[[Guid, str, object], bool]


class PackModule(Module):
    """Bag CRUD over the BagItemList / BagEquipList records
    (NFCPackModule).  Equip rows are unique (non-stacking) and identified
    by their record row — all equip state lives in the record banks, so
    checkpoints and player blobs restore it with no host-side registry.
    The WearGUID column marks a worn equip (it holds the owner's guid)."""

    name = "PackModule"

    def __init__(self) -> None:
        super().__init__()
        # fired as (owner, equip_row) when an equip row is removed so the
        # equip-stat module can drop its contribution
        self.on_equip_deleted: List = []

    # ----------------------------------------------------- stackables
    def _find_item_row(self, guid: Guid, config_id: str) -> Optional[int]:
        rows = self.kernel.store.record_find_rows(
            self.kernel.state, guid, BAG_ITEMS, "ConfigID", config_id
        )
        return rows[0] if rows else None

    def create_item(self, guid: Guid, config_id: str, count: int = 1) -> bool:
        """Add `count` of a stackable (stacks onto an existing row)."""
        k = self.kernel
        row = self._find_item_row(guid, config_id)
        if row is not None:
            cur = int(k.store.record_get(k.state, guid, BAG_ITEMS, row,
                                         "ItemCount"))
            k.state = k.store.record_set(k.state, guid, BAG_ITEMS, row,
                                         "ItemCount", cur + count)
            return True
        try:
            k.state, _ = k.store.record_add_row(
                k.state, guid, BAG_ITEMS,
                {"ConfigID": config_id, "ItemCount": count},
            )
        except RuntimeError:
            return False  # bag full
        return True

    def item_count(self, guid: Guid, config_id: str) -> int:
        k = self.kernel
        row = self._find_item_row(guid, config_id)
        if row is None:
            return 0
        return int(k.store.record_get(k.state, guid, BAG_ITEMS, row,
                                      "ItemCount"))

    def enough_item(self, guid: Guid, config_id: str, count: int = 1) -> bool:
        return self.item_count(guid, config_id) >= count

    def delete_item(self, guid: Guid, config_id: str, count: int = 1) -> bool:
        """Consume `count`; removes the row when it hits zero."""
        k = self.kernel
        row = self._find_item_row(guid, config_id)
        if row is None:
            return False
        cur = int(k.store.record_get(k.state, guid, BAG_ITEMS, row,
                                     "ItemCount"))
        if cur < count:
            return False
        if cur == count:
            k.state = k.store.record_remove_row(k.state, guid, BAG_ITEMS, row)
        else:
            k.state = k.store.record_set(k.state, guid, BAG_ITEMS, row,
                                         "ItemCount", cur - count)
        return True

    # ----------------------------------------------------- equipment
    def create_equip(self, guid: Guid, config_id: str) -> Optional[int]:
        """Add a unique equip; returns its record row (its identity)."""
        k = self.kernel
        try:
            k.state, row = k.store.record_add_row(
                k.state, guid, BAG_EQUIP, {"ConfigID": config_id}
            )
        except RuntimeError:
            return None
        return row

    def equips(self, guid: Guid) -> Dict[int, str]:
        """row -> config id, straight from the record (restore-safe)."""
        k = self.kernel
        cname, erow = k.store.row_of(guid)
        spec = k.store.spec(cname)
        if BAG_EQUIP not in spec.records:
            return {}
        rec = k.state.classes[cname].records[BAG_EQUIP]
        rs = spec.records[BAG_EQUIP]
        used = rec.used[erow].cpu().numpy()
        cfg_col = rec.i32[erow, :, rs.cols["ConfigID"].col].cpu().numpy()
        return {
            int(r): k.store.strings.lookup(int(cfg_col[r]))
            for r in np.flatnonzero(used)
        }

    def delete_equip(self, guid: Guid, row: int) -> bool:
        if row not in self.equips(guid):
            return False
        k = self.kernel
        k.state = k.store.record_remove_row(k.state, guid, BAG_EQUIP, row)
        for fn in self.on_equip_deleted:
            fn(guid, row)
        return True


class ItemModule(Module):
    """Use-item pipeline with per-family consume processors — the full
    NFC*ConsumeProcessModule family (NFCItemModule.cpp dispatch +
    NFCPotionItem/NFCItemToken/NFCItemEquip/NFCItemGem/NFCItemCard/
    NFCHeroItem/NFCRebornItem ConsumeProcessModule.cpp).  Several of the
    reference processors are empty skeletons (gem/equip return 1 with no
    effect, reborn is commented out); here every family has a real,
    tested effect — documented per-processor."""

    name = "ItemModule"

    def __init__(self, pack: PackModule) -> None:
        super().__init__()
        self.pack = pack
        self._processors: Dict[int, ConsumeFn] = {}
        self.max_sockets = 6
        # wired by the world assembly; processors degrade gracefully
        self.heroes = None  # game.hero.HeroModule (card/hero awards)
        self.equip = None  # game.items.EquipModule (gem refresh)
        self.level = None  # game.level.LevelModule (EXP items)

    def after_init(self) -> None:
        self.register_processor(ItemType.ITEM, self._consume_potion)
        self.register_processor(ItemType.TOKEN, self._consume_token)
        self.register_processor(ItemType.EQUIP, self._consume_equip)
        self.register_processor(ItemType.GEM, self._consume_gem)
        self.register_processor(ItemType.CARD, self._consume_card)

    def register_processor(self, item_type: int, fn: ConsumeFn) -> None:
        """Attach a family processor (the GetConsumeModule dispatch)."""
        self._processors[int(item_type)] = fn

    def _item_config(self, config_id: str):
        elems = self.kernel.elements
        return elems.element(config_id) if elems.exists(config_id) else None

    def use_item(self, guid: Guid, config_id: str, target=None) -> bool:
        """ConsumeLegal (owned + processor exists) → ConsumeProcess →
        remove one from the bag (`NFCItemModule::OnClientUseItem`).
        `target` routes to the family processor (hero row, equip row)."""
        e = self._item_config(config_id)
        if e is None:
            return False
        if not self.pack.enough_item(guid, config_id):
            return False
        fn = self._processors.get(int(e.values.get("ItemType", -1)))
        if fn is None:
            return False
        if not fn(guid, config_id, target):
            return False
        return self.pack.delete_item(guid, config_id, 1)

    # ------------------------------------------------ family processors
    def _consume_potion(self, guid: Guid, config_id: str, target) -> bool:
        """ITEM family (NFCPotionItemConsumeProcessModule): HP/MP/SP
        waters restore the matching pool — an HP water used at 0 HP
        revives (NFCRebornItemConsumeProcessModule's intent; its body is
        commented out in the reference).  EXP items award player exp;
        with a hero-row target the award goes to the hero instead
        (NFCHeroItemConsumeProcessModule::AwardItemProperty — the
        EIT_HERO_STONE type it registers under does not exist in the
        shipped EItemType enum, so that module is dead code in the
        reference; its targeted-award behavior lives here)."""
        e = self._item_config(config_id)
        sub = int(e.values.get("ItemSubType", -1))
        amount = int(e.values.get("AwardValue", 0))
        k = self.kernel
        if sub == int(ItemSubType.EXP):
            if target is not None:
                # an explicit hero target must never silently become a
                # player grant — refuse (item stays in the bag) when the
                # hero module is not wired
                if self.heroes is None:
                    return False
                return self.heroes.add_hero_exp(guid, int(target), amount) > 0
            if self.level is not None:
                self.level.add_exp(guid, amount)
                return True
            return False
        target_prop = {
            int(ItemSubType.HP): ("HP", "MAXHP"),
            int(ItemSubType.MP): ("MP", "MAXMP"),
            int(ItemSubType.SP): ("SP", "MAXSP"),
        }.get(sub)
        if target_prop is None:
            return False
        prop_name, max_name = target_prop
        cur = int(k.get_property(guid, prop_name))
        cap = int(k.get_property(guid, max_name))
        k.set_property(guid, prop_name, min(cap, cur + amount) if cap else cur + amount)
        return True

    def _consume_token(self, guid: Guid, config_id: str, target) -> bool:
        """TOKEN family: currency grants (Gold/Money)."""
        e = self._item_config(config_id)
        sub = int(e.values.get("ItemSubType", -1))
        amount = int(e.values.get("AwardValue", 0))
        k = self.kernel
        prop_name = "Gold" if sub == int(ItemSubType.CURRENCY) else "Money"
        k.set_property(guid, prop_name,
                       int(k.get_property(guid, prop_name)) + amount)
        return True

    def _consume_equip(self, guid: Guid, config_id: str, target) -> bool:
        """EQUIP family (NFCItemEquipConsumeProcessModule is an empty
        skeleton; the shop's default branch shows the intent): using an
        equip token materializes the equip as a unique BagEquipList row."""
        return self.pack.create_equip(guid, config_id) is not None

    def _consume_gem(self, guid: Guid, config_id: str, target) -> bool:
        """GEM family (NFCItemGemConsumeProcessModule is an empty
        skeleton): socket the gem into a TARGET equip row — its stat
        columns fold into the owner's stats while that equip is worn
        (EquipModule.refresh reads the sockets).  Sockets live in the
        row's InlayInfo column, so a recycled row or a relog can never
        inherit or lose them."""
        if target is None:
            return False
        equips = self.pack.equips(guid)
        if int(target) not in equips:
            return False
        k = self.kernel
        row = int(target)
        gems = self.gems_of(guid, row)
        if len(gems) >= self.max_sockets:
            return False
        gems.append(config_id)
        k.state = k.store.record_set(k.state, guid, BAG_EQUIP, row,
                                     "InlayInfo", ";".join(gems))
        k.state = k.store.record_set(k.state, guid, BAG_EQUIP, row,
                                     "SlotCount", len(gems))
        if self.equip is not None:
            self.equip.refresh(guid)
        return True

    def gems_of(self, guid: Guid, equip_row: int) -> List[str]:
        """Socketed gem ids, straight from the row's InlayInfo column."""
        k = self.kernel
        raw = str(k.store.record_get(k.state, guid, BAG_EQUIP,
                                     int(equip_row), "InlayInfo"))
        return [g for g in raw.split(";") if g]

    def _consume_card(self, guid: Guid, config_id: str, target) -> bool:
        """CARD family (NFCItemCardConsumeProcessModule): the card IS the
        hero config — add it to the collection (AddHero(self, strItemID));
        a duplicate stacks a star (HeroModule.add_hero)."""
        if self.heroes is None:
            return False
        return self.heroes.add_hero(guid, config_id) is not None



class EquipModule(Module):
    """Wearing: NPG_EQUIP stat-group recompute (NFCEquipModule /
    NFCEquipPropertyModule).  Worn state IS the record: WearGUID holds the
    owner's guid for worn rows, so restores need only a refresh() call."""

    name = "EquipModule"

    def __init__(self, pack: PackModule, properties) -> None:
        super().__init__()
        self.pack = pack
        self.properties = properties  # game.stats.PropertyModule
        self.items = None  # ItemModule; supplies gem sockets per equip
        pack.on_equip_deleted.append(lambda owner, _row: self.refresh(owner))

    def wear(self, guid: Guid, row: int) -> bool:
        if row not in self.pack.equips(guid):
            return False
        k = self.kernel
        k.state = k.store.record_set(k.state, guid, BAG_EQUIP, row,
                                     "WearGUID", guid)
        self.refresh(guid)
        return True

    def take_off(self, guid: Guid, row: int) -> bool:
        if row not in self.worn(guid):
            return False
        k = self.kernel
        from ..core.datatypes import NULL_GUID

        k.state = k.store.record_set(k.state, guid, BAG_EQUIP, row,
                                     "WearGUID", NULL_GUID)
        self.refresh(guid)
        return True

    def worn(self, guid: Guid) -> Dict[int, str]:
        """Worn rows (WearGUID == owner), derived from the record."""
        k = self.kernel
        owned = self.pack.equips(guid)
        out = {}
        for row, config_id in owned.items():
            wearer = k.store.record_get(k.state, guid, BAG_EQUIP, row,
                                        "WearGUID")
            if wearer == guid:
                out[row] = config_id
        return out

    def refresh(self, guid: Guid) -> None:
        """Re-sum worn equips' element-config stat columns — plus their
        socketed gems' — into the EQUIP group row (call after restore
        too); the per-tick recompute folds groups into final stats."""
        elems = self.kernel.elements
        totals = {n: 0 for n in STAT_NAMES}

        def fold(config_id: str) -> None:
            if not elems.exists(config_id):
                return
            vals = elems.element(config_id).values
            for n in STAT_NAMES:
                v = vals.get(n)
                if v:
                    totals[n] += int(v)

        for row, config_id in self.worn(guid).items():
            fold(config_id)
            if self.items is not None:
                for gem_id in self.items.gems_of(guid, row):
                    fold(gem_id)
        for n, v in totals.items():
            self.properties.set_group_value(guid, n, PropertyGroup.EQUIP, v)
