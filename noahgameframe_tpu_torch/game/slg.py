"""SLG city-building gameplay: building placement, timed upgrade/boost,
item production, and the SLG shop.

Reference modules (`NFServer/NFGameLogicPlugin/`):
- NFCSLGBuildingModule (`NFCSLGBuildingModule.cpp:57-96` AddBuilding,
  `:98-131` Upgrade, `:241-273` Boost, `:275-306` Produce, `:308-331`
  Move, `:334-381` CheckBuildingStatusEnd) — BuildingList record rows
  with a State machine (EBS_IDLE/UPGRADE/BOOST) driven by schedule
  callbacks;
- NFCSLGShopModule (`NFCSLGShopModule.cpp:52-117` ReqBuyItem) — element-
  config catalogue: level gate, Gold+Diamond cost, then per-EShopType
  effect (item, equip, or building placement).

Design differences from the reference, on purpose:
- Buildings are identified by their record ROW (like BagEquipList
  equips), not a per-row GUID column: the row index is stable for the
  row's lifetime, rides the wire messages (`ReqAckMoveBuildObject.row`),
  and restores from checkpoints with no registry.  The reference's
  BuildingGUID column exists only to find the row again.
- Timers are wall-anchored absolute SECONDS stored in the record
  (StateStartTime / StateEndTime; see _now()), so the record itself is
  the source of truth: resume re-arms pending completions by scanning
  the record (CheckBuildingStatusEnd), no host timer state needs
  checkpointing, and a blob saved in one process resolves correctly in
  a freshly-started one (downtime counts toward completion).
- Upgrade completion has a real effect (Level column +1): the
  reference's OnUpgradeHeartBeat body is commented out ("TO ADD"), we
  complete the obvious intent.
- The shop consumes Diamond for the element's Diamond cost; the
  reference passes nGold to ConsumeDiamond (`NFCSLGShopModule.cpp:76`),
  which reads like a bug, not a contract.

A copy of ``noahgameframe_tpu/game/slg.py``, which imports no jax: the
port keeps its own.  Time is ``wall_base + kernel.tick_count * dt``, a host
count, so driving the heap reads nothing off the device.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.datatypes import Guid
from ..kernel.module import Module
from .defines import EShopType, ItemType, SLGBuildingState

BUILDING_RECORD = "BuildingList"
PRODUCE_RECORD = "BuildingProduce"


class SLGBuildingModule(Module):
    """BuildingList state machine (NFCSLGBuildingModule)."""

    name = "SLGBuildingModule"

    def __init__(
        self,
        pack=None,
        upgrade_s: float = 20.0,  # reference nNeedTime = 20
        boost_factor: float = 0.5,
        produce_interval_s: float = 50.0,  # reference nTime = 50
        wall_base: float = 0.0,
    ) -> None:
        super().__init__()
        self.pack = pack
        self.upgrade_s = upgrade_s
        self.boost_factor = boost_factor
        self.produce_interval_s = produce_interval_s
        self.collect_amount = 10  # per building level, per collect interval
        self.collect_interval_s = 10.0  # accrual period for RESOURCE yield
        self.wall_base: float = float(wall_base)  # see _now()
        # due-tick heap over (tick, owner, kind, rec_row); the record is
        # the source of truth — entries are validated when they fire
        self._due: List[Tuple[int, Guid, str, int]] = []

    def after_init(self) -> None:
        # the reference re-arms building timers on COE_CREATE_FINISH
        # (NFCSLGBuildingModule::OnClassObjectEvent) — a player logging
        # back in mid-upgrade must not stay stuck in UPGRADE forever.
        # CREATE_FINISH fires after CREATE_LOADDATA, so the data agent has
        # already restored the records by the time we scan them.
        from ..kernel.kernel import ObjectEvent

        def on_player(guid: Guid, _cname: str, ev) -> None:
            if ev == ObjectEvent.CREATE_FINISH:
                self.check_building_status_end(guid)

        self.kernel.register_class_event(on_player, "Player")

    # ------------------------------------------------------------ helpers
    # Time unit: ANCHORED sim seconds — `wall_base` plus sim time
    # (tick x dt).  Absolute seconds persist in the record (the reference
    # stores GetNowTime() the same way, NFCSLGBuildingModule.cpp:121-124).
    # The anchor defaults to 0 (pure logical time), keeping every value
    # a function of journaled inputs for record/replay; a deployment that
    # wants offline progression across restarts (downtime counting toward
    # completion) injects wall_base=time.time() at construction — the one
    # wall read then happens outside the simulation layer and is itself
    # journalable.  Fits int32 like the reference's.
    def _dur_s(self, seconds: float) -> int:
        """Duration in whole seconds (floor 1 — timers must fire)."""
        return max(1, int(round(seconds)))

    def _now(self) -> int:
        return int(self.wall_base
                   + self.kernel.tick_count * self.kernel.schedule.dt)

    def _get(self, guid: Guid, row: int, tag: str):
        k = self.kernel
        return k.store.record_get(k.state, guid, BUILDING_RECORD, row, tag)

    def _set(self, guid: Guid, row: int, tag: str, value) -> None:
        k = self.kernel
        k.state = k.store.record_set(k.state, guid, BUILDING_RECORD, row,
                                     tag, value)

    def buildings(self, guid: Guid) -> Dict[int, str]:
        """row -> building config id, straight from the record."""
        k = self.kernel
        cname, erow = k.store.row_of(guid)
        spec = k.store.spec(cname)
        if BUILDING_RECORD not in spec.records:
            return {}
        rec = k.state.classes[cname].records[BUILDING_RECORD]
        rs = spec.records[BUILDING_RECORD]
        used = rec.used[erow].cpu().numpy()
        ids = rec.i32[erow, :, rs.cols["BuildingID"].col].cpu().numpy()
        return {
            int(r): k.store.strings.lookup(int(ids[r]))
            for r in np.flatnonzero(used)
        }

    # -------------------------------------------------------------- verbs
    def add_building(self, guid: Guid, building_id: str, x: float, y: float,
                     z: float) -> Optional[int]:
        """Place a building (AddBuilding, NFCSLGBuildingModule.cpp:57-96);
        returns its record row or None when the record is full."""
        if not building_id:
            return None
        k = self.kernel
        if guid not in k.store.guid_map:
            return None
        try:
            k.state, row = k.store.record_add_row(
                k.state, guid, BUILDING_RECORD,
                {
                    "BuildingID": building_id,
                    "State": int(SLGBuildingState.IDLE),
                    "X": int(x), "Y": int(y), "Z": int(z),
                    "StateStartTime": self._now(),
                    "StateEndTime": 0,
                    "Level": 1,
                    "LastCollect": self._now(),  # accrual starts now
                },
            )
        except RuntimeError:
            return None
        return row

    def upgrade(self, guid: Guid, row: int) -> bool:
        """IDLE -> UPGRADE with a timed completion
        (Upgrade, NFCSLGBuildingModule.cpp:98-131)."""
        blds = self.buildings(guid)
        if row not in blds:
            return False
        if int(self._get(guid, row, "State")) != int(SLGBuildingState.IDLE):
            return False
        # per-building duration from the config element when present
        secs = self.upgrade_s
        elems = self.kernel.elements
        if elems.exists(blds[row]):
            cfg = float(elems.element(blds[row]).values.get("UpgradeTime", 0)
                        or 0)
            if cfg > 0:
                secs = cfg
        now, end = self._now(), self._now() + self._dur_s(secs)
        self._set(guid, row, "State", int(SLGBuildingState.UPGRADE))
        self._set(guid, row, "StateStartTime", now)
        self._set(guid, row, "StateEndTime", end)
        heapq.heappush(self._due, (end, guid, "state", row))
        return True

    def boost(self, guid: Guid, row: int) -> bool:
        """Shorten a running upgrade by boost_factor
        (Boost, NFCSLGBuildingModule.cpp:241-273)."""
        if row not in self.buildings(guid):
            return False
        if int(self._get(guid, row, "State")) != int(SLGBuildingState.UPGRADE):
            return False
        now = self._now()
        end = int(self._get(guid, row, "StateEndTime"))
        boosted = now + max(1, int((end - now) * self.boost_factor))
        self._set(guid, row, "State", int(SLGBuildingState.BOOST))
        self._set(guid, row, "StateEndTime", boosted)
        heapq.heappush(self._due, (boosted, guid, "state", row))
        return True

    def cancel(self, guid: Guid, row: int) -> bool:
        """Back to IDLE, timers void (EFT_CANCEL)."""
        if row not in self.buildings(guid):
            return False
        self._set(guid, row, "State", int(SLGBuildingState.IDLE))
        self._set(guid, row, "StateEndTime", 0)
        return True

    def move(self, guid: Guid, row: int, x: float, y: float, z: float) -> bool:
        """Re-place a building (Move, NFCSLGBuildingModule.cpp:308-331)."""
        if row not in self.buildings(guid):
            return False
        self._set(guid, row, "X", int(x))
        self._set(guid, row, "Y", int(y))
        self._set(guid, row, "Z", int(z))
        return True

    def building_level(self, guid: Guid, row: int) -> int:
        return int(self._get(guid, row, "Level"))

    def building_state(self, guid: Guid, row: int) -> int:
        return int(self._get(guid, row, "State"))

    # ------------------------------------------------------------ produce
    def _produce_dur_s(self, guid: Guid, building_row: int) -> int:
        """Per-building production interval: the Building config element's
        ProduceTime (seconds) when set, else the module default."""
        secs = self.produce_interval_s
        blds = self.buildings(guid)
        elems = self.kernel.elements
        bid = blds.get(building_row)
        if bid is not None and elems.exists(bid):
            cfg = float(elems.element(bid).values.get("ProduceTime", 0) or 0)
            if cfg > 0:
                secs = cfg
        return self._dur_s(secs)

    def can_produce(self, guid: Guid, building_row: int,
                    item_id: str) -> bool:
        """A building only produces items its CONFIG lists (ItemID or the
        ";"-joined ItemList column) — clients pick the ids they send, so
        an unvalidated produce would mint shop items for free."""
        blds = self.buildings(guid)
        bid = blds.get(building_row)
        elems = self.kernel.elements
        if bid is None or not elems.exists(bid):
            return False
        cfg = elems.element(bid).values
        allowed = [str(cfg.get("ItemID", "") or "")]
        allowed += str(cfg.get("ItemList", "") or "").split(";")
        return item_id in [a for a in allowed if a]

    def produce(self, guid: Guid, row: int, item_id: str,
                count: int) -> bool:
        """Queue `count` items from a building; one item lands in the bag
        per produce interval (Produce + OnProduceHeartBeat intent,
        NFCSLGBuildingModule.cpp:275-306).  Refuses items the building's
        config doesn't list."""
        if count <= 0 or not self.can_produce(guid, row, item_id):
            return False
        k = self.kernel
        rows = k.store.record_find_rows(
            k.state, guid, PRODUCE_RECORD, "BuildingRow", row
        )
        match = [
            r for r in rows
            if str(k.store.record_get(k.state, guid, PRODUCE_RECORD, r,
                                      "ItemID")) == item_id
        ]
        if match:
            r = match[0]
            left = int(k.store.record_get(k.state, guid, PRODUCE_RECORD, r,
                                          "LeftCount"))
            k.state = k.store.record_set(k.state, guid, PRODUCE_RECORD, r,
                                         "LeftCount", left + count)
            return True
        nxt = self._now() + self._produce_dur_s(guid, row)
        try:
            k.state, r = k.store.record_add_row(
                k.state, guid, PRODUCE_RECORD,
                {"BuildingRow": row, "ItemID": item_id, "LeftCount": count,
                 "NextTime": nxt},
            )
        except RuntimeError:
            return False
        heapq.heappush(self._due, (nxt, guid, "produce", r))
        return True

    def produce_left(self, guid: Guid, row: int, item_id: str) -> int:
        k = self.kernel
        for r in k.store.record_find_rows(k.state, guid, PRODUCE_RECORD,
                                          "BuildingRow", row):
            if str(k.store.record_get(k.state, guid, PRODUCE_RECORD, r,
                                      "ItemID")) == item_id:
                return int(k.store.record_get(k.state, guid, PRODUCE_RECORD,
                                              r, "LeftCount"))
        return 0

    # ------------------------------------------------------ timer driving
    def execute(self) -> None:
        now = self._now()
        k = self.kernel
        while self._due and self._due[0][0] <= now:
            _, guid, kind, row = heapq.heappop(self._due)
            if guid not in k.store.guid_map:
                continue  # owner gone; record died with it
            if kind == "state":
                self._complete_state(guid, row)
            else:
                self._step_produce(guid, row)

    def _complete_state(self, guid: Guid, row: int) -> None:
        if row not in self.buildings(guid):
            return
        st = int(self._get(guid, row, "State"))
        if st not in (int(SLGBuildingState.UPGRADE),
                      int(SLGBuildingState.BOOST)):
            return  # cancelled or re-armed meanwhile
        end = int(self._get(guid, row, "StateEndTime"))
        if end > self._now():
            return  # boost re-scheduled it; a later heap entry fires
        self._set(guid, row, "Level", self.building_level(guid, row) + 1)
        self._set(guid, row, "State", int(SLGBuildingState.IDLE))
        self._set(guid, row, "StateStartTime", self._now())
        self._set(guid, row, "StateEndTime", 0)

    def _step_produce(self, guid: Guid, prow: int) -> None:
        k = self.kernel
        cname, _ = k.store.row_of(guid)
        rec = k.state.classes[cname].records.get(PRODUCE_RECORD)
        if rec is None:
            return
        erow = k.store.row_of(guid)[1]
        if not bool(rec.used[erow, prow]):
            return
        # duplicate/stale heap entries (relogin re-arm + surviving old
        # entries) must not double-produce: the record's NextTime is the
        # truth — the same guard shape as _complete_state's EndTime check
        if int(k.store.record_get(k.state, guid, PRODUCE_RECORD, prow,
                                  "NextTime")) > self._now():
            return
        item = str(k.store.record_get(k.state, guid, PRODUCE_RECORD, prow,
                                      "ItemID"))
        left = int(k.store.record_get(k.state, guid, PRODUCE_RECORD, prow,
                                      "LeftCount"))
        if self.pack is not None:
            self.pack.create_item(guid, item, 1)
        left -= 1
        if left <= 0:
            k.state = k.store.record_remove_row(k.state, guid,
                                                PRODUCE_RECORD, prow)
            return
        k.state = k.store.record_set(k.state, guid, PRODUCE_RECORD, prow,
                                     "LeftCount", left)
        brow = int(k.store.record_get(k.state, guid, PRODUCE_RECORD, prow,
                                      "BuildingRow"))
        nxt = self._now() + self._produce_dur_s(guid, brow)
        k.state = k.store.record_set(k.state, guid, PRODUCE_RECORD, prow,
                                     "NextTime", nxt)
        heapq.heappush(self._due, (nxt, guid, "produce", prow))

    # ---------------------------------------------------------- resources
    def collect(self, guid: Guid, row: int, resource: str) -> bool:
        """RESOURCE buildings yield accrued stock on demand
        (EFT_COLLECT_GOLD/STONE/STEEL/DIAMOND): level × collect_amount
        per elapsed collect interval since the last collect (LastCollect
        column).  Spamming collects yields nothing — the accrual is
        time-based, not per-call.  The reference's functypes exist only
        as enum values; this is the obvious completion."""
        if resource not in ("Gold", "Stone", "Steel", "Diamond"):
            return False
        blds = self.buildings(guid)
        if row not in blds:
            return False
        elems = self.kernel.elements
        from .defines import SLGBuildingType

        # only a KNOWN RESOURCE building yields — an unconfigured id must
        # refuse, not default-allow (clients pick the row they send)
        if not elems.exists(blds[row]):
            return False
        if int(elems.element(blds[row]).values.get("Type", -1)) != int(
                SLGBuildingType.RESOURCE):
            return False
        k = self.kernel
        now = self._now()
        last = int(self._get(guid, row, "LastCollect"))
        if last < int(self.wall_base):
            # stamp from a different (earlier) time base — e.g. a legacy
            # blob that stored tick counts loaded into a wall-anchored
            # process: rebase instead of paying out an epoch's worth of
            # intervals in one call
            self._set(guid, row, "LastCollect", now)
            return False
        period = self._dur_s(self.collect_interval_s)
        intervals = (now - last) // period
        if intervals <= 0:
            return False  # nothing accrued yet
        amount = self.building_level(guid, row) * self.collect_amount \
            * int(intervals)
        # advance by WHOLE intervals — the fractional remainder keeps
        # accruing (resetting to `now` would tax off-cadence collectors)
        self._set(guid, row, "LastCollect", last + int(intervals) * period)
        k.set_property(guid, resource,
                       int(k.get_property(guid, resource)) + amount)
        return True

    # --------------------------------------------------- resume semantics
    def check_building_status_end(self, guid: Guid) -> None:
        """Re-arm pending completions from the record after a load — the
        reference's CheckBuildingStatusEnd + CheckProduceData on
        COE_CREATE_FINISH (NFCSLGBuildingModule.cpp:334-390)."""
        k = self.kernel
        if guid not in k.store.guid_map:
            return
        for row in self.buildings(guid):
            st = int(self._get(guid, row, "State"))
            if st in (int(SLGBuildingState.UPGRADE),
                      int(SLGBuildingState.BOOST)):
                end = max(int(self._get(guid, row, "StateEndTime")),
                          self._now() + 1)
                heapq.heappush(self._due, (end, guid, "state", row))
        for r in k.store.record_used_rows(k.state, guid, PRODUCE_RECORD):
            nxt = max(
                int(k.store.record_get(k.state, guid, PRODUCE_RECORD, r,
                                       "NextTime")),
                self._now() + 1,
            )
            heapq.heappush(self._due, (nxt, guid, "produce", r))

    def restore_state(self, data: dict) -> None:
        # the records restore through the store; re-arm every alive owner
        self._due = []
        k = self.kernel
        for guid in list(k.store.guid_map):
            cname = k.store.row_of(guid)[0]
            if BUILDING_RECORD in k.store.spec(cname).records:
                self.check_building_status_end(guid)

    def checkpoint_state(self) -> dict:
        return {}  # records are the source of truth


class SLGShopModule(Module):
    """Element-config SLG shop (NFCSLGShopModule::ReqBuyItem,
    NFCSLGShopModule.cpp:52-117): level gate, Gold+Diamond cost, then the
    per-EShopType effect — bag item, equip, or building placement."""

    name = "SLGShopModule"

    def __init__(self, pack, building: SLGBuildingModule) -> None:
        super().__init__()
        self.pack = pack
        self.building = building

    def _consume(self, guid: Guid, prop: str, amount: int) -> bool:
        if amount <= 0:
            return True
        k = self.kernel
        cur = int(k.get_property(guid, prop))
        if cur < amount:
            return False
        k.set_property(guid, prop, cur - amount)
        return True

    def buy(self, guid: Guid, shop_id: str, x: float = 0.0, y: float = 0.0,
            z: float = 0.0) -> bool:
        k = self.kernel
        elems = k.elements
        if guid not in k.store.guid_map or not elems.exists(shop_id):
            return False
        cfg = elems.element(shop_id).values
        need_level = int(cfg.get("Level", 0) or 0)
        if int(k.get_property(guid, "Level")) < need_level:
            return False
        gold = int(cfg.get("Gold", 0) or 0)
        diamond = int(cfg.get("Diamond", 0) or 0)
        if (int(k.get_property(guid, "Gold")) < gold
                or int(k.get_property(guid, "Diamond")) < diamond):
            return False
        item_id = str(cfg.get("ItemID", "") or "")
        if not elems.exists(item_id):
            return False
        # effect FIRST, charge after: a failed effect (building record
        # full, bag full) must not eat the currency.  The deduction cannot
        # fail — balances were checked above and nothing runs in between.
        count = max(1, int(cfg.get("Count", 0) or 0))
        shop_type = int(cfg.get("Type", 0) or 0)
        if shop_type == int(EShopType.BUILDING):
            ok = self.building.add_building(guid, item_id, x, y, z) is not None
        elif shop_type in (int(EShopType.GOLD), int(EShopType.DIAMOND),
                           int(EShopType.SP)):
            ok = self.pack.create_item(guid, item_id, count)
        else:
            item_cfg = elems.element(item_id).values
            if int(item_cfg.get("ItemType", -1)) == int(ItemType.EQUIP):
                ok = self.pack.create_equip(guid, item_id) is not None
            else:
                ok = self.pack.create_item(guid, item_id, count)
        if not ok:
            return False
        self._consume(guid, "Gold", gold)
        self._consume(guid, "Diamond", diamond)
        return True
