"""The port's SLG city building (game/slg.py) against the JAX package on
the CPU: the cases of tests/test_slg.py, each written once and run on both
packages (test_torch_middleware.run_both), with equal answers, banks and
module state (the due-tick heap included) after every step (tolerance 0).

The SLG clock is ``wall_base + tick_count * dt``: every world here runs at
``dt=1.0`` with ``wall_base`` as each case sets it (0 unless the case pins
another), so both packages read the same time."""

from __future__ import annotations

import pytest

from test_torch_middleware import WireRig, run_both
from test_torch_parity import one_intra_op_thread  # noqa: F401

CONFIG = dict(combat=False, movement=False, regen=False, npc_capacity=64,
              player_capacity=8, dt=1.0)


def slg_world(rig):
    w = rig.world(**CONFIG)
    w.scene.create_scene(1)
    w.slg_building.upgrade_s = 4
    w.slg_building.produce_interval_s = 3
    return w


def slg_player(rig, w):
    k = w.kernel
    g = k.create_object("Player", {"Name": "B", "Account": "b"}, scene=1, group=0)
    k.set_property(g, "Level", 5)
    k.set_property(g, "Gold", 1000)
    k.set_property(g, "Diamond", 50)
    return rig.rec("player", g)


def define_slg(rig, w):
    G, e = rig.P.game, w.kernel.elements
    e.add_element("Building", "barracks", {"Type": 2, "ItemList": "bread;arrow"})
    e.add_element("Building", "temple", {"Type": 5, "UpgradeTime": 15})
    e.add_element("Item", "sword_s", {"ItemType": int(G.ItemType.EQUIP)})
    e.add_element("Item", "bread", {"ItemType": int(G.ItemType.ITEM)})
    e.add_element("Shop", "shop_barracks", {"Type": int(G.EShopType.BUILDING), "Level": 3,
                                            "Gold": 100, "Diamond": 5, "ItemID": "barracks"})
    e.add_element("Shop", "shop_sword", {"Type": int(G.EShopType.OTHER), "Level": 1,
                                         "Gold": 30, "ItemID": "sword_s"})
    e.add_element("Shop", "shop_bread", {"Type": int(G.EShopType.GOLD), "Level": 1,
                                         "Gold": 5, "ItemID": "bread"})


def ticks(rig, w, n, label="ticks"):
    for _ in range(n):
        w.tick()
    rig.rec(f"{label} {n}")


def setup(rig):
    w = slg_world(rig)
    player = slg_player(rig, w)
    define_slg(rig, w)
    return w, player, w.slg_building, rig.rec, rig.P.game.SLGBuildingState


def slg_add_upgrade_completes_and_levels(rig):
    w, player, b, r, S = setup(rig)
    row = r("add", b.add_building(player, "barracks", 3, 4, 0))
    assert row is not None
    assert r("list", b.buildings(player)) == {row: "barracks"}
    assert r("state", b.building_state(player, row)) == int(S.IDLE)
    assert r("level", b.building_level(player, row)) == 1
    assert r("upgrade", b.upgrade(player, row))
    assert r("state", b.building_state(player, row)) == int(S.UPGRADE)
    assert not r("busy", b.upgrade(player, row))
    ticks(rig, w, 6)
    assert r("state", b.building_state(player, row)) == int(S.IDLE)
    assert r("level", b.building_level(player, row)) == 2


def slg_upgrade_time_from_config(rig):
    w, player, b, r, S = setup(rig)
    row = r("add", b.add_building(player, "temple", 0, 0, 0))
    assert r("upgrade", b.upgrade(player, row))
    ticks(rig, w, 6)
    assert r("state", b.building_state(player, row)) == int(S.UPGRADE)
    ticks(rig, w, 12)
    assert r("level", b.building_level(player, row)) == 2


def slg_boost_shortens_and_cancel_aborts(rig):
    w, player, b, r, S = setup(rig)
    b.upgrade_s = 40
    row = r("add", b.add_building(player, "barracks", 0, 0, 0))
    assert not r("idle boost", b.boost(player, row))
    assert r("upgrade", b.upgrade(player, row))
    assert r("boost", b.boost(player, row))
    assert r("state", b.building_state(player, row)) == int(S.BOOST)
    assert not r("boost twice", b.boost(player, row))
    row2 = r("add 2", b.add_building(player, "barracks", 1, 1, 0))
    assert r("upgrade 2", b.upgrade(player, row2))
    assert r("cancel", b.cancel(player, row2))
    assert r("state 2", b.building_state(player, row2)) == int(S.IDLE)
    ticks(rig, w, 45)
    assert r("level 2", b.building_level(player, row2)) == 1
    assert r("level", b.building_level(player, row)) == 2


def slg_resource_collect_accrues_over_time(rig):
    w, player, b, r, _ = setup(rig)
    k = w.kernel
    k.elements.add_element("Building", "quarry", {"Type": 3})
    b.collect_interval_s = 2
    row = r("add", b.add_building(player, "quarry", 0, 0, 0))
    assert not r("early", b.collect(player, row, "Stone"))
    ticks(rig, w, 2)
    assert r("collect", b.collect(player, row, "Stone"))
    assert r("stone", int(k.get_property(player, "Stone"))) == b.collect_amount
    assert not r("spam", b.collect(player, row, "Stone"))
    k.state = k.store.record_set(k.state, player, "BuildingList", row, "Level", 3)
    ticks(rig, w, 4)
    assert r("collect steel", b.collect(player, row, "Steel"))
    assert r("steel", int(k.get_property(player, "Steel"))) == 3 * b.collect_amount * 2
    row2 = r("barracks", b.add_building(player, "barracks", 1, 1, 0))
    ticks(rig, w, 2)
    assert not r("not a resource", b.collect(player, row2, "Stone"))
    assert not r("not a property", b.collect(player, row, "HP"))


def slg_produce_time_from_config(rig):
    w, player, b, r, _ = setup(rig)
    w.kernel.elements.add_element("Building", "mill", {"Type": 3, "ItemID": "bread",
                                                       "ProduceTime": 6})
    row = r("add", b.add_building(player, "mill", 0, 0, 0))
    assert r("produce", b.produce(player, row, "bread", 1))
    ticks(rig, w, 4)
    assert r("bread", w.pack.item_count(player, "bread")) == 0
    ticks(rig, w, 3)
    assert r("bread", w.pack.item_count(player, "bread")) == 1


def slg_relog_rearms_upgrade_timer(rig):
    w = slg_world(rig)
    define_slg(rig, w)
    r, S, k, b = rig.rec, rig.P.game.SLGBuildingState, w.kernel, w.slg_building
    agent = rig.P.agent.PlayerDataAgent(rig.P.kv.MemoryKV()).bind(k)
    g = k.create_object("Player", {"Name": "R", "Account": "r"}, scene=1, group=0)
    k.set_property(g, "Level", 5)
    b.upgrade_s = 5
    row = r("add", b.add_building(g, "barracks", 0, 0, 0))
    assert r("upgrade", b.upgrade(g, row))
    ticks(rig, w, 1)
    agent.save(g)
    k.destroy_object(g)
    ticks(rig, w, 1)
    g2 = r("relog", k.create_object("Player", {"Name": "R", "Account": "r"}, scene=1,
                                    group=0))
    assert r("state", b.building_state(g2, row)) == int(S.UPGRADE)
    ticks(rig, w, 8)
    assert r("state", b.building_state(g2, row)) == int(S.IDLE)
    assert r("level", b.building_level(g2, row)) == 2


def slg_move_building(rig):
    w, player, b, r, _ = setup(rig)
    k = w.kernel
    row = r("add", b.add_building(player, "barracks", 1, 2, 3))
    assert r("move", b.move(player, row, 7, 8, 9))
    assert r("x", int(k.store.record_get(k.state, player, "BuildingList", row, "X"))) == 7
    assert r("y", int(k.store.record_get(k.state, player, "BuildingList", row, "Y"))) == 8
    assert not r("no building", b.move(player, 13, 0, 0, 0))


def slg_produce_lands_items_over_time(rig):
    w, player, b, r, _ = setup(rig)
    row = r("add", b.add_building(player, "barracks", 0, 0, 0))
    assert r("produce", b.produce(player, row, "bread", 2))
    assert r("left", b.produce_left(player, row, "bread")) == 2
    assert r("bread", w.pack.item_count(player, "bread")) == 0
    ticks(rig, w, 4)
    assert r("bread", w.pack.item_count(player, "bread")) == 1
    assert r("left", b.produce_left(player, row, "bread")) == 1
    ticks(rig, w, 4)
    assert r("bread", w.pack.item_count(player, "bread")) == 2
    assert r("left", b.produce_left(player, row, "bread")) == 0
    assert not r("unlisted", b.produce(player, row, "sword_s", 1))
    assert r("listed", b.produce(player, row, "arrow", 1))


def slg_building_timers_survive_checkpoint(rig, path):
    w, player, b, r, S = setup(rig)
    b.upgrade_s = 10
    row = r("add", b.add_building(player, "barracks", 0, 0, 0))
    assert r("upgrade", b.upgrade(player, row))
    ticks(rig, w, 2)
    ckpt = path / rig.P.name
    w.save(ckpt)
    w2 = rig.world(**CONFIG)
    w2.load(ckpt)
    b2 = w2.slg_building
    assert r("loaded", b2.building_state(player, row)) == int(S.UPGRADE)
    ticks(rig, w2, 15)
    assert r("state", b2.building_state(player, row)) == int(S.IDLE)
    assert r("level", b2.building_level(player, row)) == 2


def slg_shop_building_purchase_places_and_charges(rig):
    w, player, _, r, _ = setup(rig)
    k = w.kernel
    assert r("buy", w.slg_shop.buy(player, "shop_barracks", 10, 11, 0))
    assert r("gold", int(k.get_property(player, "Gold"))) == 900
    assert r("diamond", int(k.get_property(player, "Diamond"))) == 45
    assert r("list", list(w.slg_building.buildings(player).values())) == ["barracks"]


def slg_shop_level_gate_and_funds(rig):
    w, player, _, r, _ = setup(rig)
    s, k = w.slg_shop, w.kernel
    k.set_property(player, "Level", 2)
    assert not r("level gate", s.buy(player, "shop_barracks"))
    k.set_property(player, "Level", 3)
    k.set_property(player, "Gold", 10)
    assert not r("gold short", s.buy(player, "shop_barracks"))
    assert r("diamond", int(k.get_property(player, "Diamond"))) == 50
    k.set_property(player, "Gold", 100)
    k.set_property(player, "Diamond", 1)
    assert not r("diamond short", s.buy(player, "shop_barracks"))
    assert r("gold", int(k.get_property(player, "Gold"))) == 100


def slg_shop_default_branch_equips_and_items(rig):
    w, player, _, r, _ = setup(rig)
    s = w.slg_shop
    assert r("sword", s.buy(player, "shop_sword"))
    assert r("equips", len(w.pack.equips(player))) == 1
    assert r("bread", s.buy(player, "shop_bread"))
    assert r("count", w.pack.item_count(player, "bread")) == 1
    assert not r("unknown", s.buy(player, "nope"))


def slg_wire_handlers_end_to_end(rig):
    P, r = rig.P, rig.rec
    w = rig.world(combat=False, movement=False, regen=False, npc_capacity=64,
                  player_capacity=8)
    wr = WireRig(rig, w, "SlgGame")
    w.slg_building.upgrade_s = 4
    define_slg(rig, w)
    k, F, MsgID = wr.role.kernel, P.families, P.msg.MsgID
    ident, g = wr.seat(1, "slg", {"Name": "S"})
    k.set_property(g, "Level", 5)
    k.set_property(g, "Gold", 500)
    k.set_property(g, "Diamond", 50)
    wr.send(ident, MsgID.REQ_BUY_FORM_SHOP,
            F.ReqAckBuyObjectFormShop(config_id=b"shop_barracks", x=3.0, y=4.0))
    assert r("placed", w.slg_building.buildings(g))
    row = next(iter(w.slg_building.buildings(g)))
    assert r("ack", wr.acks(101, MsgID.ACK_BUY_FORM_SHOP))
    wr.send(ident, MsgID.REQ_MOVE_BUILD_OBJECT,
            F.ReqAckMoveBuildObject(row=row, x=9.0, y=9.0, z=0.0))
    assert r("x", int(k.store.record_get(k.state, g, "BuildingList", row, "X"))) == 9
    wr.send(ident, MsgID.REQ_UP_BUILD_LVL, F.ReqUpBuildLv(row=row))
    assert r("upgrading", w.slg_building.building_state(g, row)) == int(
        P.game.SLGBuildingState.UPGRADE)
    wr.send(ident, MsgID.REQ_BUILD_OPERATE,
            F.ReqBuildOperate(row=row, functype=int(F.SLGFuncType.CANCEL)))
    assert r("cancelled", w.slg_building.building_state(g, row)) == int(
        P.game.SLGBuildingState.IDLE)
    now = 1000.0
    for i in range(3):
        now += w.config.dt * 1.0001
        wr.role.execute(now)
        r(f"frame {i}", wr.sent)
    assert any(c == 101 for c, m, b in wr.sent
               if m in (int(MsgID.ACK_ADD_ROW), int(MsgID.ACK_RECORD_INT),
                        int(MsgID.ACK_OBJECT_RECORD_ENTRY)))
    wr.role.shut()


def slg_relog_does_not_double_produce(rig):
    w = slg_world(rig)
    define_slg(rig, w)
    r, k, b = rig.rec, w.kernel, w.slg_building
    agent = rig.P.agent.PlayerDataAgent(rig.P.kv.MemoryKV()).bind(k)
    g = k.create_object("Player", {"Name": "Q", "Account": "q"}, scene=1, group=0)
    row = r("add", b.add_building(g, "barracks", 0, 0, 0))
    assert r("produce", b.produce(g, row, "bread", 4))
    ticks(rig, w, 1)
    agent.save(g)
    k.destroy_object(g)
    g2 = r("relog", k.create_object("Player", {"Name": "Q", "Account": "q"}, scene=1,
                                    group=0))
    ticks(rig, w, 7)
    assert r("bread", w.pack.item_count(g2, "bread")) == 2
    assert r("left", b.produce_left(g2, row, "bread")) == 2


def slg_restart_into_fresh_process_resolves_timers(rig):
    w = slg_world(rig)
    define_slg(rig, w)
    r, S, k, b = rig.rec, rig.P.game.SLGBuildingState, w.kernel, w.slg_building
    kv = rig.P.kv.MemoryKV()
    agent = rig.P.agent.PlayerDataAgent(kv).bind(k)
    b.wall_base = 1_000_000.0
    b.upgrade_s = 30
    g = k.create_object("Player", {"Name": "F", "Account": "f"}, scene=1, group=0)
    row = r("add", b.add_building(g, "barracks", 0, 0, 0))
    assert r("upgrade", b.upgrade(g, row))
    ticks(rig, w, 2)
    agent.save(g)
    w2 = rig.world(**CONFIG)
    w2.scene.create_scene(1)
    b2 = w2.slg_building
    b2.wall_base = 1_000_060.0
    rig.P.agent.PlayerDataAgent(kv).bind(w2.kernel)
    g2 = r("relog", w2.kernel.create_object("Player", {"Name": "F", "Account": "f"},
                                            scene=1, group=0))
    assert r("state", b2.building_state(g2, row)) == int(S.UPGRADE)
    ticks(rig, w2, 3)
    assert r("state", b2.building_state(g2, row)) == int(S.IDLE)
    assert r("level", b2.building_level(g2, row)) == 2


CASES = [slg_add_upgrade_completes_and_levels, slg_upgrade_time_from_config,
         slg_boost_shortens_and_cancel_aborts, slg_resource_collect_accrues_over_time,
         slg_produce_time_from_config, slg_relog_rearms_upgrade_timer, slg_move_building,
         slg_produce_lands_items_over_time, slg_shop_building_purchase_places_and_charges,
         slg_shop_level_gate_and_funds, slg_shop_default_branch_equips_and_items,
         slg_wire_handlers_end_to_end, slg_relog_does_not_double_produce,
         slg_restart_into_fresh_process_resolves_timers]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[4:])
def test_slg_case(case):
    """tests/test_slg.py's cases on both packages, equal after every step."""
    run_both(case)


def test_slg_timers_survive_checkpoint(tmp_path):
    """tests/test_slg.py::test_building_timers_survive_checkpoint on both
    packages: a world saved mid-upgrade resumes and completes."""
    run_both(slg_building_timers_survive_checkpoint, tmp_path)
