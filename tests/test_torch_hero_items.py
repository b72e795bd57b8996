"""The port's heroes and item consume families against the JAX package on
the CPU: the cases of tests/test_hero_items.py, each written once and run
on both packages (test_torch_middleware.run_both), with equal answers,
banks and middleware module state after every step (tolerance 0)."""

from __future__ import annotations

import pytest

from test_torch_middleware import run_both


def hero_world(rig):
    w = rig.world(combat=False, movement=False, regen=False, npc_capacity=64,
                  player_capacity=8)
    w.scene.create_scene(1)
    return w


def hero_player(rig, w):
    g = w.kernel.create_object("Player", {"Name": "H", "Account": "h"}, scene=1, group=0)
    w.kernel.set_property(g, "Level", 10)
    return rig.rec("player", g)


def define_heroes(rig, w):
    G, e = rig.P.game, w.kernel.elements
    e.add_element("Item", "hero_mage", {"ItemType": int(G.ItemType.CARD), "ATK_VALUE": 4,
                                        "MAXHP": 10, "Skill1": "fireball_1",
                                        "Talent1": "wisdom_1"})
    e.add_element("Skill", "fireball_1", {"AfterUpID": "fireball_2", "DamageValue": 10})
    e.add_element("Skill", "fireball_2", {"DamageValue": 20})
    e.add_element("Talent", "wisdom_1", {"AfterUpID": "wisdom_2"})
    e.add_element("Talent", "wisdom_2", {})


def setup(rig):
    w = hero_world(rig)
    return w, hero_player(rig, w)


def hi_star_up_caps(rig):
    w, player = setup(rig)
    define_heroes(rig, w)
    h, r = w.heroes, rig.rec
    h.max_star = 3
    row = r("add", h.add_hero(player, "hero_mage"))
    assert r("star", h.hero_star(player, row)) == 1
    assert r("up", h.hero_star_up(player, row))
    assert r("star", h.hero_star(player, row)) == 2
    for i in range(3):
        r(f"up {i}", h.hero_star_up(player, row))
    assert r("capped", h.hero_star(player, row)) == 3
    assert not r("no hero", h.hero_star_up(player, 9))


def hi_duplicate_card_stacks_a_star(rig):
    w, player = setup(rig)
    define_heroes(rig, w)
    h, r = w.heroes, rig.rec
    row = r("add", h.add_hero(player, "hero_mage"))
    assert r("dup", h.add_hero(player, "hero_mage")) == row
    assert r("star", h.hero_star(player, row)) == 2


def hi_skill_and_talent_chains(rig):
    w, player = setup(rig)
    define_heroes(rig, w)
    h, r, k = w.heroes, rig.rec, w.kernel
    HR = rig.P.hero.HERO_RECORD
    row = r("add", h.add_hero(player, "hero_mage"))
    assert r("skill1", str(k.store.record_get(k.state, player, HR, row, "Skill1"))) \
        == "fireball_1"
    assert r("up", h.hero_skill_up(player, row, 1))
    assert r("skill1", str(k.store.record_get(k.state, player, HR, row, "Skill1"))) \
        == "fireball_2"
    assert not r("chain end", h.hero_skill_up(player, row, 1))
    assert not r("empty slot", h.hero_skill_up(player, row, 2))
    assert not r("bad index", h.hero_skill_up(player, row, 9))
    assert r("talent up", h.hero_talent_up(player, row, 1))
    assert r("talent1", str(k.store.record_get(k.state, player, HR, row, "Talent1"))) \
        == "wisdom_2"


def hi_wear_skill_must_be_owned(rig):
    w, player = setup(rig)
    define_heroes(rig, w)
    h, r, k = w.heroes, rig.rec, w.kernel
    row = r("add", h.add_hero(player, "hero_mage"))
    assert not r("not owned", h.hero_wear_skill(player, row, "frostbolt"))
    assert r("owned", h.hero_wear_skill(player, row, "fireball_1"))
    assert r("fight skill", str(k.store.record_get(
        k.state, player, rig.P.hero.HERO_RECORD, row, "FightSkill"))) == "fireball_1"


def hi_fight_lineup_positions_sum_stats(rig):
    w, player = setup(rig)
    define_heroes(rig, w)
    G, h, r = rig.P.game, w.heroes, rig.rec
    w.kernel.elements.add_element("Item", "hero_tank", {"ItemType": int(G.ItemType.CARD),
                                                        "ATK_VALUE": 1, "MAXHP": 50})
    r1 = r("mage", h.add_hero(player, "hero_mage"))
    r2 = r("tank", h.add_hero(player, "hero_tank"))
    assert r("pos 0", h.set_fight_hero(player, r1, pos=0))
    assert r("pos 1", h.set_fight_hero(player, r2, pos=1))
    assert r("at 0", h.fight_hero(player, 0)) == r1
    assert r("at 1", h.fight_hero(player, 1)) == r2

    def atk():
        return r("atk", w.properties.get_group_value(player, "ATK_VALUE",
                                                     G.PropertyGroup.FIGHTING_HERO))

    assert atk() == 5
    r("exp", h.add_hero_exp(player, r1, 200))
    assert atk() == 9
    assert r("re-place", h.set_fight_hero(player, r2, pos=0))
    assert r("at 0", h.fight_hero(player, 0)) == r2
    assert not r("beyond", h.set_fight_hero(player, r1, pos=99))


def hi_summon_only_in_clone_scene(rig):
    w, player = setup(rig)
    define_heroes(rig, w)
    h, r, k = w.heroes, rig.rec, w.kernel
    k.elements.add_element("Scene", "2", {"SceneType": 1})
    row = r("add", h.add_hero(player, "hero_mage"))
    assert r("normal scene", h.create_hero(player, row)) is None
    r("enter", w.scene_process.enter(player, 2))
    npc = r("summon", h.create_hero(player, row))
    assert npc is not None
    assert r("master", k.get_property(npc, "MasterID")) == player
    assert r("config", str(k.get_property(npc, "ConfigID"))) == "hero_mage"
    assert r("again", h.create_hero(player, row)) is None
    assert r("unsummon", h.destroy_hero(player, row))
    assert npc not in k.store.guid_map
    assert not r("idempotent", h.destroy_hero(player, row))


def hi_fight_hero_wire_handler(rig):
    w = hero_world(rig)
    P, r = rig.P, rig.rec
    role = P.role.GameRole(P.base.RoleConfig(6, 0, "HeroGame", "127.0.0.1", 0),
                           backend="py", world=w, cross_server_sync=False)
    define_heroes(rig, w)
    sent = []
    role.server.send_raw = lambda c, m, b: (sent.append((c, m, bytes(b))), True)[1]
    k = role.kernel
    ident = P.wire.Ident(svrid=9, index=5)
    sess = P.role.Session(ident=ident, conn_id=11, account="hh")
    g = k.create_object("Player", {"Name": "W"}, scene=1, group=0)
    sess.guid = g
    role.sessions[P.wire.ident_key(ident)] = sess
    role._guid_session[g] = P.wire.ident_key(ident)
    row = r("add", w.heroes.add_hero(g, "hero_mage"))
    msg = P.wire.ReqSetFightHero(heroid=P.wire.Ident(svrid=0, index=row), fight_pos=1)
    role.server.dispatch.feed([P.transport.NetEvent(
        P.transport.EV_MSG, 11, int(P.msg.MsgID.REQ_SET_FIGHT_HERO),
        P.wire.wrap(msg, player_id=ident))])
    assert r("fight", w.heroes.fight_hero(g, 1)) == row
    r("sent", sent)
    role.shut()


def hi_equip_item_materializes_equip(rig):
    w, player = setup(rig)
    G, r = rig.P.game, rig.rec
    w.kernel.elements.add_element("Item", "sword_tok", {"ItemType": int(G.ItemType.EQUIP),
                                                        "ATK_VALUE": 7})
    w.pack.create_item(player, "sword_tok", 1)
    assert r("use", w.items.use_item(player, "sword_tok"))
    assert r("count", w.pack.item_count(player, "sword_tok")) == 0
    assert r("equips", list(w.pack.equips(player).values())) == ["sword_tok"]


def hi_gem_socket_folds_stats_while_worn(rig):
    w, player = setup(rig)
    G, r = rig.P.game, rig.rec
    e = w.kernel.elements
    e.add_element("Item", "sword_g", {"ItemType": int(G.ItemType.EQUIP), "ATK_VALUE": 7})
    e.add_element("Item", "ruby", {"ItemType": int(G.ItemType.GEM), "ATK_VALUE": 3})
    w.pack.create_item(player, "ruby", 2)
    row = r("equip", w.pack.create_equip(player, "sword_g"))

    def atk():
        return r("atk", w.properties.get_group_value(player, "ATK_VALUE",
                                                     G.PropertyGroup.EQUIP))

    assert not r("untargeted", w.items.use_item(player, "ruby"))
    assert r("socket", w.items.use_item(player, "ruby", target=row))
    assert r("gems", w.items.gems_of(player, row)) == ["ruby"]
    assert atk() == 0
    r("wear", w.equip.wear(player, row))
    assert atk() == 10
    assert r("socket 2", w.items.use_item(player, "ruby", target=row))
    assert atk() == 13


def hi_card_item_adds_hero_and_dup_stars(rig):
    w, player = setup(rig)
    define_heroes(rig, w)
    r = rig.rec
    w.pack.create_item(player, "hero_mage", 2)
    assert r("card", w.items.use_item(player, "hero_mage"))
    row = r("row", w.heroes.hero_row_of(player, "hero_mage"))
    assert row is not None
    assert r("dup card", w.items.use_item(player, "hero_mage"))
    assert r("star", w.heroes.hero_star(player, row)) == 2


def hi_exp_item_targets_player_or_hero(rig):
    w, player = setup(rig)
    define_heroes(rig, w)
    G, r, k = rig.P.game, rig.rec, w.kernel
    k.elements.add_element("Item", "tome", {"ItemType": int(G.ItemType.ITEM),
                                            "ItemSubType": int(G.ItemSubType.EXP),
                                            "AwardValue": 250})
    w.pack.create_item(player, "tome", 2)
    hero_row = r("add", w.heroes.add_hero(player, "hero_mage"))
    assert r("hero tome", w.items.use_item(player, "tome", target=hero_row))
    assert r("hero level", w.heroes.hero_level(player, hero_row)) == 2
    exp0 = int(k.get_property(player, "EXP"))
    assert r("player tome", w.items.use_item(player, "tome"))
    assert r("exp", int(k.get_property(player, "EXP"))) != exp0 or \
        int(k.get_property(player, "Level")) > 10


def hi_hp_water_revives_dead_player(rig):
    w, player = setup(rig)
    G, r, k = rig.P.game, rig.rec, w.kernel
    k.elements.add_element("Item", "elixir", {"ItemType": int(G.ItemType.ITEM),
                                              "ItemSubType": int(G.ItemSubType.HP),
                                              "AwardValue": 40})
    w.properties.set_group_value(player, "MAXHP", G.PropertyGroup.EFFECTVALUE, 100)
    k.set_property(player, "HP", 0)
    w.pack.create_item(player, "elixir", 1)
    assert r("use", w.items.use_item(player, "elixir"))
    assert r("hp", int(k.get_property(player, "HP"))) == 40


def hi_recycled_equip_row_does_not_inherit_gems(rig):
    w, player = setup(rig)
    G, r = rig.P.game, rig.rec
    e = w.kernel.elements
    e.add_element("Item", "axe", {"ItemType": int(G.ItemType.EQUIP), "ATK_VALUE": 7})
    e.add_element("Item", "shield", {"ItemType": int(G.ItemType.EQUIP), "ATK_VALUE": 1})
    e.add_element("Item", "ruby2", {"ItemType": int(G.ItemType.GEM), "ATK_VALUE": 3})
    w.pack.create_item(player, "ruby2", 2)
    row = r("axe", w.pack.create_equip(player, "axe"))
    assert r("gem", w.items.use_item(player, "ruby2", target=row))
    assert r("gem", w.items.use_item(player, "ruby2", target=row))
    r("delete", w.pack.delete_equip(player, row))
    row2 = r("shield", w.pack.create_equip(player, "shield"))
    assert row2 == row
    assert r("gems", w.items.gems_of(player, row2)) == []
    r("wear", w.equip.wear(player, row2))
    assert r("atk", w.properties.get_group_value(player, "ATK_VALUE",
                                                 G.PropertyGroup.EQUIP)) == 1


def hi_gems_survive_relog(rig):
    w = hero_world(rig)
    G, r, k = rig.P.game, rig.rec, w.kernel
    agent = rig.P.agent.PlayerDataAgent(rig.P.kv.MemoryKV()).bind(k)
    g = k.create_object("Player", {"Name": "G", "Account": "g"}, scene=1, group=0)
    e = k.elements
    e.add_element("Item", "blade2", {"ItemType": int(G.ItemType.EQUIP), "ATK_VALUE": 5})
    e.add_element("Item", "onyx", {"ItemType": int(G.ItemType.GEM), "ATK_VALUE": 2})
    w.pack.create_item(g, "onyx", 1)
    row = r("equip", w.pack.create_equip(g, "blade2"))
    assert r("gem", w.items.use_item(g, "onyx", target=row))
    r("wear", w.equip.wear(g, row))
    agent.save(g)
    k.destroy_object(g)
    r("logged out")
    g2 = r("relog", k.create_object("Player", {"Name": "G", "Account": "g"}, scene=1,
                                    group=0))
    assert r("gems", w.items.gems_of(g2, row)) == ["onyx"]
    w.equip.refresh(g2)
    assert r("atk", w.properties.get_group_value(g2, "ATK_VALUE",
                                                 G.PropertyGroup.EQUIP)) == 7


def hi_resummon_after_external_destroy(rig):
    w, player = setup(rig)
    define_heroes(rig, w)
    h, r, k = w.heroes, rig.rec, w.kernel
    k.elements.add_element("Scene", "3", {"SceneType": 1})
    row = r("add", h.add_hero(player, "hero_mage"))
    r("enter", w.scene_process.enter(player, 3))
    npc = r("summon", h.create_hero(player, row))
    assert npc is not None
    k.destroy_object(npc)
    r("killed")
    npc2 = r("again", h.create_hero(player, row))
    assert npc2 is not None and npc2 != npc


CASES = [hi_star_up_caps, hi_duplicate_card_stacks_a_star, hi_skill_and_talent_chains,
         hi_wear_skill_must_be_owned, hi_fight_lineup_positions_sum_stats,
         hi_summon_only_in_clone_scene, hi_fight_hero_wire_handler,
         hi_equip_item_materializes_equip, hi_gem_socket_folds_stats_while_worn,
         hi_card_item_adds_hero_and_dup_stars, hi_exp_item_targets_player_or_hero,
         hi_hp_water_revives_dead_player, hi_recycled_equip_row_does_not_inherit_gems,
         hi_gems_survive_relog, hi_resummon_after_external_destroy]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[3:])
def test_hero_items_case(case):
    """tests/test_hero_items.py's cases on both packages, equal after every
    step."""
    run_both(case)
