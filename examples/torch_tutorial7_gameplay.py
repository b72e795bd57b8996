"""Tutorial 7: the gameplay middleware in one sitting — items, gems,
hero line-up, SLG city building, and social persistence — on the PyTorch
port (the counterpart of examples/tutorial7_gameplay.py; the worlds live
on ``cuda`` unless ``--device cpu``).

Builds a standard GameWorld, then walks the round-5 gameplay surface:

1. consume-process families: an equip token materializes into the bag,
   a gem sockets into it (stats fold while worn), a hero card joins the
   collection, an EXP tome levels a targeted hero;
2. the battle line-up: two heroes at two fight positions, their config
   stats x level folded into the owner's EQUIP_AWARD stat group by the
   per-tick recompute;
3. SLG city: buy a building from the shop (level gate + Gold/Diamond
   cost), upgrade it on a timer, queue production, collect accrued
   resources;
4. social persistence: mail and guild state written through a KV agent
   survive a simulated process restart WITHOUT a world checkpoint.

Reference parity: NFCItemModule + the consume family, NFCHeroModule,
NFCSLGBuildingModule/NFCSLGShopModule, NFDataAgent_NosqlPlugin.

Run:  python examples/torch_tutorial7_gameplay.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from noahgameframe_tpu_torch.game import (  # noqa: E402
    EShopType,
    GameWorld,
    ItemSubType,
    ItemType,
    PropertyGroup,
    SLGBuildingState,
    WorldConfig,
)
from noahgameframe_tpu_torch.persist import MemoryKV, SocialDataAgent  # noqa: E402


def build_world(device=None) -> GameWorld:
    # dt=1.0 so one tick == one second of SLG-timer time
    w = GameWorld(WorldConfig(combat=False, movement=False, regen=False,
                              npc_capacity=64, player_capacity=8,
                              dt=1.0), device=device).start()
    w.scene.create_scene(1)
    e = w.kernel.elements
    # item catalogue (Item.xlsx rows)
    e.add_element("Item", "blade", {"ItemType": int(ItemType.EQUIP),
                                    "ATK_VALUE": 9})
    e.add_element("Item", "ruby", {"ItemType": int(ItemType.GEM),
                                   "ATK_VALUE": 3})
    e.add_element("Item", "hero_mage", {"ItemType": int(ItemType.CARD),
                                        "ATK_VALUE": 4,
                                        "Skill1": "fireball_1"})
    e.add_element("Item", "tome", {"ItemType": int(ItemType.ITEM),
                                   "ItemSubType": int(ItemSubType.EXP),
                                   "AwardValue": 250})
    e.add_element("Skill", "fireball_1", {"AfterUpID": "fireball_2"})
    e.add_element("Skill", "fireball_2", {})
    # SLG catalogue
    e.add_element("Building", "farm", {"Type": 3, "ItemID": "bread",
                                       "ProduceTime": 2})
    e.add_element("Item", "bread", {"ItemType": int(ItemType.ITEM)})
    e.add_element("Shop", "shop_farm", {"Type": int(EShopType.BUILDING),
                                        "Level": 1, "Gold": 50,
                                        "ItemID": "farm"})
    return w


def main(device=None) -> None:
    kv = MemoryKV()
    w = build_world(device)
    SocialDataAgent(kv).bind(w.kernel, mail=w.mail, rank=w.rank,
                             guilds=w.guilds)
    k = w.kernel
    p = k.create_object("Player", {"Name": "Ada", "Account": "ada"},
                        scene=1, group=0)
    k.set_property(p, "Level", 3)
    k.set_property(p, "Gold", 500)
    k.set_property(p, "Diamond", 10)

    # 1 — items and gems
    w.pack.create_item(p, "blade", 1)
    assert w.items.use_item(p, "blade")  # EQUIP family -> BagEquipList
    equip_row = next(iter(w.pack.equips(p)))
    w.pack.create_item(p, "ruby", 1)
    assert w.items.use_item(p, "ruby", target=equip_row)  # socket the gem
    w.equip.wear(p, equip_row)
    atk = w.properties.get_group_value(p, "ATK_VALUE", PropertyGroup.EQUIP)
    print(f"worn blade + ruby -> EQUIP ATK {atk}")  # 9 + 3

    # 2 — heroes
    w.pack.create_item(p, "hero_mage", 1)
    assert w.items.use_item(p, "hero_mage")  # CARD family -> collection
    row = w.heroes.hero_row_of(p, "hero_mage")
    w.pack.create_item(p, "tome", 1)
    assert w.items.use_item(p, "tome", target=row)  # 250 exp -> level 2
    assert w.heroes.hero_skill_up(p, row, 1)  # fireball_1 -> fireball_2
    w.heroes.set_fight_hero(p, row, pos=0)
    award = w.properties.get_group_value(p, "ATK_VALUE",
                                         PropertyGroup.EQUIP_AWARD)
    print(f"fight hero level {w.heroes.hero_level(p, row)} -> "
          f"EQUIP_AWARD ATK {award}")  # 4 x 2

    # 3 — SLG city
    assert w.slg_shop.buy(p, "shop_farm", x=3, y=4)
    brow = next(iter(w.slg_building.buildings(p)))
    b = w.slg_building
    b.upgrade_s = 3
    assert b.upgrade(p, brow)
    for _ in range(4):
        w.tick()  # dt=1.0: each tick is one SLG second
    print(f"farm upgraded to level {b.building_level(p, brow)}, "
          f"state {SLGBuildingState(b.building_state(p, brow)).name}")
    assert b.produce(p, brow, "bread", 2)
    for _ in range(5):
        w.tick()
    print(f"bread produced: {w.pack.item_count(p, 'bread')}")

    # 4 — social persistence across a "process restart"
    w.mail.send("ada", "system", "Welcome!", gold=25)
    w.guilds.create_guild(p, "Pioneers")
    w2 = build_world(device)
    SocialDataAgent(kv).bind(w2.kernel, mail=w2.mail, rank=w2.rank,
                             guilds=w2.guilds)
    p2 = w2.kernel.create_object("Player", {"Name": "Ada",
                                            "Account": "ada"},
                                 scene=1, group=0)
    box = w2.mail.mailbox("ada")
    guild = w2.guilds.find_by_name("Pioneers")
    print(f"after restart: {len(box)} mail, guild "
          f"{guild.name!r} relinked={p2 in guild.members}")
    print("tutorial 7 done")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(ap.parse_args().device)
