"""Tutorial 3 — heartbeats, events, property callbacks on a live world, on
the PyTorch port.

The port's counterpart of examples/tutorial3_heartbeat_events.py (the
reference's Tutorial3, `Tutorial/Tutorial3/HelloWorld3Module.cpp:36-104`):
create a Player, register a heartbeat and an event, wire a property
callback, and watch them fire as the world ticks.  The heartbeat is a
timer column and the tick one step on the device (``cuda`` unless
``--device cpu``), but the observable behavior matches.

Run:  python examples/torch_tutorial3_heartbeat_events.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from noahgameframe_tpu_torch.game import GameWorld, WorldConfig  # noqa: E402

EVENT_LEVEL_REWARD = 1001


def main(device=None) -> None:
    world = GameWorld(WorldConfig(combat=False, movement=False, regen=True,
                                  npc_capacity=16, player_capacity=4,
                                  regen_period_s=2 / 30), device=device).start()
    world.scene.create_scene(1)
    k = world.kernel

    player = k.create_object("Player", {"Name": "Hero"}, scene=1, group=0)
    world.properties.set_group_value(player, "MAXHP", 1, 100)
    world.properties.set_group_value(player, "HPREGEN", 1, 5)
    world.properties.recompute_now(player)
    k.set_property(player, "HP", 50)
    world.regen.arm_all("Player")

    # property callback: fires for host writes AND device-tick changes
    k.register_property_event(
        "Player", "HP",
        lambda cname, pname, rows: print(f"  HP changed (rows {rows})"))

    # integer-ID event pub/sub (reference NFCEventModule DoEvent)
    k.events.subscribe(
        EVENT_LEVEL_REWARD,
        lambda guid, eid, args: print(f"  event {eid} for {guid}: {args}"))

    print("ticking; HP regens on the 2-tick heartbeat:")
    for i in range(6):
        world.tick()
        print(f"frame {k.tick_count}: HP={int(k.get_property(player, 'HP'))}")

    print("firing a host event:")
    k.events.do_event(player, EVENT_LEVEL_REWARD, {"gold": 25})
    print("tutorial3 done")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(ap.parse_args().device)
