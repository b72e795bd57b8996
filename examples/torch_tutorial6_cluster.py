"""Tutorial 6: the five-role cluster, end to end, in one process, on the
PyTorch port.

The port's counterpart of examples/tutorial6_cluster.py.  Boots
master/login/world/proxy/game on loopback sockets (LocalCluster), the
game's world on the device (``cuda`` unless ``--device cpu``), then drives
a real client through the full reference login pipeline — login -> world
list -> select world -> proxy connect-key -> select game server -> create
role -> enter game — and finally moves and chats, with the client's
object mirror converging from the server's per-frame property sync (the
§3.3 spine).

Reference parity: the _Out/Tester rund_*.sh bring-up plus the
NFClient login flow (NFCLoginNet_ServerModule::OnLoginProcess,
NFCProxyServerNet_ServerModule::OnConnectKeyProcess,
NFCGameServerNet_ServerModule::OnClienEnterGameProcess).

Run:  python examples/torch_tutorial6_cluster.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from noahgameframe_tpu_torch.client import GameClient  # noqa: E402
from noahgameframe_tpu_torch.game import GameWorld, WorldConfig  # noqa: E402
from noahgameframe_tpu_torch.net.roles import LocalCluster  # noqa: E402


def pump(cluster, client, cond, timeout=10.0):
    ok = cluster.pump_until(cond, extra=client.execute, timeout=timeout)
    if not ok:
        raise TimeoutError(f"cluster timed out waiting for {cond}")


def main(device=None) -> None:
    world = GameWorld(
        WorldConfig(combat=False, movement=False, regen=True,
                    npc_capacity=64, player_capacity=16),
        device=device,
    ).start()
    cluster = LocalCluster(http_port=0, game_world=world, device=device)
    cluster.start(timeout=20.0)
    print("cluster up:", sorted(cluster.master.servers_status()["servers"]))

    c = GameClient("tutorial6")
    c.connect("127.0.0.1", cluster.login.config.port)
    pump(cluster, c, lambda: c.connected)
    c.login()
    pump(cluster, c, lambda: c.logged_in)
    c.request_world_list()
    pump(cluster, c, lambda: c.worlds)
    c.connect_world(c.worlds[0].server_id)
    pump(cluster, c, lambda: c.world_grant is not None)
    c.connect_proxy()
    pump(cluster, c, lambda: c.connected)
    c.verify_key()
    pump(cluster, c, lambda: c.key_verified)
    c.select_server(cluster.game.config.server_id)
    pump(cluster, c, lambda: c.server_selected)
    c.create_role("Hero6")
    pump(cluster, c, lambda: c.roles)
    c.enter_game("Hero6")
    pump(cluster, c, lambda: c.entered)
    print("entered game; avatar guid:", c.player_guid)

    # move: the server's per-frame diff flush lands in the client mirror
    key = (c.player_guid.svrid, c.player_guid.index)
    c.move_to(12.0, 34.0, 0.0)
    pump(cluster, c, lambda: (
        key in c.objects
        and c.objects[key].properties.get("Position", (0, 0, 0))[0] == 12.0
    ))
    print("mirror position:", c.objects[key].properties["Position"])

    c.chat("hello from tutorial 6")
    pump(cluster, c, lambda: c.chat_log)
    print("chat echoed:", c.chat_log[-1][1])

    cluster.shut()
    print("tutorial6 done")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(ap.parse_args().device)
