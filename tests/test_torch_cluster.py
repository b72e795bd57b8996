"""The port's five-role cluster against the JAX package's, client by client.

One script, :func:`roles_flows` (tests/test_roles.py's flows in
order: the status, the login chain, two clients' sync with a move, a
chat and a skill, bag records, a swap and a remove in one frame, a
private property, the columnar lane, an unauthenticated client and a
wrong connect key), runs on a port ``LocalCluster`` over a CPU world and
on a JAX ``LocalCluster`` over the same world (``combat=False,
npc_capacity=64, player_capacity=16, middleware=False``, the guid
allocator pinned), each driven by its own package's ``GameClient``.
Every client's log (every frame it received), canonicalised by
``chip_smoke.canonical_log`` (frame-trace sidecars left out, the connect
grant's port and random key zeroed, each message family sorted), and its
final mirror must be equal.  The master's status, its HTTP pages and the
frame metrics on the report ext are held to the same; ``LocalCluster()``
without a card raises instead of running on the CPU.
"""

from __future__ import annotations

import json

import pytest
import torch

import chip_smoke as cs
from test_torch_parity import one_intra_op_thread  # noqa: F401

ACCOUNTS = ("alice", "bob", "carol", "gina", "erin", "frank", "hana", "mallory", "eve")
GUID_PIN = 5_000_000


def _world(P):
    kw = {"device": "cpu"} if P.name.endswith("torch") else {}
    w = P.world.GameWorld(P.world.WorldConfig(
        combat=False, movement=False, regen=True, npc_capacity=64, player_capacity=16,
        middleware=False), **kw).start()
    w.kernel.store.guids.pin(GUID_PIN)
    return w


def roles_flows(P, cluster, timeout: float = 60.0) -> cs.ClusterDriver:
    """tests/test_roles.py's cluster flows, in order, on one cluster of
    either package (``P = cluster_package(name)``; not started: the script
    holds its games first, then starts it): the status, the login
    chain, two clients' sync, bag records, a swap and a remove in one
    frame, a private property, the columnar lane, an unauthenticated
    client and a wrong connect key, in lockstep (two frames after each
    login and level change, whose derived diffs are awaited).  Returns
    the driver: its clients' logs and mirrors are the run's
    client-visible result."""
    d = cs.ClusterDriver(P, cluster, timeout, lockstep=True)
    cluster.start(timeout=timeout)
    c, game = cluster, cluster.game
    gid = game.config.server_id
    st = c.master.servers_status()["servers"]
    cs.check(all(st.get(r) for r in ("world", "login", "game", "proxy")),
          f"the master lists every role ({sorted(st)})")
    d.login_all([("alice", "Alice", gid)])
    a = d.clients["alice"]
    d.tick(2)
    d.synced([(a, a, game)])
    me = a.objects.get(d.key(a))
    cs.check(me is not None and me.properties.get("Name") == "Alice" and "HP" in me.properties,
          "the snapshot reached the entering client")
    cs.check(len(game.scene.objects_in_group(1, 1, "Player")) >= 1, "the avatar is in scene 1")
    d.close(a, game)
    d.login_all([("bob", "Bob", gid), ("carol", "Carol", gid)])
    bob, carol = d.clients["bob"], d.clients["carol"]
    d.tick(2)
    d.synced([(x, y, game) for x in (bob, carol) for y in (bob, carol)])
    cs.pair_flows(d, bob, carol, game, move=(10.0, 20.0, 0.0))
    d.close(bob, game)
    d.close(carol, game)
    # a swap and a remove on the same rows in one frame converge
    d.login_all([("gina", "Gina", gid)])
    g = d.clients["gina"]
    d.tick(2)
    d.synced([(g, g, game)])
    k, gg, gk = game.kernel, d.guid(g), d.key(g)
    k.state, r0 = k.store.record_add_row(k.state, gg, "BagItemList",
                                         {"ConfigID": "apple", "ItemCount": 1})
    k.state, r1 = k.store.record_add_row(k.state, gg, "BagItemList",
                                         {"ConfigID": "pear", "ItemCount": 2})
    d.wait(lambda: (r1, 0) in g.objects[gk].records.get("BagItemList", {}), "two bag rows")
    k.state = k.store.record_swap_rows(k.state, gg, "BagItemList", r0, r1)
    k.state = k.store.record_remove_row(k.state, gg, "BagItemList", r0)
    cells = g.objects[gk].records["BagItemList"]
    d.wait(lambda: (r0, 0) not in cells, "the swapped row's removal")
    cs.check(cells.get((r1, 0)) == "apple" and cells.get((r1, 1)) == 1, "the swap converged")
    d.close(g, game)
    # a private property reaches its owner only
    d.login_all([("erin", "Erin", gid), ("frank", "Frank", gid)])
    e, f = d.clients["erin"], d.clients["frank"]
    d.tick(2)
    d.synced([(x, y, game) for x in (e, f) for y in (e, f)])
    ek = d.key(e)
    d.wait(lambda: ek in f.objects, "frank sees erin")
    k.set_property(d.guid(e), "Gold", 777)
    d.wait(lambda: e.objects[ek].properties.get("Gold") == 777, "the private Gold update")
    cs.check(f.objects[ek].properties.get("Gold") != 777, "Gold stays private")
    d.close(e, game)
    d.close(f, game)
    # the columnar lane lands like the per-entity path
    old = game.batch_sync_min
    game.batch_sync_min = 1
    try:
        d.login_all([("hana", "Hana", gid)])
        h = d.clients["hana"]
        hk = d.key(h)
        d.tick(2)
        d.synced([(h, h, game)])
        k.set_property(d.guid(h), "Position", (5.0, 6.0, 7.0))
        d.wait(lambda: h.objects[hk].properties.get("Position") == (5.0, 6.0, 7.0),
               "the batched Position")
        k.set_property(d.guid(h), "Level", 4)
        d.wait(lambda: h.objects[hk].properties.get("Level") == 4, "the batched Level")
        d.tick(2)
        d.synced([(h, h, game)])
    finally:
        game.batch_sync_min = old
    d.close(h, game)
    # no connect key: nothing routes; a wrong key is refused and closed
    m = d.client("mallory")
    m.connect("127.0.0.1", c.proxy.config.port)
    d.wait(lambda: m.connected, "mallory connected")
    m.request_role_list()
    d.pump(30)
    cs.check(not m.roles, "an unauthenticated client is not routed")
    d.close(m)
    e = d.client("eve")
    e.connect("127.0.0.1", c.proxy.config.port)
    d.wait(lambda: e.connected, "eve connected")
    e.world_grant = P.wire.AckConnectWorldResult(world_key=b"bogus")
    e.verify_key()
    d.wait(lambda: not e.connected, "the proxy closed the wrong key")
    cs.check(not e.key_verified, "a wrong key is refused")
    d.close(e)
    return d


def _run(name: str) -> dict:
    P = cs.cluster_package(name)
    c = P.roles.LocalCluster(backend="py", http_port=0, game_world=_world(P))
    try:
        d = roles_flows(P, c, timeout=60.0)
        out = {
            "logs": {a: cs.canonical_log(P, d.clients[a].log) for a in ACCOUNTS},
            "mirrors": {a: cs.mirror_view(d.clients[a]) for a in ACCOUNTS},
            "status": c.master.servers_status(),
            "json": json.loads(cs.http_get(c, c.master.http.port, "/json")),
            "page": cs.http_get(c, c.master.http.port, "/"),
        }
        for _ in range(5):
            with c.game.metrics.frame():
                c.execute()
        r = c.game.report()
        out["ext_keys"] = sorted(k.decode() for k in r.server_info_list_ext.key)
        out["report_type"] = int(r.server_type)
        return out
    finally:
        c.shut()


@pytest.fixture(scope="module")
def runs():
    return {"jax": _run("noahgameframe_tpu"), "port": _run("noahgameframe_tpu_torch")}


@pytest.mark.parametrize("account", ACCOUNTS)
def test_client_log_equals_jax(runs, account):
    port, ref = runs["port"]["logs"][account], runs["jax"]["logs"][account]
    assert port == ref
    if account not in ("mallory", "eve"):
        assert sum(len(v) for v in port.values()) >= 10


@pytest.mark.parametrize("account", ACCOUNTS)
def test_client_mirror_equals_jax(runs, account):
    assert runs["port"]["mirrors"][account] == runs["jax"]["mirrors"][account]


def _servers(status):
    return {role: [(e["server_id"], e["name"], e["type"], e["lease"]) for e in entries]
            for role, entries in status["servers"].items()}


def test_master_status_equals_jax(runs):
    port, ref = runs["port"]["status"], runs["jax"]["status"]
    assert _servers(port) == _servers(ref)
    assert sorted(port["servers"]) == ["game", "login", "proxy", "world"]
    assert port["master"]["server_id"] == ref["master"]["server_id"] == 1


def test_http_monitor_equals_jax(runs):
    for pkg in ("port", "jax"):
        data = runs[pkg]["json"]
        assert data["master"]["server_id"] == 1
        assert data["servers"]["world"][0]["server_id"] == 7
        assert b"Cluster status" in runs[pkg]["page"]
    assert _servers(runs["port"]["json"]) == _servers(runs["jax"]["json"])


def test_frame_metrics_ride_report_ext(runs):
    assert "frame_p99_ms" in runs["port"]["ext_keys"]
    assert set(runs["jax"]["ext_keys"]) - {"costbook"} <= set(runs["port"]["ext_keys"])


def test_game_role_reports_the_game_type(runs):
    """The port's GameRole reported ``ServerType.NONE`` (no class-level
    ``server_type``): the world booked its reports as a proxy's and the
    master listed it under "none".  It reports GAME, as JAX's does."""
    from noahgameframe_tpu_torch.net.defines import ServerType

    assert runs["port"]["report_type"] == runs["jax"]["report_type"] == int(ServerType.GAME)


def test_local_cluster_without_a_card_raises(monkeypatch):
    """``device=None`` means cuda: without a card the cluster raises before
    it opens a socket; a cluster whose games all bring a world keeps their
    device."""
    from noahgameframe_tpu_torch.net.roles import LocalCluster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalCluster(backend="py")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalCluster(backend="py", n_games=2, game_world=_world(cs.cluster_package()))
    c = LocalCluster(backend="py", game_world=_world(cs.cluster_package()))
    try:
        assert c.game.kernel.device.type == "cpu"
    finally:
        c.shut()


def test_clone_scene_routing():
    """tests/test_roles.py's clone-scene routing on the port's game role:
    a SceneType=CLONE scene mints a private instance per enterer."""
    from noahgameframe_tpu_torch.game.scene_process import SCENE_TYPE_CLONE
    from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig
    from noahgameframe_tpu_torch.net.roles.base import RoleConfig
    from noahgameframe_tpu_torch.net.roles.game import GameRole

    role = GameRole(RoleConfig(6, 0, "CloneGame", "127.0.0.1", 0), backend="py",
                    world=GameWorld(WorldConfig(combat=False, movement=False, regen=False,
                                                middleware=False), device="cpu").start(),
                    cross_server_sync=False)
    k = role.kernel
    k.elements.add_element("Scene", "9", {"SceneType": SCENE_TYPE_CLONE})
    a = k.create_object("Player", scene=1, group=0)
    b = k.create_object("Player", scene=1, group=0)
    ga, gb = role._enter_scene(a, 9), role._enter_scene(b, 9)
    assert ga != gb
    assert role._enter_scene(a, 5) == 1
    assert ga not in role.scene.scenes[9].groups and gb in role.scene.scenes[9].groups
    assert role._enter_scene(b, 5) == 1
    assert gb not in role.scene.scenes[9].groups
    role.shut()
