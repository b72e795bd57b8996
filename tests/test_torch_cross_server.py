"""Cross-game-server sync and the ``switch_server`` re-home on a two-game
port cluster, against the JAX package's cluster on the same script.

tests/test_cross_server.py's flows, in lockstep (the games tick only
where the script says, ``chip_smoke.ClusterDriver``): a public change on
a player bound to game A reaches a client bound to game B through the world's relay (and
the offline notice drops the remote mirror); then a player switches from
A to B, A frees its copy, B holds the saved properties under a new guid,
the proxy routes the client's chat to B, and the client's disconnect
reaches B.  Both clusters serve the same worlds (``combat=False,
movement=False, regen=True, middleware=False``, each game's guid
allocator pinned at its own base) and each is driven by its own
package's ``GameClient``; the canonicalised client logs
(``chip_smoke.canonical_log``), the final mirrors and what B holds must
be equal.
"""

from __future__ import annotations

import pytest

import chip_smoke as cs

PINS = {"Game1": 5_000_000, "Game2": 6_000_000}


def _world(P, pin):
    kw = {"device": "cpu"} if P.name.endswith("torch") else {}
    w = P.world.GameWorld(P.world.WorldConfig(
        combat=False, movement=False, regen=True, middleware=False), **kw).start()
    w.kernel.store.guids.pin(pin)
    return w


def script(P) -> dict:
    c = P.roles.LocalCluster(backend="py", n_games=2, game_kwargs_by_name={
        name: {"world": _world(P, pin)} for name, pin in PINS.items()})
    out: dict = {}
    try:
        d = cs.ClusterDriver(P, c, timeout=60.0, lockstep=True)
        c.start(timeout=60.0)
        game_a, game_b = c.games
        a_id, b_id = game_a.config.server_id, game_b.config.server_id
        d.login_all([("ana", "Ana", a_id)])
        d.login_all([("ben", "Ben", b_id)])
        ana, ben = d.clients["ana"], d.clients["ben"]
        d.tick(2)
        d.synced([(ana, ana, game_a), (ben, ben, game_b), (ben, ana, game_a)])
        out["roster"] = len(c.world.roster)
        akey = d.key(ana)
        game_a.kernel.set_property(d.guid(ana), "Level", 9)
        d.wait(lambda: akey in ben.objects and ben.objects[akey].properties.get("Level") == 9,
               "game A's Level change reached the client on game B")
        d.wait(lambda: ana.objects[akey].properties.get("Level") == 9, "ana's own mirror")
        d.tick(2)
        d.synced([(ana, ana, game_a), (ben, ana, game_a)])
        d.close(ana)
        d.wait(lambda: akey not in ben.objects, "the offline notice dropped the remote mirror")
        d.login_all([("mover", "Mover", a_id)])
        mover = d.clients["mover"]
        ga = d.guid(mover)
        game_a.kernel.set_property(ga, "Level", 7)
        game_a.kernel.set_property(ga, "Gold", 321)
        d.tick(2)
        d.synced([(mover, mover, game_a), (ben, mover, game_a)], ("MAXEXP", "Level"))
        out["switch_accepted"] = bool(game_a.switch_server(ga, b_id))
        d.wait(lambda: d.session(game_b, "mover") is not None, "the session moved to B")
        d.tick(2)
        d.wait(lambda: ga not in game_a.kernel.store.guid_map, "A freed its copy")
        out["a_session_left"] = d.session(game_a, "mover") is None
        gb = d.session(game_b, "mover").guid
        k = game_b.kernel
        out["on_b"] = (str(gb), int(k.get_property(gb, "Level")), int(k.get_property(gb, "Gold")),
                       str(k.get_property(gb, "Name")), int(k.get_property(gb, "GameID")))
        n0 = len(mover.chat_log)
        mover.chat("hello from B")
        d.wait(lambda: len(mover.chat_log) > n0, "the chat after the switch")
        out["chat"] = mover.chat_log[n0:]
        d.close(mover, game_b)
        out["b_freed"] = gb not in game_b.kernel.store.guid_map
        d.close(ben)
        out["logs"] = {a: cs.canonical_log(P, cl.log) for a, cl in d.clients.items()}
        out["mirrors"] = {a: cs.mirror_view(cl) for a, cl in d.clients.items()}
        return out
    finally:
        c.shut()


@pytest.fixture(scope="module")
def runs():
    return {"jax": script(cs.cluster_package("noahgameframe_tpu")),
            "port": script(cs.cluster_package("noahgameframe_tpu_torch"))}


def test_switch_outcome_equals_jax(runs):
    port, ref = runs["port"], runs["jax"]
    for key in ("roster", "switch_accepted", "a_session_left", "on_b", "chat", "b_freed"):
        assert port[key] == ref[key], key
    assert port["roster"] >= 2 and port["switch_accepted"] and port["b_freed"]
    _guid, level, gold, name, game_id = port["on_b"]
    assert (level, gold, name, game_id) == (7, 321, "Mover", 16)
    assert any("hello from B" in t for _w, t in port["chat"])


@pytest.mark.parametrize("account", ("ana", "ben", "mover"))
def test_client_log_equals_jax(runs, account):
    assert runs["port"]["logs"][account] == runs["jax"]["logs"][account]


@pytest.mark.parametrize("account", ("ana", "ben", "mover"))
def test_client_mirror_equals_jax(runs, account):
    assert runs["port"]["mirrors"][account] == runs["jax"]["mirrors"][account]
