"""The port's game role against the JAX package's, byte for byte.

Both roles serve the same world: ``build_benchmark_world(2048,
combat=True, player_capacity=64)``'s recipe (``middleware=False``) with
the guid allocator pinned before the NPCs are seeded, so both packages
mint the same guids.  Sixteen sessions with live avatars are seated from
one numpy seed; each frame ticks the world and flushes; a session joins
at frame 5 and one leaves at frame 8.  Every packet the role hands its
transport, ``(conn, msg_id, body)``, must be equal frame by frame in each
serve mode: group broadcast (no radius) and the legacy interest engine at
radius 8 here; the batched engine and overlap in
``test_torch_game_role_batch.py``; a 4-tick train in
``test_torch_game_role_train.py``.  In the batched mode both kernels drop
their captured tick at frame 9 (``invalidate()``), which must not reset
the role-held position versions.  Only the legacy mode keeps the combat
tables' overflow auto-resize on (it re-compiles the JAX tick).

Then a client script (role list, create, enter, move, chat, skill, swap
scene, leave) and two switch-ins (a good blob and a torn one) go through
both roles' dispatch tables, and the answers must be equal.
"""

from __future__ import annotations

import numpy as np
import pytest

import noahgameframe_tpu.game.world as jworld
import noahgameframe_tpu.net.roles.base as jbase
import noahgameframe_tpu.net.roles.game as jgame
import noahgameframe_tpu.net.transport as jtransport
import noahgameframe_tpu.net.wire as jwire
import noahgameframe_tpu_torch.game.world as tworld
import noahgameframe_tpu_torch.net.roles.base as tbase
import noahgameframe_tpu_torch.net.roles.game as tgame
import noahgameframe_tpu_torch.net.transport as ttransport
import noahgameframe_tpu_torch.net.wire as twire

N_NPC = 2048
SESSIONS = 16
FRAMES = 12
GUID_SEED = 7_000_000
RADIUS = 8.0

JAX = dict(world=jworld, base=jbase, game=jgame, wire=jwire, transport=jtransport, kw={})
PORT = dict(world=tworld, base=tbase, game=tgame, wire=twire, transport=ttransport,
            kw={"device": "cpu"})


def bench_world(pkg, n: int = N_NPC, combat: bool = True, seed: int = 0):
    """``build_benchmark_world(n, combat, seed, player_capacity=64)``'s
    steps, with the guid allocator pinned before the NPCs are created."""
    wm = pkg["world"]
    extent = max(64.0, float(np.sqrt(n / 0.4)))
    cap = 1 << int(np.ceil(np.log2(max(n, 64))))
    w = wm.GameWorld(wm.WorldConfig(
        npc_capacity=cap, extent=extent, combat=combat, seed=seed,
        attack_period_s=1.0, middleware=False, player_capacity=64,
    ), **pkg["kw"])
    w.start()
    w.kernel.store.guids.pin(GUID_SEED)
    w.scene.create_scene(1, width=extent)
    w.seed_npcs(n)
    return w


def make_role(pkg, world, **kw):
    role = pkg["game"].GameRole(
        pkg["base"].RoleConfig(6, 0, "ParityGame", "127.0.0.1", 0),
        backend="py", world=world, cross_server_sync=False, **kw,
    )
    sent = []
    role.server.send_raw = lambda c, m, b: (sent.append((c, m, bytes(b))), True)[1]
    return role, sent


def seat(pkg, role, i: int, x: float, y: float) -> None:
    """One session with a live Player avatar at (x, y), as bench.py seats
    them (plus a position)."""
    w = pkg["wire"]
    ident = w.Ident(svrid=99, index=i + 1)
    sess = pkg["game"].Session(ident=ident, conn_id=1000 + (i % 4), account=f"bot{i}")
    k = role.kernel
    g = k.create_object("Player", {"Name": f"Bot{i}"}, scene=1, group=0)
    k.set_property(g, "Position", (x, y, 0.0))
    sess.guid = g
    role.sessions[w.ident_key(ident)] = sess
    role._guid_session[g] = w.ident_key(ident)


def serve(pkg, mode: str, frames: int = FRAMES):
    """The per-frame packet streams of one role run in ``mode``."""
    kw = {
        "broadcast": {},
        "legacy": {"interest_radius": RADIUS, "serve_batch": False},
        "batch": {"interest_radius": RADIUS, "serve_batch": True},
        "overlap": {"interest_radius": RADIUS, "serve_overlap": True},
        "train": {"interest_radius": RADIUS, "serve_batch": False, "tick_train": 4},
    }[mode]
    world = bench_world(pkg)
    if mode != "legacy":
        # the overflow auto-resize re-compiles the JAX tick after frame 0;
        # one mode keeps it (tests/test_torch_overflow.py holds the resize
        # itself against JAX), the others spare the second compile
        world.combat.auto_resize = False
    role, sent = make_role(pkg, world, **kw)
    rng = np.random.default_rng(5)
    ext = world.config.extent
    spots = rng.uniform(1.0, ext - 1.0, (SESSIONS + 1, 2))
    for i in range(SESSIONS):
        seat(pkg, role, i, float(spots[i, 0]), float(spots[i, 1]))
    now, dt = 1000.0, world.config.dt * 1.0001
    per_frame = []
    for f in range(frames):
        if f == 5:
            seat(pkg, role, SESSIONS, float(spots[SESSIONS, 0]), float(spots[SESSIONS, 1]))
        if f == 8:
            key = sorted(role.sessions)[3]
            role._despawn(role.sessions.pop(key))
        if f == 9 and mode == "batch":
            # a dropped capture must not reset the role-held position
            # versions (_serve_qver): no client may get a full resend
            role.kernel.invalidate()
        n0 = len(sent)
        now += dt
        role.execute(now)
        per_frame.append(sent[n0:])
    return role, per_frame


def both(mode: str):
    """The JAX and the port role served in ``mode`` (a module fixture's
    value: the modes are spread over three files so that test workers
    share the JAX compiles)."""
    jrole, jframes = serve(JAX, mode)
    trole, tframes = serve(PORT, mode)
    return mode, jrole, jframes, trole, tframes


def check_streams(streams) -> None:
    """Every frame's packets, in order, equal the JAX role's."""
    mode, jrole, jframes, trole, tframes = streams
    assert (trole.serve_batch, trole.serve_overlap, trole.tick_train) == \
        (jrole.serve_batch, jrole.serve_overlap, jrole.tick_train)
    assert len(jframes) == len(tframes) == FRAMES
    for f, (a, b) in enumerate(zip(jframes, tframes)):
        assert len(a) == len(b), (mode, f, len(a), len(b))
        for i, (pa, pb) in enumerate(zip(a, b)):
            assert pa == pb, (mode, f, i, pa[:2], pb[:2])
    ids = {m for fr in jframes for _, m, _ in fr}
    lanes = {int(jgame.MsgID.ACK_INTEREST_POS)} if mode != "broadcast" else \
        {int(jgame.MsgID.ACK_BATCH_PROPERTY)}
    assert lanes <= ids, (mode, sorted(ids))
    assert jrole.kernel.tick_count == trole.kernel.tick_count


def check_worlds(streams) -> None:
    """The worlds behind the streams agree: tick, counter bank and the
    stage waterfall's stage names."""
    mode, jrole, _jf, trole, _tf = streams
    jc, tc = jrole.kernel.last_counters, trole.kernel.last_counters
    assert {k: int(v) for k, v in jc.items()} == {k: int(v) for k, v in tc.items()}, mode
    assert set(jrole.pipeline_stats()["stages"]) == set(trole.pipeline_stats()["stages"])


@pytest.fixture(scope="module", params=("broadcast", "legacy"))
def streams(request):
    return both(request.param)


def test_served_streams_equal_jax_per_frame(streams):
    check_streams(streams)


def test_served_digest_and_counters_equal_jax(streams):
    check_worlds(streams)


# ------------------------------------------------ dispatch-table script

def small_world(pkg):
    wm = pkg["world"]
    w = wm.GameWorld(wm.WorldConfig(combat=False, movement=False, regen=True,
                                    middleware=False), **pkg["kw"])
    w.start()
    w.kernel.store.guids.pin(GUID_SEED)
    return w


def client_script(pkg, blob: bytes, torn: bytes):
    """The client's messages through the role's dispatch tables; returns
    every packet sent to the proxy and to the world link."""
    w, t = pkg["wire"], pkg["transport"]
    mid = pkg["game"].MsgID
    role, sent = make_role(pkg, small_world(pkg))
    up = []
    role.world_link.send_to_all = lambda m, b: (up.append((int(m), bytes(b))), True)[1]
    me = w.Ident(svrid=99, index=1)

    def client(msg_id, msg, player=me):
        body = w.wrap(msg, player_id=player)
        role.server.dispatch.feed([t.NetEvent(t.EV_MSG, 1001, int(msg_id), body)])

    def world(msg_id, msg):
        role.world_link.dispatch.feed([t.NetEvent(t.EV_MSG, 7, int(msg_id), w.wrap(msg))])

    client(mid.REQ_ROLE_LIST, w.ReqRoleList(account=b"ada"))
    client(mid.REQ_CREATE_ROLE, w.ReqCreateRole(account=b"ada", career=1, sex=1,
                                                noob_name=b"Ada", game_id=6))
    client(mid.REQ_CREATE_ROLE, w.ReqCreateRole(account=b"ada", noob_name=b"Ada"))
    client(mid.REQ_ROLE_LIST, w.ReqRoleList(account=b"ada"))
    client(mid.REQ_ENTER_GAME, w.ReqEnterGameServer(account=b"ada", name=b"Ada", game_id=6))
    other = w.Ident(svrid=99, index=2)
    client(mid.REQ_ENTER_GAME, w.ReqEnterGameServer(account=b"bob", name=b"Bob", game_id=6),
           player=other)
    client(mid.REQ_MOVE, w.ReqAckPlayerMove(target_pos=[w.Position(x=5.5, y=7.25, z=0.0)]))
    client(mid.REQ_CHAT, w.ReqAckPlayerChat(chat_type=1, chat_info=b"hello"))
    bob = role.sessions[w.ident_key(other)].guid
    client(mid.REQ_SKILL_OBJECTX, w.ReqAckUseSkill(
        skill_id=b"s1", effect_data=[w.EffectData(
            effect_ident=w.Ident(svrid=bob.head, index=bob.data))]))
    client(mid.REQ_SWAP_SCENE, w.ReqAckSwapScene(scene_id=2))
    hp = int(role.kernel.get_property(bob, "HP"))
    client(mid.REQ_LEAVE_GAME, w.ReqRoleList())
    # switch-ins: a good blob, then a torn one
    for i, b in enumerate((blob, torn)):
        selfid = w.Ident(svrid=9, index=4242 + i)
        cid = w.Ident(svrid=5, index=77 + i)
        world(mid.SWITCH_SERVER_DATA, w.SwitchServerData(
            selfid=selfid, account=b"eve", name=b"Eve%d" % i, blob=b, target_serverid=6))
        world(mid.REQ_SWITCH_SERVER, w.ReqSwitchServer(
            selfid=selfid, self_serverid=99, target_serverid=6, gate_serverid=0,
            scene_id=1, client_id=cid, group_id=1))
    live = sorted((k, s.guid.head, s.guid.data) for k, s in role.sessions.items()
                  if s.guid is not None)
    return sent, up, hp, live


def _switch_blobs():
    """A framed save-flag snapshot of a Player (made by the JAX codec),
    and the same blob with one byte flipped."""
    from noahgameframe_tpu.persist.codec import snapshot_object
    from noahgameframe_tpu.persist.rowblob import frame_blob

    w = small_world(JAX)
    k = w.kernel
    g = k.create_object("Player", {"Name": "Eve", "Level": 7}, scene=1, group=0)
    k.set_property(g, "HP", 42)
    blob = frame_blob(snapshot_object(k.store, k.state, g))
    torn = bytearray(blob)
    torn[len(torn) // 2] ^= 0x5A
    return blob, bytes(torn)


def test_client_script_answers_equal_jax():
    blob, torn = _switch_blobs()
    js, ju, jhp, jlive = client_script(JAX, blob, torn)
    ts, tu, thp, tlive = client_script(PORT, blob, torn)
    assert jhp == thp
    assert jlive == tlive
    assert len(js) == len(ts)
    for i, (a, b) in enumerate(zip(js, ts)):
        assert a == b, (i, a[:2], b[:2])
    assert ju == tu
    mids = {m for m, _ in ju}
    assert int(jgame.MsgID.ACK_SWITCH_SERVER) in mids          # the good blob
    assert int(jgame.MsgID.ACK_SWITCH_REFUSED) in mids          # the torn one
