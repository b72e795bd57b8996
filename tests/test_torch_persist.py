"""The port's persistence slice against the JAX package on the CPU.

- Whole-world checkpoints: a JAX-saved checkpoint resumes in the port and
  a port-saved one in the JAX package, with equal 20-tick digest streams
  (no skin, and NF_VERLET_SKIN=2.0); both packages' checkpoints of one
  world are equal key by key; the same doctored checkpoints are refused;
  a rewind repeats its stream.
- The per-object codec: snapshot_object gives JAX's bytes, and
  apply_snapshot / resolve_pending give equal states.
- PlayerDataAgent over MemoryKV, FileKV and RespKV against MiniRedisServer
  gives JAX's blobs.
- The host modules the port copies (KV backends, SQL, MySQL, the
  write-behind pipeline) pass the reference's standalone cases.

Tolerance 0 everywhere."""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import socket as _socket
import struct as _struct
import threading
import time
import zlib

import numpy as np
import pytest

from noahgameframe_tpu.core.datatypes import Guid as JGuid
from noahgameframe_tpu.core.schema import ClassDef as JClassDef
from noahgameframe_tpu.core.schema import ClassRegistry as JRegistry
from noahgameframe_tpu.core.schema import prop as jprop
from noahgameframe_tpu.core.schema import record as jrecord
from noahgameframe_tpu.core.store import EntityStore as JStore
from noahgameframe_tpu.core.store import StoreConfig as JStoreConfig
from noahgameframe_tpu.game.world import GameWorld as JWorld
from noahgameframe_tpu.game.world import WorldConfig as JConfig
from noahgameframe_tpu.persist import FileKV as JFileKV
from noahgameframe_tpu.persist import MemoryKV as JMemoryKV
from noahgameframe_tpu.persist import PlayerDataAgent as JAgent
from noahgameframe_tpu.persist import RespKV as JRespKV
from noahgameframe_tpu.persist import load_world as jload_world
from noahgameframe_tpu.persist.codec import apply_snapshot as japply
from noahgameframe_tpu.persist.codec import resolve_pending as jresolve
from noahgameframe_tpu.persist.codec import snapshot_object as jsnapshot
from noahgameframe_tpu_torch.core.datatypes import Guid
from noahgameframe_tpu_torch.core.schema import ClassDef, ClassRegistry, prop, record
from noahgameframe_tpu_torch.core.store import EntityStore, StoreConfig, state_to_numpy
from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig
from noahgameframe_tpu_torch.net.retry import RetryPolicy
from noahgameframe_tpu_torch.net.wire import RoleLiteInfo
from noahgameframe_tpu_torch.persist import (
    FileKV,
    KVBackend,
    MemoryKV,
    MiniRedisServer,
    PlayerDataAgent,
    RespKV,
    RoleListStore,
    SqlModule,
    StagingWAL,
    StoreBackend,
    WALError,
    WriteBehindPipeline,
    apply_snapshot,
    emit_ddl,
    load_world,
    peek_checkpoint,
    resolve_pending,
    save_world,
    snapshot_object,
)
from noahgameframe_tpu_torch.persist.mysql import (
    _CAPS,
    MiniMysql,
    MysqlClient,
    MysqlError,
    MysqlModule,
    _mysql_to_sqlite,
    _PacketIO,
    scramble_native,
)
from noahgameframe_tpu_torch.persist.sql import (
    DRV_CONNECTED,
    DRV_DISCONNECTED,
    SqlDriver,
    SqlDriverManager,
    SqlServerConfig,
)
from noahgameframe_tpu_torch.persist.writebehind import (
    HEADER,
    MAX_RECORD_SIZE,
    WAL_MAGIC,
    WB_BATCH,
    Batch,
    decode_batch,
    encode_batch,
)
from test_torch_parity import assert_tree_equal, jax_tree

# ---------------------------------------------------------------- checkpoints

N_NPC = 1500  # on 2,048 NPC rows
SEED = 3


@contextlib.contextmanager
def _skin(skin: str):
    """NF_VERLET_SKIN while worlds are built (CombatModule reads it then)."""
    old = os.environ.pop("NF_VERLET_SKIN", None)
    if skin:
        os.environ["NF_VERLET_SKIN"] = skin
    try:
        yield
    finally:
        os.environ.pop("NF_VERLET_SKIN", None)
        if old is not None:
            os.environ["NF_VERLET_SKIN"] = old


def _recipe(jax_side: bool, skin: str = ""):
    """build_benchmark_world(1500)'s world in either package, guids pinned
    so both packages mint the same ones, digest on."""
    extent = max(64.0, float(np.sqrt(N_NPC / 0.4)))
    with _skin(skin):
        if jax_side:
            w = JWorld(JConfig(npc_capacity=2048, extent=extent, seed=SEED,
                               middleware=False)).start()
        else:
            w = GameWorld(WorldConfig(npc_capacity=2048, extent=extent, seed=SEED,
                                      middleware=False), device="cpu").start()
    w.kernel.store.guids.pin(1000)
    w.scene.create_scene(1, width=extent)
    w.seed_npcs(N_NPC)
    w.kernel.enable_digest()
    return w


def _stream(w, ticks: int):
    out = []
    for _ in range(ticks):
        w.tick()
        out.append(dict(w.kernel.last_counters))
    return out


def _host_view(store) -> dict:
    """The host bookkeeping a load rebuilds, in plain Python."""
    return {
        "guids": {f"{g.head}-{g.data}": h for g, h in store.guid_map.items()},
        "strings": store.strings.snapshot(),
        "hosts": {c: (list(h.free), [str(g) for g in h.row_guid], h.live_count,
                      h.alloc_mask.tolist(), h.guid_head.tolist(), h.guid_data.tolist())
                  for c, h in store._hosts.items()},
    }


@pytest.fixture(scope="module", params=["", "2.0"], ids=["skin0", "skin2"])
def saved(request, tmp_path_factory):
    """Both packages tick the same world 12 times (equal counters each
    tick) and save it; a fresh JAX world loads the JAX checkpoint and
    ticks 20 more: the reference stream."""
    skin = request.param
    d = tmp_path_factory.mktemp("ckpt")
    a, b = _recipe(True, skin), _recipe(False, skin)
    for t in range(12):
        a.tick()
        b.tick()
        assert b.kernel.last_counters == a.kernel.last_counters, t
    a.save(d / "jax")
    split = b.save(d / "port")
    ref_world = _recipe(True, skin)
    ref_world.load(d / "jax")
    host = _host_view(ref_world.kernel.store)
    ref = _stream(ref_world, 20)
    return {"dir": d, "skin": skin, "ref": ref, "host": host, "split": split}


def test_jax_checkpoint_resumes_in_port(saved):
    """A fresh port world loads the JAX checkpoint: the same host
    bookkeeping as JAX's fresh-world load, then the same 20-tick stream."""
    w = _recipe(False, saved["skin"])
    out = w.load(saved["dir"] / "jax")
    assert set(out) == {"read_s", "h2d_s"}
    assert _host_view(w.kernel.store) == saved["host"]
    assert w.kernel.tick_count == 12
    assert _stream(w, 20) == saved["ref"]
    assert sum(c["combat_hits"] for c in saved["ref"]) > 0


def test_port_checkpoint_resumes_in_jax(saved):
    """The other direction: a fresh JAX world loads the port's checkpoint
    and ticks the port's own fresh-world stream (which is the reference's)."""
    w = _recipe(False, saved["skin"])
    w.load(saved["dir"] / "port")
    port = _stream(w, 20)
    j = _recipe(True, saved["skin"])
    jload_world(j.kernel, saved["dir"] / "port", modules=j.all_modules)
    assert _stream(j, 20) == port == saved["ref"]


def test_checkpoints_of_one_world_equal_key_by_key(saved):
    """The port's arrays.npz has JAX's keys, dtypes, shapes and bytes (rng
    as uint32[2]), and its meta.json JAX's fields and values."""
    d = saved["dir"]
    with np.load(d / "jax" / "arrays.npz") as zj, np.load(d / "port" / "arrays.npz") as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for k in zj.files:
            aj, ap = zj[k], zp[k]
            assert (aj.dtype, aj.shape) == (ap.dtype, ap.shape), k
            assert aj.tobytes() == ap.tobytes(), k
        assert zp["rng"].dtype == np.uint32 and zp["tick"].dtype == np.int32
    mj = json.loads((d / "jax" / "meta.json").read_text())
    mp = json.loads((d / "port" / "meta.json").read_text())
    assert mj == mp
    with np.load(d / "port" / "arrays.npz") as zp:
        raw = sum(zp[k].nbytes for k in zp.files)
    split = saved["split"]
    assert split["raw_bytes"] == raw
    assert 0 < split["bytes_on_disk"] < raw


def _small(jax_side: bool, npc_capacity: int = 64):
    if jax_side:
        w = JWorld(JConfig(combat=False, movement=False, regen=False, middleware=False,
                           npc_capacity=npc_capacity, player_capacity=16)).start()
    else:
        w = GameWorld(WorldConfig(combat=False, movement=False, regen=False,
                                  middleware=False, npc_capacity=npc_capacity,
                                  player_capacity=16), device="cpu").start()
    w.kernel.store.guids.pin(500)
    w.scene.create_scene(1)
    return w


def _doctor(path, case):
    meta = json.loads((path / "meta.json").read_text())
    if case == "torn":
        meta["array_tick"] += 1
    elif case == "classes":
        meta["class_order"] = list(reversed(meta["class_order"]))
    (path / "meta.json").write_text(json.dumps(meta))


@pytest.mark.parametrize("case", ["torn", "classes", "capacity"])
def test_doctored_checkpoint_refused_by_both(tmp_path, case):
    """A torn arrays/meta pair, another class order and another capacity
    raise ValueError in both packages, and the port's world is untouched."""
    w = _small(False)
    w.seed_npcs(10)
    w.run(2)
    save_world(w.kernel, tmp_path / "ck")
    _doctor(tmp_path / "ck", case)
    cap = 128 if case == "capacity" else 64
    target, jtarget = _small(False, cap), _small(True, cap)
    before = state_to_numpy(target.kernel.state)
    with pytest.raises(ValueError):
        load_world(target.kernel, tmp_path / "ck")
    with pytest.raises(ValueError):
        jload_world(jtarget.kernel, tmp_path / "ck")
    assert_tree_equal(before, state_to_numpy(target.kernel.state))
    assert target.kernel.tick_count == 0


def test_rewind_repeats_stream(tmp_path):
    """Loading a checkpoint back into the kernel that saved it repeats its
    stream and its host bookkeeping (a create and a destroy included), and
    peek_checkpoint reads the basis tick."""
    w = GameWorld(WorldConfig(npc_capacity=256, player_capacity=8, extent=24.0, seed=9),
                  device="cpu").start()
    w.kernel.store.guids.pin(50)
    w.scene.create_scene(1, width=24.0)
    w.seed_npcs(200, hp=5)
    w.kernel.enable_digest()
    w.run(5)
    assert peek_checkpoint(tmp_path / "ck") is None
    save_world(w.kernel, tmp_path / "ck")
    save_world(w.kernel, tmp_path / "ck")  # over an existing checkpoint
    assert peek_checkpoint(tmp_path / "ck") == {"tick_count": 5, "array_tick": 5}
    host0 = _host_view(w.kernel.store)
    npc = min((g for g, h in w.kernel.store.guid_map.items()
               if w.kernel.store.row_of(g)[0] == "NPC"), key=lambda g: g.data)

    def run():
        w.kernel.store.guids.pin(900)  # a checkpoint does not carry the allocator
        g = w.kernel.create_object("Player", {"Name": "R", "Account": "r"}, scene=1)
        w.kernel.destroy_object(npc, deferred=True)
        return _stream(w, 15), str(g), _host_view(w.kernel.store)

    first = run()
    assert sum(c["combat_hits"] for c in first[0]) > 0
    assert npc not in w.kernel.store.guid_map
    w.load(tmp_path / "ck")
    assert _host_view(w.kernel.store) == host0 and npc in w.kernel.store.guid_map
    assert run() == first


# ---------------------------------------------------------------- codec


def _conv(x, jax_side: bool):
    if isinstance(x, (Guid, JGuid)):
        return (JGuid if jax_side else Guid)(x.head, x.data)
    if isinstance(x, dict):
        return {k: _conv(v, jax_side) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_conv(v, jax_side) for v in x)
    return x


def _both(fn):
    """fn(world, jax_side) on a JAX and a port small world."""
    out = []
    for jax_side in (True, False):
        w = _small(jax_side)
        out.append((w, fn(w, jax_side)))
    return out


def _player_with_refs(w, jax_side):
    """A guild, two players: OBJECT, vector and string cells in properties
    and in a record (BagEquipList), a self-reference among them."""
    k = w.kernel
    G = JGuid if jax_side else Guid
    guild = k.create_object("Guild", {"Name": "Order", "GuildLevel": 3}, guid=G(4, 40))
    other = k.create_object("Player", {"Name": "Bo", "Account": "b"}, scene=1, guid=G(4, 41))
    g = k.create_object("Player", {"Name": "Ann", "Account": "a", "Gold": 77, "Level": 5,
                                   "Position": (1.5, -2.25, 3.0), "GuildID": guild,
                                   "MoveTo": (0.1, 0.2)}, scene=1, guid=G(4, 42))
    k.set_property(guild, "LeaderID", g)
    st = k.store
    k.state, _ = st.record_add_row(k.state, g, "BagEquipList",
                                   {"GUID": other, "WearGUID": g, "ConfigID": "sword",
                                    "SlotCount": 2, "InlayInfo": "ruby;opal"})
    k.state = st.record_restore_row(k.state, g, "BagEquipList", 5,
                                    {"GUID": guild, "ConfigID": "shield"})
    k.state, _ = st.record_add_row(k.state, g, "TaskList", {"TaskID": "t1", "Process": 4})
    return guild, other, g


def test_snapshot_object_bytes_equal_jax():
    """Player, guild and a custom class with vector record cells: the
    port's blobs are JAX's, byte for byte."""
    blobs = []
    for w, (guild, other, g) in _both(_player_with_refs):
        snap = jsnapshot if isinstance(w, JWorld) else snapshot_object
        k = w.kernel
        blobs.append([snap(k.store, k.state, x, flags)
                      for x in (g, guild, other) for flags in (("save",), ("public", "private"))])
    assert blobs[0] == blobs[1]
    assert all(len(b) > 10 for b in blobs[1])


def _thing_store(jax_side: bool):
    cd, pr, rc = (JClassDef, jprop, jrecord) if jax_side else (ClassDef, prop, record)
    reg = (JRegistry if jax_side else ClassRegistry)()
    reg.define(cd("Thing", properties=[pr("X", "int", save=True), pr("F", "float", save=True),
                                       pr("W", "vector2", save=True)],
                  records=[rc("Refs", 4, [("Who", "object"), ("At", "vector3"),
                                          ("N", "int"), ("S", "string"), ("Q", "float")],
                              save=True)]))
    if jax_side:
        s = JStore(reg, JStoreConfig(default_capacity=8))
    else:
        s = EntityStore(reg, StoreConfig(default_capacity=8), device="cpu")
    s.guids.pin(10)
    return s


def test_codec_vector_and_object_record_cells_match_jax():
    """Vector, float, string and OBJECT record cells: equal blobs; applying
    a blob onto a recreated entity gives equal trees in both packages,
    with a dangling reference dropped and a self-reference remapped."""
    out = []
    for jax_side in (True, False):
        store = _thing_store(jax_side)
        snap, apply_ = (jsnapshot, japply) if jax_side else (snapshot_object, apply_snapshot)
        state = store.init_state()
        state, target, _ = store.create_object(state, "Thing")
        state, owner, _ = store.create_object(state, "Thing", values={
            "X": 9, "F": 0.3, "W": (1.25, -4.0)})
        state, _ = store.record_add_row(state, owner, "Refs", {
            "Who": target, "At": (1.0, 2.0, 3.0), "N": 5, "S": "x", "Q": -0.1})
        state, _ = store.record_add_row(state, owner, "Refs", {"Who": owner, "N": 6})
        blob = snap(store, state, owner, ("save",))
        state = store.destroy_object(state, target)
        state, _filler, _ = store.create_object(state, "Thing")
        state, fresh, _ = store.create_object(state, "Thing")
        state = apply_(store, state, fresh, blob)
        out.append((blob, store, state, fresh))
    (bj, sj, stj, fj), (bp, sp, stp, fp) = out
    assert bj == bp
    assert_tree_equal(jax_tree(stj), state_to_numpy(stp))
    assert sp.record_get(stp, fp, "Refs", 1, "Who") == fp  # remapped self
    assert sp.record_get(stp, fp, "Refs", 0, "Who") == Guid()  # dangling, dropped


def test_apply_and_resolve_pending_match_jax():
    """A player blob applied before its guild exists defers the GuildID
    and the record's guild cell; once the guild is loaded, resolve_pending
    fills both.  Equal pending lists and trees in both packages."""
    blobs = {}
    for w, refs in _both(_player_with_refs):
        snap = jsnapshot if isinstance(w, JWorld) else snapshot_object
        k = w.kernel
        blobs[isinstance(w, JWorld)] = [snap(k.store, k.state, x, ("save",)) for x in refs]
    assert blobs[True] == blobs[False]
    guild_blob, other_blob, player_blob = blobs[False]
    res = []
    for jax_side in (True, False):
        w = _small(jax_side)
        k = w.kernel
        G = JGuid if jax_side else Guid
        apply_, resolve = (japply, jresolve) if jax_side else (apply_snapshot, resolve_pending)
        pending = []
        p = k.create_object("Player", {"Name": "Ann", "Account": "a"}, scene=1, guid=G(4, 42))
        k.state = apply_(k.store, k.state, p, player_blob, pending)
        first = [(str(o), s, str(t)) for o, s, t in pending]
        g = k.create_object("Guild", guid=G(4, 40))
        k.state = apply_(k.store, k.state, g, guild_blob, pending)
        k.state, left = resolve(k.store, k.state, pending)
        res.append((first, [(str(o), s, str(t)) for o, s, t in left], k))
    (fj, lj, kj), (fp, lp, kp) = res
    assert fj == fp and len(fp) == 3  # GuildID, the record's guild cell, other player
    assert lj == lp and len(lp) == 1  # the other player never loaded
    assert_tree_equal(jax_tree(kj.state), state_to_numpy(kp.state))
    assert kp.get_property(Guid(4, 42), "GuildID") == Guid(4, 40)


def _kv_pair(kind, tmp_path):
    """A KV of ``kind`` for each package (RESP: one MiniRedisServer each)."""
    if kind == "memory":
        return JMemoryKV(), MemoryKV(), []
    if kind == "file":
        return JFileKV(tmp_path / "j"), FileKV(tmp_path / "p"), []
    servers = [MiniRedisServer(), MiniRedisServer()]
    return (JRespKV("127.0.0.1", servers[0].port), RespKV("127.0.0.1", servers[1].port),
            servers)


@pytest.mark.parametrize("kind", ["memory", "file", "resp"])
def test_agent_blobs_equal_across_backends(tmp_path, kind):
    """PlayerDataAgent: save on destroy, load on create (the CREATE_LOADDATA
    attach), per character; the stored blobs and the reloaded players are
    JAX's."""
    kj, kp, servers = _kv_pair(kind, tmp_path)
    try:
        res = []
        for jax_side, kv in ((True, kj), (False, kp)):
            w = _small(jax_side)
            k = w.kernel
            agent = (JAgent if jax_side else PlayerDataAgent)(kv).bind(k)
            guild, other, g = _player_with_refs(w, jax_side)
            k.set_property(g, "Level", 9)
            k.destroy_object(g)
            k.destroy_object(other)
            assert agent.exists("a:Ann") and agent.exists("b:Bo")
            g2 = k.create_object("Player", {"Account": "a", "Name": "Ann"}, scene=1)
            fresh = k.create_object("Player", {"Account": "a", "Name": "Cy"}, scene=1)
            res.append((kv, k, g2, fresh, agent.resolve_refs()))
        (kvj, kj_, gj, fj, lj), (kvp, kp_, gp, fp, lp) = res
        for key in ("obj:a:Ann", "obj:b:Bo"):
            assert kvp.get(key) == kvj.get(key) is not None
        assert lj == lp
        assert_tree_equal(jax_tree(kj_.state), state_to_numpy(kp_.state))
        assert int(kp_.get_property(gp, "Level")) == 9
        assert kp_.get_property(gp, "GuildID") == Guid(4, 40)
        assert int(kp_.get_property(fp, "Gold")) == 0  # another character
    finally:
        for s in servers:
            s.close()


def test_role_list_store():
    kv = MemoryKV()
    rs = RoleListStore(kv)
    assert rs.load("acc") == []
    rs.save("acc", [RoleLiteInfo(noob_name=b"Hero", career=2, role_level=3)])
    back = rs.load("acc")
    assert len(back) == 1 and back[0].noob_name == b"Hero" and back[0].career == 2


# ---------------------------------------------------------------- KV backends
# (the reference's tests/test_persist.py cases, on the port's copies)


def exercise_kv(kv):
    assert kv.get("a") is None
    kv.set("a", b"1")
    kv.set("b:x", b"2")
    assert kv.get("a") == b"1"
    assert kv.exists("b:x") and not kv.exists("nope")
    assert kv.keys("b:*") == ["b:x"]
    assert set(kv.keys()) >= {"a", "b:x"}
    assert kv.delete("a") and not kv.exists("a")
    kv.hset("h", "f1", b"v1")
    kv.hset("h", "f2", b"v2")
    assert kv.hget("h", "f1") == b"v1"
    assert kv.hgetall("h") == {"f1": b"v1", "f2": b"v2"}
    assert kv.hdel("h", "f1") and kv.hget("h", "f1") is None


@pytest.mark.parametrize("kind", ["memory", "file", "resp"])
def test_kv_backend(tmp_path, kind):
    """Each backend's surface; FileKV is durable across instances, RespKV
    speaks RESP to MiniRedisServer."""
    if kind == "memory":
        exercise_kv(MemoryKV())
    elif kind == "file":
        exercise_kv(FileKV(tmp_path / "kv"))
        assert FileKV(tmp_path / "kv").get("b:x") == b"2"
    else:
        srv = MiniRedisServer()
        try:
            kv = RespKV("127.0.0.1", srv.port)
            assert kv.ping()
            exercise_kv(kv)
            kv.close()
        finally:
            srv.close()


# ---------------------------------------------------------------- SQL

def test_sql_module_reference_api():
    db = SqlModule()
    assert db.updata("Player", "p1", ["Name", "Gold"], ["Ann", 10])
    assert db.updata("Player", "p1", ["Gold"], [99])  # upsert
    assert db.query("Player", "p1", ["Name", "Gold"]) == ["Ann", 99]
    assert db.select("Player", "p1") == {"id": "p1", "Name": "Ann", "Gold": 99}
    assert db.exists("Player", "p1") and not db.exists("Player", "p2")
    db.updata("Player", "p2", ["Name"], ["Bo"])
    assert db.keys("Player") == ["p1", "p2"]
    assert db.delete("Player", "p2") and db.keys("Player") == ["p1"]
    with pytest.raises(ValueError):
        db.updata("Player", "x", ["bad; DROP TABLE"], [1])


def test_sql_ddl_emitter():
    from noahgameframe_tpu_torch.game.schema import standard_registry

    ddl = emit_ddl(standard_registry(), ["Player"])
    assert 'CREATE TABLE IF NOT EXISTS "Player"' in ddl
    assert '"Gold" BIGINT' in ddl
    assert '"Name" TEXT' in ddl
    # non-saved columns stay out
    assert '"GameID"' not in ddl
    # the DDL actually executes
    import sqlite3

    conn = sqlite3.connect(":memory:")
    conn.executescript(ddl)


def test_sql_driver_manager_keepalive_reconnect(tmp_path):
    """Multi-server registration + keepalive/reconnect FSM (reference
    NFCMysqlDriverManager semantics: NFCMysqlModule.h:32-40)."""
    mgr = SqlDriverManager(keepalive_seconds=10.0)
    a = mgr.add_server(SqlServerConfig(server_id=1, db_name=str(tmp_path / "a.db"),
                                       reconnect_time=10.0))
    b = mgr.add_server(SqlServerConfig(server_id=2, db_name=str(tmp_path / "b.db")))
    assert a.state == DRV_CONNECTED and b.state == DRV_CONNECTED

    # routing: explicit server id hits its own database
    assert mgr.updata("Player", "k1", ["Name"], ["Ann"], server_id=1)
    assert mgr.updata("Player", "k2", ["Name"], ["Bob"], server_id=2)
    assert mgr.query("Player", "k1", ["Name"], server_id=1) == ["Ann"]
    assert mgr.query("Player", "k1", ["Name"], server_id=2) is None

    # simulate a dead connection on server 1
    a.module.close()
    mgr.execute(now=100.0)  # keepalive sweep detects the dead link
    assert a.state == DRV_DISCONNECTED
    # operations fail over to the surviving driver / explicit id refuses
    assert mgr.query("Player", "k1", ["Name"], server_id=1) is None
    assert mgr.updata("Player", "k3", ["Name"], ["Cyn"]) is True  # routed to b

    # not yet: backoff window (10 s) has not elapsed at the next sweep
    mgr.execute(now=105.0)
    assert a.state == DRV_DISCONNECTED
    # after the backoff the driver reconnects and data is durable on disk
    mgr.execute(now=111.0)
    assert a.state == DRV_CONNECTED
    assert mgr.query("Player", "k1", ["Name"], server_id=1) == ["Ann"]


def test_sql_driver_reconnect_count_bounds_retries(tmp_path):
    d = SqlDriver(SqlServerConfig(server_id=1, db_name=str(tmp_path / "c.db"),
                                  reconnect_time=5.0, reconnect_count=1))
    d.connect(0.0)
    assert d.state == DRV_CONNECTED
    d.module.close()
    assert d.keep_alive(10.0) is False  # detects death, arms backoff
    assert d.keep_alive(16.0) is True   # one allowed reconnect succeeds
    d.module.close()
    assert d.keep_alive(30.0) is False
    # budget exhausted: stays down forever
    assert d.keep_alive(300.0) is False
    assert d.state == DRV_DISCONNECTED


def test_sql_driver_manager_close_is_terminal_and_faults_dont_leak(tmp_path):
    mgr = SqlDriverManager(keepalive_seconds=10.0)
    a = mgr.add_server(SqlServerConfig(server_id=1, db_name=str(tmp_path / "t.db")))
    assert mgr.updata("T", "k", ["f"], ["v"])
    # a connection that dies between keepalive sweeps returns the failure
    # value instead of raising, and flips the driver down
    a.module.close()
    assert mgr.query("T", "k", ["f"], server_id=1) is None
    assert a.state != DRV_CONNECTED
    # close() is terminal: a later sweep must NOT reopen the database
    mgr.execute(now=50.0)  # allowed: reconnects (budget -1)
    assert a.state == DRV_CONNECTED
    mgr.close()
    mgr.execute(now=500.0)
    assert a.state != DRV_CONNECTED
    assert mgr.query("T", "k", ["f"]) is None


def test_sql_data_error_does_not_kill_driver(tmp_path):
    """A bad bind value on a healthy connection returns the failure value
    but leaves the driver CONNECTED (no false-positive reconnect that
    would re-point :memory: databases at fresh empty ones)."""
    mgr = SqlDriverManager()
    a = mgr.add_server(SqlServerConfig(server_id=1))  # :memory:
    assert mgr.updata("T", "k", ["f"], ["v"])
    assert mgr.updata("T", "k2", ["f"], [object()]) is False  # unbindable
    assert a.state == DRV_CONNECTED
    # previously-written data survives (no silent fresh database)
    assert mgr.query("T", "k", ["f"]) == ["v"]


# ---------------------------------------------------------------- MySQL
# (the reference's tests/test_mysql.py, on the port's copy)

@pytest.fixture()
def server():
    srv = MiniMysql(user="game", password="s3cret")
    yield srv
    srv.close()


def connect(srv, **kw):
    args = dict(user="game", password="s3cret")
    args.update(kw)
    return MysqlClient(srv.host, srv.port, **args)


# -- primitives --------------------------------------------------------------


def test_scramble_native_shape():
    salt = bytes(range(20))
    s = scramble_native("pw", salt)
    assert len(s) == 20
    assert s == scramble_native("pw", salt)  # deterministic
    assert s != scramble_native("pw2", salt)
    assert scramble_native("", salt) == b""
    # spot-check the formula independently
    h1 = hashlib.sha1(b"pw").digest()
    h3 = hashlib.sha1(salt + hashlib.sha1(h1).digest()).digest()
    assert s == bytes(a ^ b for a, b in zip(h1, h3))


def test_dialect_shim():
    assert _mysql_to_sqlite("SHOW COLUMNS FROM `t`") == 'PRAGMA table_info("t")'
    up = ("INSERT INTO `t` (`id`, `a`) VALUES ('k', 'v') "
          "ON DUPLICATE KEY UPDATE `a`=VALUES(`a`)")
    assert _mysql_to_sqlite(up) == (
        'INSERT INTO "t" ("id", "a") VALUES (\'k\', \'v\') '
        'ON CONFLICT("id") DO UPDATE SET "a"=excluded."a"'
    )
    # backslash escapes inside literals become doubled-quote escapes;
    # backticks outside literals become double quotes
    assert _mysql_to_sqlite(r"SELECT 'o\'brien\\x' FROM `t`") == (
        "SELECT 'o''brien\\x' FROM \"t\""
    )


# -- wire-level client/server ------------------------------------------------


def test_handshake_and_ping(server):
    cli = connect(server)
    assert cli.server_version.startswith("5.7")
    assert cli.ping()
    cli.close()


def test_wrong_password_rejected(server):
    with pytest.raises(MysqlError) as ei:
        connect(server, password="nope")
    assert ei.value.code == 1045


def test_wrong_user_rejected(server):
    with pytest.raises(MysqlError):
        connect(server, user="intruder")


def test_query_roundtrip_with_hostile_values(server):
    cli = connect(server)
    cli.query("CREATE TABLE t (id TEXT PRIMARY KEY, v TEXT)")
    hostile = "o'brien \\ \"x\"\nline2"
    lit = hostile.replace("\\", "\\\\").replace("'", "\\'").replace("\n", "\\n")
    cli.query(f"INSERT INTO t VALUES ('k1', '{lit}')")
    names, rows = cli.query("SELECT v FROM t WHERE id = 'k1'")
    assert names == ["v"]
    assert rows == [[hostile]]
    cli.close()


def test_error_packet_raises(server):
    cli = connect(server)
    with pytest.raises(MysqlError) as ei:
        cli.query("SELECT * FROM missing_table")
    assert ei.value.code == 1064
    # connection still usable after an ERR
    assert cli.ping()
    cli.close()


def test_null_values_in_resultset(server):
    cli = connect(server)
    cli.query("CREATE TABLE n (id TEXT PRIMARY KEY, a TEXT, b TEXT)")
    cli.query("INSERT INTO n (id, a) VALUES ('k', 'x')")
    _, rows = cli.query("SELECT a, b FROM n WHERE id='k'")
    assert rows == [["x", None]]
    cli.close()


# -- reference table API over the wire --------------------------------------


def test_module_surface(server):
    m = MysqlModule(server.host, server.port, "game", "s3cret")
    assert m.updata("player", "ann", ["Name", "Gold"], ["Ann O'Hara", 5])
    assert m.updata("player", "bob", ["Name"], ["Bob"])
    # text protocol: everything comes back as strings
    assert m.query("player", "ann", ["Gold", "Name"]) == ["5", "Ann O'Hara"]
    assert m.select("player", "ann") == {"Name": "Ann O'Hara", "Gold": "5"}
    assert m.exists("player", "ann") and not m.exists("player", "zed")
    assert m.keys("player") == ["ann", "bob"]
    assert m.keys("player", "a%") == ["ann"]
    # partial-field upsert must PRESERVE untouched columns (real MySQL
    # ON DUPLICATE KEY semantics — a REPLACE-based shim would null Name)
    assert m.updata("player", "ann", ["Gold"], [9])
    assert m.query("player", "ann", ["Gold"]) == ["9"]
    assert m.query("player", "ann", ["Name"]) == ["Ann O'Hara"]
    assert m.delete("player", "ann")
    assert not m.exists("player", "ann")
    assert m.ping()
    m.close()


def test_data_survives_reconnect(server):
    m1 = MysqlModule(server.host, server.port, "game", "s3cret")
    m1.updata("acct", "k", ["F"], ["v"])
    m1.close()
    m2 = MysqlModule(server.host, server.port, "game", "s3cret")
    assert m2.query("acct", "k", ["F"]) == ["v"]
    m2.close()


# -- SqlDriver engine selection + keepalive ---------------------------------


def test_driver_selects_mysql_engine(server):
    cfg = SqlServerConfig(
        server_id=1, db_name="game_db", ip=server.host, port=server.port,
        user="game", password="s3cret",
    )
    drv = SqlDriver(cfg)
    assert drv.connect()
    assert isinstance(drv.module, MysqlModule)
    assert drv.keep_alive(now=0.0)
    drv.module.updata("t", "k", ["f"], ["v"])
    assert drv.module.query("t", "k", ["f"]) == ["v"]
    drv._drop_module()


def test_driver_detects_dead_server_and_reconnects():
    srv = MiniMysql(user="game", password="pw")
    cfg = SqlServerConfig(
        server_id=1, db_name="", ip=srv.host, port=srv.port,
        user="game", password="pw", reconnect_time=0.0,
    )
    drv = SqlDriver(cfg)
    assert drv.connect()
    srv.close()
    assert not drv.keep_alive(now=1.0)  # ping fails -> DISCONNECTED
    # server returns on the same port
    srv2 = MiniMysql(user="game", password="pw", port=srv.port)
    try:
        assert drv.keep_alive(now=2.0)  # reconnects
        assert drv.module.ping()
    finally:
        drv._drop_module()
        srv2.close()


def test_driver_manager_routes_to_mysql(server):
    mgr = SqlDriverManager()
    mgr.add_server(SqlServerConfig(
        server_id=7, db_name="", ip=server.host, port=server.port,
        user="game", password="s3cret",
    ))
    assert mgr.updata("guild", "g1", ["Name"], ["Alliance"])
    assert mgr.select("guild", "g1") == {"Name": "Alliance"}
    mgr.close()


def test_upsert_marker_inside_value_literal(server):
    """A data value containing ' ON DUPLICATE KEY UPDATE ' must not split
    the rewritten statement (the clause finder skips string literals)."""
    m = MysqlModule(server.host, server.port, "game", "s3cret")
    evil = "x ON DUPLICATE KEY UPDATE y"
    assert m.updata("t", "k", ["f"], [evil])
    assert m.query("t", "k", ["f"]) == [evil]
    m.close()


def test_auth_switch_request_rescrambles():
    """MySQL-8 style AuthSwitchRequest (0xFE): the client re-scrambles
    against the fresh salt and the session proceeds normally."""
    srv = MiniMysql(user="game", password="s3cret", auth_switch=True)
    try:
        c = MysqlClient(srv.host, srv.port, "game", "s3cret")
        names, rows = c.query("SELECT 1 AS one")
        assert rows == [["1"]]
        c.close()
    finally:
        srv.close()


def test_auth_switch_to_unknown_plugin_names_it():
    """A switch to an unimplemented plugin fails with the plugin's name
    in the error, not an opaque 'unexpected auth reply'."""
    lsock = _socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]

    def serve():
        conn, _ = lsock.accept()
        io = _PacketIO(conn)
        salt = b"0123456789abcdefghij"
        g = bytes([10]) + b"8.0.0-fake\x00" + _struct.pack("<I", 1)
        g += salt[:8] + b"\x00" + _struct.pack("<H", _CAPS & 0xFFFF)
        g += bytes([33]) + _struct.pack("<H", 2)
        g += _struct.pack("<H", (_CAPS >> 16) & 0xFFFF)
        g += bytes([21]) + b"\x00" * 10 + salt[8:] + b"\x00"
        g += b"mysql_native_password\x00"
        io.write(g)
        io.read()  # client response
        io.write(b"\xfecaching_sha2_password\x00freshsalt\x00")
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    with pytest.raises(MysqlError, match="caching_sha2_password"):
        MysqlClient("127.0.0.1", port, "game", "s3cret")
    t.join(timeout=5)
    lsock.close()


# ---------------------------------------------------------------- write-behind
# (the reference's tests/test_writebehind.py cases, on the port's copy)


def _wait(cond, timeout=5.0, step=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


class FlakyStore(StoreBackend):
    """In-memory backend with a switchable failure mode."""

    def __init__(self):
        self.data = {}
        self.fail = False
        self.ops = 0

    def write(self, key, blob):
        self.ops += 1
        if self.fail:
            raise IOError("store down")
        self.data[key] = blob

    def delete(self, key):
        self.ops += 1
        if self.fail:
            raise IOError("store down")
        self.data.pop(key, None)


def _pipeline(store, wal_dir, **kw):
    kw.setdefault("retry", RetryPolicy(base=0.002, cap=0.01, seed=3))
    kw.setdefault("name", "t")
    return WriteBehindPipeline(store, wal_dir, **kw)


class TestBatchCodec:
    def test_round_trip_puts_and_tombstones(self):
        b = Batch(5, 42, {"obj:a:A": b"\x00blob", "obj:b:B": None, "": b""})
        out = decode_batch(encode_batch(b))
        assert (out.seq, out.tick) == (5, 42)
        assert out.entries == b.entries

    def test_trailing_bytes_fail_closed(self):
        body = encode_batch(Batch(1, 1, {"k": b"v"})) + b"\x00"
        with pytest.raises(WALError):
            decode_batch(body)

    def test_truncated_entry_fails_closed(self):
        body = encode_batch(Batch(1, 1, {"k": b"value"}))
        with pytest.raises(WALError):
            decode_batch(body[:-3])

    def test_merge_older_newest_wins(self):
        new = Batch(3, 30, {"a": b"new", "c": None})
        new.merge_older(Batch(2, 20, {"a": b"old", "b": b"keep"}))
        assert new.entries == {"a": b"new", "b": b"keep", "c": None}


# ----------------------------------------------------------- staging WAL
class TestStagingWAL:
    def test_recovery_returns_unmarked_suffix(self, tmp_path):
        w = StagingWAL(tmp_path / "w")
        for seq in (1, 2, 3):
            w.append_batch(Batch(seq, seq * 10, {f"k{seq}": b"v"}))
        w.mark(1, 10)
        w.close()
        r = StagingWAL(tmp_path / "w")
        assert [b.seq for b in r.pending] == [2, 3]
        assert (r.flushed_seq, r.flushed_tick) == (1, 10)
        r.close()

    def test_rotation_and_numbering_resume(self, tmp_path):
        w = StagingWAL(tmp_path / "w", segment_bytes=4096)
        for seq in range(1, 40):
            w.append_batch(Batch(seq, seq, {f"k{seq}": bytes(200)}))
        w.close()
        segs = sorted((tmp_path / "w").glob("wal-*.nfw"))
        assert len(segs) >= 2, "rotation never happened"
        r = StagingWAL(tmp_path / "w", segment_bytes=4096)
        assert [b.seq for b in r.pending] == list(range(1, 40))
        # the resumed writer opens a NEW segment, never clobbers one
        assert len(sorted((tmp_path / "w").glob("wal-*.nfw"))) == len(segs) + 1
        r.close()

    def test_prune_drops_fully_flushed_segments(self, tmp_path):
        w = StagingWAL(tmp_path / "w", segment_bytes=4096)
        for seq in range(1, 40):
            w.append_batch(Batch(seq, seq, {f"k{seq}": bytes(200)}))
        n_before = len(list((tmp_path / "w").glob("wal-*.nfw")))
        assert n_before >= 2
        w.mark(39, 39)
        assert w.prune() > 0
        assert len(list((tmp_path / "w").glob("wal-*.nfw"))) < n_before
        w.close()
        # pruning must not break recovery
        r = StagingWAL(tmp_path / "w")
        assert r.pending == []
        r.close()

    @staticmethod
    def _write_then_close(tmp_path, n=4):
        w = StagingWAL(tmp_path / "w")
        for seq in range(1, n + 1):
            w.append_batch(Batch(seq, seq, {f"k{seq}": bytes(range(64))}))
        w.close()
        return sorted((tmp_path / "w").glob("wal-*.nfw"))[-1]

    def test_torn_tail_of_newest_segment_is_truncated(self, tmp_path):
        seg = self._write_then_close(tmp_path)
        clean = seg.read_bytes()
        # a torn frame: full header promising more body than exists
        seg.write_bytes(clean + HEADER.pack(WB_BATCH, 500, 0) + b"par")
        r = StagingWAL(tmp_path / "w")
        assert r.torn_tail_dropped == 1
        assert [b.seq for b in r.pending] == [1, 2, 3, 4]
        r.close()
        # ... and the truncation is IN PLACE: the tail is gone on disk
        assert seg.read_bytes() == clean

    def test_torn_header_of_newest_segment_is_truncated(self, tmp_path):
        seg = self._write_then_close(tmp_path)
        seg.write_bytes(seg.read_bytes() + b"\x00\x02\x00")
        r = StagingWAL(tmp_path / "w")
        assert r.torn_tail_dropped == 1
        assert len(r.pending) == 4
        r.close()

    def test_torn_record_in_closed_segment_fails_closed(self, tmp_path):
        w = StagingWAL(tmp_path / "w", segment_bytes=4096)
        for seq in range(1, 40):
            w.append_batch(Batch(seq, seq, {f"k{seq}": bytes(200)}))
        w.close()
        oldest = sorted((tmp_path / "w").glob("wal-*.nfw"))[0]
        oldest.write_bytes(oldest.read_bytes()[:-7])
        with pytest.raises(WALError):
            StagingWAL(tmp_path / "w", segment_bytes=4096)

    def test_bit_flip_in_body_fails_crc(self, tmp_path):
        seg = self._write_then_close(tmp_path)
        data = bytearray(seg.read_bytes())
        # flip one bit inside the first record's body
        data[len(WAL_MAGIC) + HEADER.size + 3] ^= 0x10
        seg.write_bytes(bytes(data))
        with pytest.raises(WALError):
            StagingWAL(tmp_path / "w")

    def test_unknown_record_type_fails_closed(self, tmp_path):
        seg = self._write_then_close(tmp_path)
        seg.write_bytes(seg.read_bytes() + HEADER.pack(99, 0, zlib.crc32(b"")))
        with pytest.raises(WALError):
            StagingWAL(tmp_path / "w")

    def test_oversize_length_is_corruption_not_allocation(self, tmp_path):
        seg = self._write_then_close(tmp_path)
        seg.write_bytes(
            seg.read_bytes() + HEADER.pack(WB_BATCH, MAX_RECORD_SIZE + 1, 0))
        with pytest.raises(WALError):
            StagingWAL(tmp_path / "w")

    def test_bad_magic_fails_closed(self, tmp_path):
        seg = self._write_then_close(tmp_path)
        data = bytearray(seg.read_bytes())
        data[0] ^= 0xFF
        seg.write_bytes(bytes(data))
        with pytest.raises(WALError):
            StagingWAL(tmp_path / "w")

    def test_empty_directory_is_a_fresh_wal(self, tmp_path):
        w = StagingWAL(tmp_path / "fresh")
        assert w.pending == [] and w.flushed_seq == 0
        w.close()


# -------------------------------------------------------------- pipeline
class TestPipeline:
    def test_flush_watermark_and_lag(self, tmp_path):
        store = FlakyStore()
        p = _pipeline(store, tmp_path / "w")
        try:
            p.enqueue(5, {"a": b"1", "b": b"2"})
            assert _wait(lambda: store.data.get("a") == b"1"
                         and store.data.get("b") == b"2")
            assert store.data["__wb__:t"] == b"1:5"
            p.note_tick(9)
            p.pump()
            assert p.queue_depth() == 0 and p.lag_ticks() == 0
            assert not p.degraded()
            assert p.flushes_total == 1 and p.entries_total == 2
        finally:
            p.close()

    def test_empty_enqueue_is_a_noop(self, tmp_path):
        p = _pipeline(FlakyStore(), tmp_path / "w")
        try:
            assert p.enqueue(1, {}) == 0
            assert p.queue_depth() == 0
        finally:
            p.close()

    def test_retry_degraded_then_heal(self, tmp_path):
        store = FlakyStore()
        store.fail = True
        p = _pipeline(store, tmp_path / "w")
        try:
            p.enqueue(1, {"a": b"v1"})
            assert _wait(lambda: p.retries_total >= 3)
            assert p.degraded() and p.queue_depth() == 1
            store.fail = False
            assert _wait(lambda: store.data.get("a") == b"v1")
            assert _wait(lambda: not p.degraded())
            assert p.lag_ticks() == 0 or p.queue_depth() == 0
        finally:
            p.close()

    def test_tombstone_flushes_as_delete(self, tmp_path):
        store = FlakyStore()
        store.data["a"] = b"old"
        p = _pipeline(store, tmp_path / "w")
        try:
            p.enqueue(1, {"a": None})
            assert _wait(lambda: "a" not in store.data)
        finally:
            p.close()

    def test_pending_and_discard_read_your_writes(self, tmp_path):
        store = FlakyStore()
        store.fail = True  # hold everything in the queue
        p = _pipeline(store, tmp_path / "w")
        try:
            p.enqueue(1, {"a": b"v1"})
            p.enqueue(2, {"a": b"v2", "b": None})
            assert p.pending("a") == (True, b"v2")  # newest wins
            assert p.pending("b") == (True, None)  # queued tombstone
            assert p.pending("zzz") == (False, None)
            assert p.discard("a") == 2
            assert p.pending("a") == (False, None)
        finally:
            p.kill()

    def test_bounded_queue_coalesces_not_blocks(self, tmp_path):
        store = FlakyStore()
        store.fail = True
        p = _pipeline(store, tmp_path / "w", max_queue_batches=4)
        try:
            for t in range(1, 41):
                p.enqueue(t, {f"k{t % 6}": f"v{t}".encode(), "hot": b"%d" % t})
            # RAM bounded: depth never exceeds the cap + the in-flight slot
            assert p.queue_depth() <= 5
            assert p.degraded()  # overflow latch
            # coalescing kept the NEWEST value per key
            assert p.pending("hot") == (True, b"40")
            assert p.pending("k4") == (True, b"v40")
            store.fail = False
            assert _wait(lambda: p.queue_depth() == 0, timeout=10)
            assert store.data["hot"] == b"40"
            assert store.data["k3"] == b"v39"
            p.pump()  # overflow latch clears once the queue drained
            assert not p.degraded()
        finally:
            p.close()

    def test_kill_under_write_recovers_from_wal(self, tmp_path):
        store = FlakyStore()
        store.fail = True
        p = _pipeline(store, tmp_path / "w")
        p.enqueue(1, {"a": b"v1"})
        p.enqueue(2, {"a": b"v2", "b": b"x"})
        p.kill()  # no drain, no marks — the crash case
        assert store.data == {}

        healed = FlakyStore()
        p2 = _pipeline(healed, tmp_path / "w")
        try:
            assert p2.recovered_batches == 2
            assert _wait(lambda: healed.data.get("a") == b"v2"
                         and healed.data.get("b") == b"x")
            assert healed.data["__wb__:t"] == b"2:2"
        finally:
            p2.close()

    def test_reflush_after_lost_mark_is_idempotent(self, tmp_path):
        store = FlakyStore()
        p = _pipeline(store, tmp_path / "w")
        p.enqueue(1, {"a": b"v1"})
        assert _wait(lambda: store.data.get("a") == b"v1")
        # kill BEFORE pump() could persist the flush mark: the batch is
        # flushed in the store but unmarked in the WAL
        p.kill()
        p2 = _pipeline(store, tmp_path / "w")
        try:
            assert p2.recovered_batches == 1  # at-least-once delivery...
            assert _wait(lambda: store.data.get("__wb__:t") == b"1:1")
            assert store.data["a"] == b"v1"  # ...exactly-once effect
        finally:
            p2.close()

    def test_barrier_syncs_and_drain_reports(self, tmp_path):
        store = FlakyStore()
        p = _pipeline(store, tmp_path / "w")
        try:
            p.enqueue(3, {"a": b"v"})
            p.barrier(3)
            assert p.drain(timeout=5.0)
            assert store.data.get("a") == b"v"
        finally:
            p.close()

    def test_store_calls_never_on_caller_thread(self, tmp_path):
        store = FlakyStore()
        p = _pipeline(store, tmp_path / "w")
        try:
            p.enqueue(1, {"a": b"v"})
            assert _wait(lambda: p.flushes_total >= 1)
            assert p.store_threads
            assert threading.get_ident() not in p.store_threads
        finally:
            p.close()

    def test_seq_and_watermark_have_no_wall_clock(self, tmp_path):
        """Batch identity is (seq, tick) — rebuilding the same enqueue
        sequence yields byte-identical WAL batch frames, which is what
        makes recovery flushes reproducible."""
        frames = []
        for d in ("w1", "w2"):
            store = FlakyStore()
            store.fail = True
            p = _pipeline(store, tmp_path / d)
            p.enqueue(7, {"a": b"x"})
            p.enqueue(8, {"b": b"y"})
            p.kill()
            seg = sorted((tmp_path / d).glob("wal-*.nfw"))[0]
            frames.append(seg.read_bytes())
        assert frames[0] == frames[1]


# -------------------------------------------------- agent routing
class _Held(StoreBackend):
    def __init__(self, kv):
        self.inner = KVBackend(kv)
        self.fail = False

    def write(self, key, blob):
        if self.fail:
            raise IOError("store down")
        self.inner.write(key, blob)

    def delete(self, key):
        if self.fail:
            raise IOError("store down")
        self.inner.delete(key)


def _player_world():
    return GameWorld(WorldConfig(
        npc_capacity=8, player_capacity=4, seed=3,
        combat=False, movement=False, regen=False,
    ), device="cpu").start()


class TestAgentRouting:
    @pytest.fixture()
    def rig(self, tmp_path):
        w = _player_world()
        kv = MemoryKV()
        agent = PlayerDataAgent(kv).bind(w.kernel)
        store = _Held(kv)
        store.fail = True  # outage from the start
        agent.pipeline = _pipeline(store, tmp_path / "w")
        guid = w.kernel.create_object(
            "Player", {"Name": "Hero", "Account": "acct", "Gold": 7},
            guid=Guid(9, 500),
        )
        yield w, kv, agent, store, guid
        agent.pipeline.close()

    def test_save_during_outage_is_queued_not_lost(self, rig):
        w, kv, agent, store, guid = rig
        assert agent.save(guid)
        key = agent._key_of(guid)
        assert kv.get(key) is None  # store never reached
        found, blob = agent.pipeline.pending(key)
        assert found and blob
        # destroy-then-heal: the queued blob survives to the store
        store.fail = False
        assert _wait(lambda: kv.get(key) is not None)

    def test_load_prefers_queued_blob_over_stale_store(self, rig):
        w, kv, agent, store, guid = rig
        k = w.kernel
        key = agent._key_of(guid)
        kv.set(key, b"")  # stale garbage the load must NOT fall back to
        k.set_property(guid, "Gold", 1234)
        agent.save(guid)
        k.set_property(guid, "Gold", 0)
        assert agent.load(guid)
        assert int(k.get_property(guid, "Gold")) == 1234

    def test_delete_tombstone_beats_queued_save(self, rig):
        w, kv, agent, store, guid = rig
        agent.save(guid)
        assert agent.delete("acct:Hero")
        key = agent._key_of(guid)
        assert agent.pipeline.pending(key) == (True, None)
        assert not agent.exists("acct:Hero")
        assert not agent.load(guid)  # a queued tombstone means "no blob"
        store.fail = False
        assert _wait(lambda: agent.pipeline.queue_depth() == 0)
        assert kv.get(key) is None  # no resurrection after the flush
