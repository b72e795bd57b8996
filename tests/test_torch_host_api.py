"""The port's host object API against the JAX package on the CPU: a seeded
random sequence of create_object / set_property / record operations /
destroy_object (now or deferred) / timers / skills / scene and group moves
/ add_exp / stat operations / forced diff columns / tick, applied to both
packages' worlds, gives equal state trees, equal guids, equal read-backs
and equal subscriber calls (property, record, class and scene hooks)
after every step.  Plus the store-level API (decode,
identity lookups, the host mirrors, record queries, with_column) on a
custom schema."""

import numpy as np
import pytest
import torch

from noahgameframe_tpu.core.datatypes import Guid as JGuid
from noahgameframe_tpu.core.schema import ClassDef as JClassDef
from noahgameframe_tpu.core.schema import ClassRegistry as JRegistry
from noahgameframe_tpu.core.schema import prop as jprop
from noahgameframe_tpu.core.schema import record as jrecord
from noahgameframe_tpu.core.store import EntityStore as JStore
from noahgameframe_tpu.core.store import StoreConfig as JStoreConfig
from noahgameframe_tpu.game.defines import PropertyGroup as JPropertyGroup
from noahgameframe_tpu.game.world import GameWorld as JWorld
from noahgameframe_tpu.game.world import WorldConfig as JConfig
from noahgameframe_tpu.kernel.scene import SeedSpec as JSeedSpec
from noahgameframe_tpu_torch.core.datatypes import Guid
from noahgameframe_tpu_torch.core.schema import ClassDef, ClassRegistry, prop, record
from noahgameframe_tpu_torch.core.store import EntityStore, RecordOp, StoreConfig, state_to_numpy
from noahgameframe_tpu_torch.game.defines import PropertyGroup
from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig
from noahgameframe_tpu_torch.kernel.scene import SeedSpec
from test_torch_parity import assert_tree_equal, jax_tree

EXTENT = 48.0


def _worlds(seed):
    """The same small combat world in both packages, guids pinned: scene 1
    with the seeded NPCs, scene 2 with a grunt seed, clone scene 7, a
    skill element and a linear (job 0) level table."""
    a = JWorld(JConfig(npc_capacity=64, player_capacity=48, extent=EXTENT, seed=seed,
                       middleware=False)).start()
    b = GameWorld(WorldConfig(npc_capacity=64, player_capacity=48, extent=EXTENT,
                              seed=seed, middleware=False), device="cpu").start()
    for w in (a, b):
        k = w.kernel
        k.store.guids.pin(7000)
        k.elements.add_element("NPC", "grunt", {"HP": 33, "MAXHP": 40, "SeedID": "gr"})
        k.elements.add_element("Skill", "fireball", {"DamageValue": 10})
        k.elements.add_element("Scene", "7", {"SceneType": 1})
        seed_cls = JSeedSpec if w is a else SeedSpec
        w.scene.create_scene(1, width=EXTENT)
        w.scene.create_scene(2, seeds=[seed_cls("grunt", "NPC", (5.0, 6.0, 0.0))])
        w.scene.create_scene(7, seeds=[seed_cls("grunt", "NPC", (9.0, 9.0, 0.0))])
        w.property_config.fill_linear(0, {"MAXHP": 100, "MAXMP": 20, "MAXSP": 10, "ATK_VALUE": 5},
                                      {"MAXHP": 10, "MAXMP": 2, "MAXSP": 1, "ATK_VALUE": 1},
                                      max_exp_base=40, max_exp_per_level=15)
        w.property_config.freeze()
        w.seed_npcs(24)
        k.enable_digest()
    return a, b


def _conv(x, jax_side: bool):
    """Guids of one package as the other's (each package has its own Guid
    type), through dicts, tuples and lists."""
    if isinstance(x, (Guid, JGuid)):
        return (JGuid if jax_side else Guid)(x.head, x.data)
    if isinstance(x, dict):
        return {k: _conv(v, jax_side) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_conv(v, jax_side) for v in x)
    return x


def _log_events(w, log):
    k = w.kernel
    k.register_class_event(lambda g, c, ev: log.append(("class", str(g), c, int(ev))))
    k.register_class_event(lambda g, c, ev: log.append(("player", str(g), int(ev))), "Player")
    for cname, pname in (("Player", "Gold"), ("Player", "Position"), ("NPC", "HP")):
        k.register_property_event(
            cname, pname, lambda c, p, rows: log.append(("prop", c, p, [int(r) for r in rows])))
    k.subscribe_record_host(
        lambda c, r, op, rows, rr, tags: log.append(
            ("rec", c, r, int(op), [int(x) for x in rows], rr, tags)))
    sc = w.scene
    for name in ("before_enter_scene", "after_enter_scene", "before_leave_scene",
                 "after_leave_scene", "on_swap_group"):
        getattr(sc, name).append(
            lambda g, s, gr, name=name: log.append(("hook", name, str(g), s, gr)))
    sc.on_group_created.append(lambda s, gr: log.append(("group", s, gr)))


# property name -> value maker, per class (int, float, string, object, vec2, vec3)
def _value(rng, kind, live):
    if kind == "int":
        return int(rng.integers(-50, 500))
    if kind == "float":
        return float(np.float32(rng.uniform(-10, 10)))
    if kind == "string":
        return f"s{int(rng.integers(0, 6))}"
    if kind == "object":
        return live[int(rng.integers(0, len(live)))] if rng.random() < 0.8 else Guid()
    if kind == "vec2":
        return (float(rng.uniform(0, EXTENT)), float(rng.uniform(0, EXTENT)))
    return (float(rng.uniform(0, EXTENT)), float(rng.uniform(0, EXTENT)), 0.0)


PROPS = {
    "Player": [("Gold", "int"), ("Name", "string"), ("Position", "vec3"),
               ("GuildID", "object"), ("MoveTo", "vec2"), ("Level", "int")],
    "NPC": [("HP", "int"), ("AtkDis", "float"), ("TargetPos", "vec2"),
            ("MasterID", "object"), ("EffectData", "string"), ("Position", "vec3")],
    "Guild": [("Name", "string"), ("LeaderID", "object"), ("GuildLevel", "int")],
}
EQUIP = "BagEquipList"


def _live(store, cname=None):
    out = []
    for g, h in store.guid_map.items():
        if cname is None or store.class_order[h >> 24] == cname:
            out.append(g)
    return sorted(out, key=lambda g: (g.head, g.data))


KINDS = ("create", "set", "record", "destroy", "tick", "timer", "skill", "scene",
         "exp", "stat", "force")
STAT_OPS = ("add_hp", "consume_hp", "enough_hp", "add_mp", "consume_mp", "enough_mp",
            "add_sp", "consume_sp", "enough_sp", "add_money", "consume_money",
            "enough_money", "add_diamond", "consume_diamond", "enough_diamond",
            "full_hp_mp", "full_sp", "add_group_value", "recompute_now")
FORCED = (("NPC", "LastAttacker"), ("NPC", "DeadTick"))
HOST_KINDS = ("timer", "skill", "scene", "exp", "stat", "force")
HOST_WEIGHTS = (0.15, 0.175, 0.25, 0.125, 0.25, 0.05)
# the window of _plan's draw r that each store operation takes; "create"
# splits into Player, NPC and Guild creates
WINDOWS = {"create": (0.0, 0.22), "create NPC": (0.12, 0.18), "create Guild": (0.18, 0.22),
           "set": (0.22, 0.45), "record": (0.45, 0.72), "destroy": (0.72, 0.84),
           "tick": (0.84, 1.0)}


def _plan_host(rng, kind, players, live):
    """One operation of the scene and host layer of ``kind``."""
    if kind == "force":
        return ("force", *FORCED[int(rng.integers(0, len(FORCED)))])
    p = players[int(rng.integers(0, len(players)))]
    if kind == "timer":
        g = live[int(rng.integers(0, len(live)))]
        return ("timer", g, int(rng.integers(0, 3)), float(rng.choice([0.1, 0.5, 1.0])),
                int(rng.choice([-1, 1, 3])), float(rng.choice([0.1, 0.3])))
    if kind == "skill":
        return ("skill", p, "fireball" if rng.random() < 0.85 else "nope",
                live[int(rng.integers(0, len(live)))])
    if kind == "scene":
        # sub: 0 enter, 1 request a group, 2 release one, 3 scene-process
        # enter, 4 broadcast read; enters weigh most
        return ("scene", p, int(rng.choice([0, 0, 0, 3, 3, 1, 2, 4])), int(rng.choice([1, 2, 7])),
                int(rng.integers(0, 8)))
    if kind == "exp":
        return ("exp", p, int(rng.choice([5, 30, 70, 200])))
    return ("stat", p, STAT_OPS[int(rng.integers(0, len(STAT_OPS)))],
            int(rng.integers(-3, 60)))


def _plan(rng, store, kind=None):
    """One random host operation, as data both packages can apply.

    Four draws in ten go to the scene and host layer's kinds; the rest
    draw ``r`` for the store operations in their own windows (``WINDOWS``).
    ``kind`` picks the kind, or for a store operation the window."""
    players = _live(store, "Player")
    live = _live(store)
    if kind is None and players and rng.random() < 0.4:
        kind = HOST_KINDS[int(rng.choice(len(HOST_KINDS), p=HOST_WEIGHTS))]
    if kind == "force" or (kind in HOST_KINDS and players):
        return _plan_host(rng, kind, players, live)
    lo, hi = WINDOWS.get(kind, (0.0, 1.0))
    r = lo + (hi - lo) * rng.random()
    if r < 0.12 or not players:
        n = int(rng.integers(0, 1000))
        return ("create", "Player", {
            "Name": f"p{n}", "Account": f"a{n}", "Gold": int(rng.integers(0, 99)),
            "Position": _value(rng, "vec3", live), "GuildID": _value(rng, "object", live)})
    if r < 0.18:
        return ("create", "NPC", {"HP": 70, "Position": _value(rng, "vec3", live),
                                  "TargetPos": _value(rng, "vec2", live)})
    if r < 0.22:
        return ("create", "Guild", {"Name": "g", "LeaderID": players[0], "GuildLevel": 2})
    if r < 0.45:
        g = live[int(rng.integers(0, len(live)))]
        cname = store.row_of(g)[0]
        if cname not in PROPS:
            return ("tick",)
        name, kind = PROPS[cname][int(rng.integers(0, len(PROPS[cname])))]
        return ("set", g, name, _value(rng, kind, live))
    if r < 0.72:
        p = players[int(rng.integers(0, len(players)))]
        return ("record", p, int(rng.integers(0, 6)), _value(rng, "object", live),
                int(rng.integers(0, 32)), int(rng.integers(0, 32)), int(rng.integers(0, 9)))
    if r < 0.84:
        g = live[int(rng.integers(0, len(live)))]
        if store.row_of(g)[0] == "Scene":
            return ("tick",)
        return ("destroy", g, bool(rng.random() < 0.5))
    return ("tick",)


def _apply(w, op):
    """Apply one planned operation; returns what it read back."""
    k, st = w.kernel, w.kernel.store
    op = _conv(op, isinstance(w, JWorld))
    kind = op[0]
    if kind == "create":
        return str(k.create_object(op[1], op[2], scene=1))
    if kind == "set":
        k.set_property(op[1], op[2], op[3])
        return k.get_property(op[1], op[2])
    if kind == "destroy":
        k.destroy_object(op[1], deferred=op[2])
        return None
    if kind == "tick":
        w.tick()
        return w.kernel.last_counters
    if kind in ("timer", "skill", "scene", "exp", "stat", "force"):
        return _apply_host(w, op)
    _, p, sub, target, r1, r2, val = op
    used = st.record_used_rows(k.state, p, EQUIP)
    if sub == 0 or not used:
        if len(used) == st.spec("Player").records[EQUIP].max_rows:
            return "full"
        k.state, r = st.record_add_row(k.state, p, EQUIP, {
            "GUID": target, "WearGUID": p, "ConfigID": f"eq{val}", "SlotCount": val})
        return r
    row = used[r1 % len(used)]
    if sub == 1:
        k.state = st.record_set(k.state, p, EQUIP, row, "SlotCount", val)
    elif sub == 2:
        k.state = st.record_set(k.state, p, EQUIP, row, "GUID", target)
    elif sub == 3:
        k.state = st.record_remove_row(k.state, p, EQUIP, row)
    elif sub == 4:
        k.state = st.record_swap_rows(k.state, p, EQUIP, row, r2)
    else:
        k.state = st.record_restore_row(k.state, p, EQUIP, r2,
                                        {"ConfigID": "restored", "WearGUID": target})
    cells = {tag: st.record_get(k.state, p, EQUIP, row, tag)
             for tag in ("GUID", "WearGUID", "ConfigID", "SlotCount")}
    return (cells, st.record_used_rows(k.state, p, EQUIP),
            st.record_find_rows(k.state, p, EQUIP, "SlotCount", val),
            st.record_find_rows(k.state, p, EQUIP, "ConfigID", f"eq{val}"))


def _apply_host(w, op):
    """Apply one operation of the scene and host layer; returns its
    read-backs (guids as strings)."""
    k, kind = w.kernel, op[0]
    jax_side = isinstance(w, JWorld)
    if kind == "timer":
        _, g, sub, interval, count, delay = op
        cname = k.store.row_of(g)[0]
        names = k.schedule.timer_names(cname)
        if not names:
            return "no timers"
        timer = names[sub % len(names)]
        if sub == 0 and "Regen" in names:
            w.regen.arm(g)
        elif sub == 1:
            k.state = k.schedule.set_timer(k.state, k.store, g, timer, interval, count, delay)
        else:
            k.state = k.schedule.cancel_timer(k.state, k.store, g, timer)
        return names
    if kind == "skill":
        _, p, skill, target = op
        ok = w.skills.use_skill(p, skill, target)
        alive = target in k.store.guid_map
        return (ok, alive and k.get_property(target, "HP"),
                alive and k.store.spec(k.store.row_of(target)[0]).has_property("LastAttacker")
                and str(k.get_property(target, "LastAttacker")))
    if kind == "scene":
        _, p, sub, scene_id, pick = op
        sc = w.scene
        if sub == 0:
            groups = sorted(sc.scenes[scene_id].groups)
            group = groups[pick % len(groups)]
            sc.enter_scene(p, scene_id, group)
        elif sub == 1:
            group = sc.request_group(2)
        elif sub == 2:
            groups = sorted(g for g in sc.scenes[2].groups if g)
            group = sc.release_group(2, groups[pick % len(groups)]) if groups else -1
        elif sub == 3:
            group = w.scene_process.enter(p, scene_id, pick % 3)
        else:
            group = sc.broadcast_targets(p, public=bool(pick % 2))
        s, g = int(k.get_property(p, "SceneID")), int(k.get_property(p, "GroupID"))
        return (str(group) if isinstance(group, list) else group, s, g,
                [str(x) for x in sc.objects_in_group(s, g, "Player")],
                [str(x) for x in sc.objects_in_scene(s, "NPC")],
                [str(x) for x in sc.broadcast_targets(p, public=True)],
                {sid: (sorted(info.groups), list(info.free_groups))
                 for sid, info in sc.scenes.items()})
    if kind == "exp":
        _, p, amount = op
        level = w.level.add_exp(p, amount)
        return (level, *(k.get_property(p, n) for n in ("EXP", "MAXEXP", "HP", "MAXHP", "SP")))
    if kind == "stat":
        _, p, name, v = op
        props = w.properties
        if name in ("full_hp_mp", "full_sp", "recompute_now"):
            out = getattr(props, name)(p)
        elif name == "add_group_value":
            group = (JPropertyGroup if jax_side else PropertyGroup).EFFECTVALUE
            out = props.add_group_value(p, "MAXHP", group, v)
            out = (out, props.get_group_value(p, "MAXHP", group))
        else:
            out = getattr(props, name)(p, v)
        return (out, *(k.get_property(p, n) for n in ("HP", "MP", "SP", "Gold", "Money")))
    _, cname, prop_name = op
    first = prop_name not in k._forced_diff.get(cname, ())
    gen = k.costbook.generation
    k.force_diff_property(cname, prop_name)
    if first:
        log = w._walk_log
        k.register_property_event(
            cname, prop_name, lambda c, pn, rows: log.append(("forced", c, pn, rows.tolist())))
    return k.costbook.generation - gen


def _props_of(w, g):
    st = w.kernel.store
    cname, _ = st.row_of(g)
    return {name: w.kernel.get_property(g, name) for name in st.spec(cname).slots}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_host_ops_match_jax(seed):
    """80 random host operations (creates with the seven-event chain,
    typed writes of every value type, record add/set/remove/swap/restore,
    immediate and deferred destroys, timers armed and cancelled, skills,
    scene enters, group requests and releases, clone-scene enters through
    the scene process, add_exp across level-ups, the stat API, forced diff
    columns, ticks with combat) give equal trees, guids, read-backs,
    property values and subscriber calls."""
    a, b = _worlds(seed)
    la, lb = [], []
    _log_events(a, la)
    _log_events(b, lb)
    a._walk_log, b._walk_log = la, lb
    rng = np.random.default_rng(100 + seed)
    # a player, every kind once in a seeded order, then kinds at random
    first = ["create"] + [str(x) for x in rng.permutation(KINDS + ("create NPC",
                                                                   "create Guild"))]
    kinds, created = set(), set()
    for step in range(80):
        op = _plan(rng, b.kernel.store, first[step] if step < len(first) else None)
        kinds.add(op[0])
        if op[0] == "create":
            created.add(op[1])
        got_a, got_b = _conv(_apply(a, op), False), _apply(b, op)
        assert got_a == got_b, (step, op)
        assert la == lb, (step, op)
        assert_tree_equal(jax_tree(a.kernel.state), state_to_numpy(b.kernel.state),
                          f"step{step}")
        ga, gb = a.kernel.store.guid_map, b.kernel.store.guid_map
        assert {str(g): h for g, h in ga.items()} == {str(g): h for g, h in gb.items()}
        for cname in ("NPC", "Player"):
            ha, hb = a.kernel.store._hosts[cname], b.kernel.store._hosts[cname]
            assert ha.free == hb.free and ha.live_count == hb.live_count
            for m in ("alloc_mask", "guid_head", "guid_data", "row_gen"):
                assert np.array_equal(getattr(ha, m), getattr(hb, m)), (step, m)
        players = _live(b.kernel.store, "Player")
        if players:
            g = players[step % len(players)]
            assert _conv(_props_of(a, JGuid(g.head, g.data)), False) == _props_of(b, g), step
    assert kinds == set(KINDS)
    assert created == {"Player", "NPC", "Guild"}, created
    seen = {e[0] for e in lb}
    assert {"prop", "rec", "hook", "class"} <= seen, seen


def _registry(cd, pr, rc):
    reg = (JRegistry if cd is JClassDef else ClassRegistry)()
    reg.define(cd("Thing", properties=[pr("X", "int", save=True), pr("F", "float"),
                                       pr("S", "string"), pr("O", "object"),
                                       pr("V", "vector3")],
                  records=[rc("Refs", 4, [("Who", "object"), ("At", "vector3"),
                                          ("N", "int"), ("Tag", "string")], save=True)]))
    return reg


def _stores():
    a = JStore(_registry(JClassDef, jprop, jrecord), JStoreConfig(default_capacity=8))
    b = EntityStore(_registry(ClassDef, prop, record), StoreConfig(default_capacity=8),
                    device="cpu")
    for s in (a, b):
        s.guids.pin(10)
    return a, b


def test_store_api_matches_jax():
    """EntityStore's own API, op by op on a custom schema: creates with
    explicit guids (and their rejections), every typed property, the
    identity lookups and mirrors, record queries, with_column and the
    record hooks' calls."""
    a, b = _stores()
    st = {a: a.init_state(), b: b.init_state()}
    logs = {a: [], b: []}
    for s in (a, b):
        s.subscribe_records(lambda c, r, op, rows, rr, tags, log=logs[s]:
                            log.append((c, r, int(op), rows.tolist(), _conv(rr, False), tags)))

    def both(method, *args, **kw):
        """Call a store method on both stores; keep the new states, check
        their trees, and return the port's read-back (equal to JAX's)."""
        out = {}
        for s in (a, b):
            r = getattr(s, method)(st[s], *_conv(args, s is a), **_conv(kw, s is a))
            if isinstance(r, tuple) and hasattr(r[0], "classes"):
                st[s], r = r[0], r[1:]
            elif hasattr(r, "classes"):
                st[s], r = r, None
            out[s] = _conv(r, False)
        assert out[a] == out[b], method
        assert_tree_equal(jax_tree(st[a]), state_to_numpy(st[b]))
        return out[b]

    def read(method, *args):
        ra = getattr(a, method)(st[a], *_conv(args, True))
        rb = getattr(b, method)(st[b], *args)
        assert _conv(ra, False) == rb, method
        return rb

    t1 = both("create_object", "Thing", values={"X": 3, "F": 1.5})[0]
    t2 = both("create_object", "Thing", guid=Guid(1, 99),
              values={"S": "hi", "O": t1, "V": (1.0, 2.0, 3.0)})[0]
    assert t2 == Guid(1, 99)
    for s in (a, b):
        with pytest.raises(ValueError, match="already exists"):
            s.create_many(st[s], "Thing", 1, guids=[_conv(t2, s is a)])
        with pytest.raises(ValueError, match="duplicate"):
            s.create_many(st[s], "Thing", 2, guids=_conv([Guid(2, 1), Guid(2, 1)], s is a))
        assert s.live_count("Thing") == 2
    for name, v in (("X", -7), ("F", 0.1), ("S", "x"), ("O", t2), ("V", (4.0, 5.0, 6.0)),
                    ("O", Guid())):
        both("set_property", t1, name, v)
        read("get_property", t1, name)
    h = b.handle_of(t2)
    assert h == a.handle_of(JGuid(1, 99)) and b.row_of(t2) == a.row_of(JGuid(1, 99))
    assert b.guid_of_handle(h) == t2 and b.guid_of_handle(-1) is None
    assert b.guid_of_handle(h + (5 << 24)) is None
    both("record_add_row", t2, "Refs", {"Who": t1, "At": (1.0, 2.0, 3.0), "N": 5, "Tag": "a"})
    both("record_add_row", t2, "Refs", {"N": 5})
    both("record_set", t2, "Refs", 1, "Tag", "b")
    both("record_swap_rows", t2, "Refs", 0, 3)
    both("record_restore_row", t2, "Refs", 2, {"N": 9, "Who": t2})
    assert read("record_used_rows", t2, "Refs") == [1, 2, 3]
    assert read("record_find_rows", t2, "Refs", "N", 5) == [1, 3]
    assert read("record_find_rows", t2, "Refs", "Tag", "b") == [1]
    for rr in range(4):
        for tag in ("Who", "At", "N", "Tag"):
            read("record_get", t2, "Refs", rr, tag)
    with pytest.raises(TypeError):
        b.record_find_rows(st[b], t2, "Refs", "At", (0.0, 0.0, 0.0))
    both("record_remove_row", t2, "Refs", 3)
    both("record_write_rows", "Thing", np.asarray([0, 1]), "Refs", 0,
         {"N": [4, 6], "Tag": ["p", "q"]})
    col = np.asarray([11, 12, 13, 14, 15, 16, 17, 18], np.int32)
    st[a] = a.with_column(st[a], "Thing", "X", col)
    st[b] = b.with_column(st[b], "Thing", "X", torch.from_numpy(col))
    assert_tree_equal(jax_tree(st[a]), state_to_numpy(st[b]))
    assert logs[a] == logs[b]
    assert [e[2] for e in logs[b]] == [RecordOp.ADD, RecordOp.ADD, RecordOp.UPDATE,
                                       RecordOp.SWAP, RecordOp.ADD, RecordOp.DEL,
                                       RecordOp.UPDATE]
    both("set_property", t2, "O", t1)
    both("destroy_object", t1)
    hb = b._hosts["Thing"]
    assert hb.live_count == 1 and hb.row_gen.tolist() == a._hosts["Thing"].row_gen.tolist()
    assert read("get_property", t2, "O") == Guid()  # the target's row is free


def test_create_from_element_matches_jax():
    """create_from_element: the element's values, its ConfigID, then the
    overrides (unknown properties dropped), through the full create
    chain; equal trees and values in both packages."""
    a, b = _worlds(5)
    got = []
    for w in (a, b):
        k = w.kernel
        k.elements.add_element("NPC", "goblin", {"HP": 33, "AtkDis": 1.5, "SeedID": "gob"})
        events = []
        k.register_class_event(lambda g, c, ev, events=events: events.append(int(ev)), "NPC")
        g = k.create_from_element("NPC", "goblin", {"HP": 40, "NoSuchProp": 1}, scene=1)
        got.append((str(g), events, k.get_property(g, "HP"), k.get_property(g, "AtkDis"),
                    k.get_property(g, "ConfigID"), k.get_property(g, "SeedID")))
    assert got[0] == got[1]
    assert got[1][1:] == ([0, 1, 2, 3, 4, 5, 6], 40, 1.5, "goblin", "gob")
    assert_tree_equal(jax_tree(a.kernel.state), state_to_numpy(b.kernel.state))
