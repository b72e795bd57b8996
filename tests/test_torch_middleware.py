"""The port's gameplay middleware (noahgameframe_tpu_torch/game/{items,hero,
task,buff,social,slg}.py) against the JAX package on the CPU.

Each case is written once against a package namespace and run on both
packages' worlds (guids pinned, so both mint the same ones).  After every
step it records the step's answer, every world's state tree and the
middleware modules' host state; the two runs must agree at every step,
bit for bit (tolerance 0).  Here: the nine cases of tests/test_middleware.py,
the buff phase on seeded BuffList contents, a middleware checkpoint that
loads across packages both ways, and examples/tutorial7_gameplay.py's walk.
The rig (``Rig``, ``run_both``) is shared by the other middleware test
files."""

from __future__ import annotations

import dataclasses
import enum
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from noahgameframe_tpu_torch.core.store import state_to_numpy
from test_torch_parity import assert_tree_equal, jax_tree
from test_torch_parity import one_intra_op_thread  # noqa: F401

JAX, PORT = "noahgameframe_tpu", "noahgameframe_tpu_torch"
GUID_PIN = 4000
# the middleware modules whose host state a step compares
MIDDLEWARE = ("pack", "items", "equip", "heroes", "tasks", "buffs", "team", "mail",
              "rank", "shop", "friends", "guilds", "gm", "pvp", "slg_building",
              "slg_shop")


def package(name: str) -> SimpleNamespace:
    """The modules a middleware case needs, from one package by name."""
    def m(sub):
        return importlib.import_module(f"{name}.{sub}")

    return SimpleNamespace(
        name=name, port=name == PORT, kw={"device": "cpu"} if name == PORT else {},
        game=m("game"), world=m("game.world"), datatypes=m("core.datatypes"),
        persist=m("persist"), agent=m("persist.agent"), kv=m("persist.kv"),
        hero=m("game.hero"), task=m("game.task"), kernel=m("kernel"),
        checkpoint=m("persist.checkpoint"), role=m("net.roles.game"),
        base=m("net.roles.base"), transport=m("net.transport"), wire=m("net.wire"),
        families=m("net.wire_families"), msg=m("net.defines"), client=m("client"),
        roles=m("net.roles"), sql=m("persist.sql"))


PKGS = {n: package(n) for n in (JAX, PORT)}


def canon(x):
    """A value of either package as plain, comparable Python."""
    if isinstance(x, enum.Enum):
        return int(x.value)
    if type(x).__name__ == "Guid":
        return ("guid", int(x.head), int(x.data))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, canon(dataclasses.asdict(x)))
    if isinstance(x, dict):
        return {canon(k): canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(canon(v) for v in x)
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    if isinstance(x, np.floating):
        return float(x)
    return x


def state_tree(w) -> dict:
    return state_to_numpy(w.kernel.state) if w.kernel.__module__.startswith(PORT) \
        else jax_tree(w.kernel.state)


def module_state(w) -> dict:
    """The middleware modules' host state: their checkpoint state plus
    what they hold outside it (the PVP queue, the SLG due heap, the
    summons, the task definitions)."""
    out = {}
    for attr in MIDDLEWARE:
        mod = getattr(w, attr, None)
        if mod is not None:
            out[attr] = canon(mod.checkpoint_state())
    if getattr(w, "pvp", None) is not None:
        out["pvp.queue"] = [(canon(t.player), t.score, t.mode) for t in w.pvp.queue]
        out["pvp.matches"] = canon(list(w.pvp.matches))
    if getattr(w, "slg_building", None) is not None:
        out["slg.due"] = canon(sorted((d[0], canon(d[1]), d[2], d[3])
                                      for d in w.slg_building._due))
    if getattr(w, "heroes", None) is not None:
        out["hero.summons"] = canon(w.heroes._summons)
    if getattr(w, "tasks", None) is not None:
        out["task.defs"] = canon(w.tasks.defs)
    return out


class Rig:
    """One package's run of a case: ``world(**cfg)`` builds a started,
    guid-pinned world of this package; ``rec(label, value)`` logs the
    value with every world's state tree and module state, and returns the
    value."""

    def __init__(self, P: SimpleNamespace):
        self.P = P
        self.worlds = []
        self.log = []

    def world(self, pin: int = GUID_PIN, **cfg):
        w = self.P.world.GameWorld(self.P.world.WorldConfig(**cfg), **self.P.kw).start()
        w.kernel.store.guids.pin(pin)
        self.worlds.append(w)
        return w

    def rec(self, label: str, value=None):
        self.log.append((label, canon(value), [state_tree(w) for w in self.worlds],
                         [module_state(w) for w in self.worlds]))
        return value


def assert_logs_equal(a, b) -> None:
    assert [e[0] for e in a] == [e[0] for e in b], "the runs took different steps"
    for (label, va, ta, ma), (_, vb, tb, mb) in zip(a, b):
        assert va == vb, (label, va, vb)
        assert len(ta) == len(tb), label
        for i, (x, y) in enumerate(zip(ta, tb)):
            assert_tree_equal(x, y, f"{label}: world {i}")
        assert ma == mb, label


def run_both(case, *args):
    """Run ``case(rig, *args)`` on the JAX package, then on the port, and
    hold the two logs equal step by step; returns the port's rig."""
    rigs = []
    for name in (JAX, PORT):
        rig = Rig(PKGS[name])
        case(rig, *args)
        rigs.append(rig)
    assert len(rigs[1].log) > 0
    assert_logs_equal(rigs[0].log, rigs[1].log)
    return rigs[1]


class WireRig:
    """A game role of the rig's package over ``world`` with its sends
    captured (``sent``: ``(conn, msg id, bytes)``, the wall-clock stamped
    frame-trace sidecars left out), the test_client_handlers.py rig:
    ``seat`` binds a session to a new Player, ``send`` feeds one client
    message through the role's dispatch, ``acks`` lists a connection's
    bodies of one message id."""

    def __init__(self, rig, world, name: str = "MidGame"):
        P = self.P = rig.P
        self.role = P.role.GameRole(P.base.RoleConfig(6, 0, name, "127.0.0.1", 0),
                                    backend="py", world=world, cross_server_sync=False)
        self.sent = []
        trace = P.msg.TRACE_MSG_IDS

        def send_raw(c, m, b):
            if int(m) not in trace:
                self.sent.append((int(c), int(m), bytes(b)))
            return True

        self.role.server.send_raw = send_raw

    def seat(self, i: int, account: str, values=None):
        P, role = self.P, self.role
        ident = P.wire.Ident(svrid=9, index=i)
        sess = P.role.Session(ident=ident, conn_id=100 + i, account=account)
        g = role.kernel.create_object(
            "Player", values or {"Name": account.title(), "Account": account},
            scene=1, group=0)
        sess.guid = g
        role.sessions[P.wire.ident_key(ident)] = sess
        role._guid_session[g] = P.wire.ident_key(ident)
        return ident, g

    def send(self, ident, msg_id, msg, conn=None):
        P = self.P
        conn = 100 + ident.index if conn is None else conn
        self.role.server.dispatch.feed([P.transport.NetEvent(
            P.transport.EV_MSG, conn, int(msg_id), P.wire.wrap(msg, player_id=ident))])

    def acks(self, conn, msg_id):
        return [b for c, m, b in self.sent if c == conn and m == int(msg_id)]


# -- tests/test_middleware.py -------------------------------------------------


def combat_world(rig):
    w = rig.world(combat=True, movement=False, regen=False, npc_capacity=64,
                  player_capacity=8, attack_period_s=1 / 30, aoe_radius=1e6,
                  respawn_s=1e6)
    w.scene.create_scene(1)
    return w


def new_player(rig, w):
    g = w.kernel.create_object("Player", {"Name": "P", "Account": "p"}, scene=1, group=0)
    w.kernel.set_property(g, "Level", 3)
    return rig.rec("player", g)


def mw_pack_stack_and_consume(rig):
    w = combat_world(rig)
    player = new_player(rig, w)
    p, r = w.pack, rig.rec
    assert r("create 3", p.create_item(player, "potion_hp", 3))
    assert r("stack 2", p.create_item(player, "potion_hp", 2))
    assert r("count", p.item_count(player, "potion_hp")) == 5
    assert r("enough", p.enough_item(player, "potion_hp", 5))
    assert r("delete 4", p.delete_item(player, "potion_hp", 4))
    assert r("count", p.item_count(player, "potion_hp")) == 1
    assert r("delete 1", p.delete_item(player, "potion_hp", 1))
    assert r("count", p.item_count(player, "potion_hp")) == 0
    assert not r("delete empty", p.delete_item(player, "potion_hp", 1))


def mw_use_potion_restores_hp(rig):
    w = combat_world(rig)
    player = new_player(rig, w)
    k, G, r = w.kernel, rig.P.game, rig.rec
    k.elements.add_element("Item", "potion_hp", {
        "ItemType": int(G.ItemType.ITEM), "ItemSubType": int(G.ItemSubType.HP),
        "AwardValue": 30})
    w.properties.set_group_value(player, "MAXHP", G.PropertyGroup.JOBLEVEL, 100)
    w.properties.recompute_now(player)
    k.set_property(player, "HP", 50)
    r("set up", w.pack.create_item(player, "potion_hp", 2))
    assert r("use", w.items.use_item(player, "potion_hp"))
    assert r("hp", int(k.get_property(player, "HP"))) == 80
    assert r("use", w.items.use_item(player, "potion_hp"))
    assert r("hp capped", int(k.get_property(player, "HP"))) == 100
    assert not r("bag empty", w.items.use_item(player, "potion_hp"))


def mw_token_grants_gold(rig):
    w = combat_world(rig)
    player = new_player(rig, w)
    G, r = rig.P.game, rig.rec
    w.kernel.elements.add_element("Item", "gold_pouch", {
        "ItemType": int(G.ItemType.TOKEN), "ItemSubType": int(G.ItemSubType.CURRENCY),
        "AwardValue": 250})
    w.pack.create_item(player, "gold_pouch", 1)
    g0 = r("gold", int(w.kernel.get_property(player, "Gold")))
    assert r("use", w.items.use_item(player, "gold_pouch"))
    assert r("gold", int(w.kernel.get_property(player, "Gold"))) == g0 + 250


def mw_equip_wear_feeds_stat_group(rig):
    w = combat_world(rig)
    player = new_player(rig, w)
    G, r = rig.P.game, rig.rec
    w.kernel.elements.add_element("Item", "sword_1", {
        "ItemType": int(G.ItemType.EQUIP), "ATK_VALUE": 15, "MAXHP": 40})
    eq = r("equip", w.pack.create_equip(player, "sword_1"))
    assert eq is not None
    assert r("wear", w.equip.wear(player, eq))
    assert r("group", w.properties.get_group_value(
        player, "ATK_VALUE", G.PropertyGroup.EQUIP)) == 15
    w.properties.recompute_now(player)
    assert r("atk", int(w.kernel.get_property(player, "ATK_VALUE"))) == 15
    assert r("take off", w.equip.take_off(player, eq))
    assert r("group", w.properties.get_group_value(
        player, "ATK_VALUE", G.PropertyGroup.EQUIP)) == 0


def mw_hero_collect_level_fight_stats(rig):
    w = combat_world(rig)
    player = new_player(rig, w)
    G, r, h = rig.P.game, rig.rec, w.heroes
    w.kernel.elements.add_element("Item", "hero_knight", {"ATK_VALUE": 5, "MAXHP": 20})
    row = r("add", h.add_hero(player, "hero_knight"))
    assert row is not None
    assert r("dedupe", h.add_hero(player, "hero_knight")) == row
    assert r("fight", h.set_fight_hero(player, row))
    assert r("group", w.properties.get_group_value(
        player, "ATK_VALUE", G.PropertyGroup.FIGHTING_HERO)) == 5
    assert r("exp", h.add_hero_exp(player, row, 1000)) == 4
    assert r("group", w.properties.get_group_value(
        player, "ATK_VALUE", G.PropertyGroup.FIGHTING_HERO)) == 20


def mw_task_accept_progress_award(rig):
    w = combat_world(rig)
    player = new_player(rig, w)
    G, r, t = rig.P.game, rig.rec, w.tasks
    t.define_task(G.TaskDef("t_kill3", target_config="", count=3, award_gold=100,
                            award_exp=0))
    assert r("accept", t.accept(player, "t_kill3"))
    assert not r("dup", t.accept(player, "t_kill3"))
    assert r("status", t.status(player, "t_kill3")) == G.TaskState.IN_PROCESS
    t.add_process(player, "t_kill3", 2)
    assert r("process", t.process(player, "t_kill3")) == 2
    assert not r("early draw", t.draw_award(player, "t_kill3"))
    t.add_process(player, "t_kill3", 5)
    assert r("done", t.status(player, "t_kill3")) == G.TaskState.DONE
    g0 = int(w.kernel.get_property(player, "Gold"))
    assert r("draw", t.draw_award(player, "t_kill3"))
    assert r("gold", int(w.kernel.get_property(player, "Gold"))) == g0 + 100
    assert r("finish", t.status(player, "t_kill3")) == G.TaskState.FINISH
    assert not r("double draw", t.draw_award(player, "t_kill3"))


def mw_task_counts_device_kills(rig):
    w = combat_world(rig)
    player = new_player(rig, w)
    G, r, k, t = rig.P.game, rig.rec, w.kernel, w.tasks
    t.define_task(G.TaskDef("t_hunt", count=2, award_gold=10))
    r("accept", t.accept(player, "t_hunt"))
    w.seed_npcs(2, scene=1, group=0, hp=1)
    handle = k.store.handle_of(player)
    for npc in w.scene.objects_in_group(1, 0, "NPC"):
        k.state = k.store.set_property(k.state, npc, "HP", 0)
        k.state = k.store.set_property(k.state, npc, "LastAttacker", handle)
    r("planted")
    k.tick()
    assert r("process", t.process(player, "t_hunt")) == 2
    assert r("status", t.status(player, "t_hunt")) == G.TaskState.DONE


def mw_buff_applies_and_expires_on_device(rig):
    w = combat_world(rig)
    player = new_player(rig, w)
    r, b, k = rig.rec, w.buffs, w.kernel
    b.define_buff("haste", duration_s=3 / 30, stats={"ATK_VALUE": 7, "MOVE_SPEED": 100})
    assert r("apply", b.apply_buff(player, "haste"))
    w.tick()
    assert r("active", b.active_buffs(player)) == ["haste"]
    assert r("atk", int(k.get_property(player, "ATK_VALUE"))) == 7
    assert r("reapply", b.apply_buff(player, "haste"))
    w.run(2)
    assert r("atk", int(k.get_property(player, "ATK_VALUE"))) == 7
    w.run(4)
    assert r("expired", b.active_buffs(player)) == []
    assert r("atk", int(k.get_property(player, "ATK_VALUE"))) == 0


def mw_buffs_stack_distinct_kinds(rig):
    w = combat_world(rig)
    player = new_player(rig, w)
    r, b = rig.rec, w.buffs
    b.define_buff("b1", duration_s=10.0, stats={"DEF_VALUE": 3})
    b.define_buff("b2", duration_s=10.0, stats={"DEF_VALUE": 4})
    r("b1", b.apply_buff(player, "b1"))
    r("b2", b.apply_buff(player, "b2"))
    w.tick()
    assert r("active", sorted(b.active_buffs(player))) == ["b1", "b2"]
    assert r("def", int(w.kernel.get_property(player, "DEF_VALUE"))) == 7


MIDDLEWARE_CASES = [mw_pack_stack_and_consume, mw_use_potion_restores_hp,
                    mw_token_grants_gold, mw_equip_wear_feeds_stat_group,
                    mw_hero_collect_level_fight_stats, mw_task_accept_progress_award,
                    mw_task_counts_device_kills, mw_buff_applies_and_expires_on_device,
                    mw_buffs_stack_distinct_kinds]


@pytest.mark.parametrize("case", MIDDLEWARE_CASES, ids=lambda c: c.__name__[3:])
def test_middleware_case(case):
    """tests/test_middleware.py's nine cases, each on both packages, equal
    after every step."""
    run_both(case)


# -- the buff phase on seeded BuffList contents ---------------------------------


def _bufflist_write(rig, w, cname, used, cfg, exp):
    """Replace a class's BuffList ``used`` mask and its ConfigIdx and
    ExpireTick columns in place of the store's host API (which cannot
    write an unused row, a negative index or a past expiry)."""
    k = w.kernel
    cs = k.state.classes[cname]
    rec = cs.records["BuffList"]
    cols = k.store.spec(cname).records["BuffList"].cols
    if rig.P.port:
        import torch

        i32 = rec.i32.clone()
        i32[:, :, cols["ConfigIdx"].col] = torch.from_numpy(cfg)
        i32[:, :, cols["ExpireTick"].col] = torch.from_numpy(exp)
        rec = rec.replace(i32=i32, used=torch.from_numpy(used))
    else:
        import jax.numpy as jnp

        i32 = rec.i32.at[:, :, cols["ConfigIdx"].col].set(jnp.asarray(cfg))
        i32 = i32.at[:, :, cols["ExpireTick"].col].set(jnp.asarray(exp))
        rec = rec.replace(i32=i32, used=jnp.asarray(used))
    k.state = k.state.replace(classes={
        **k.state.classes, cname: cs.replace(records={**cs.records, "BuffList": rec})})


def buff_walk(rig, seed):
    """Six ticks; before each, every Player and NPC row's BuffList gets a
    seeded draw: used flags, config indices from -2 to past the table
    (the clip), expiries around the current tick.  After each tick the
    RUNTIME_BUFF stat row and the used mask equal a numpy reference."""
    w = rig.world(combat=False, movement=False, regen=False, npc_capacity=64,
                  player_capacity=8)
    w.scene.create_scene(1)
    w.seed_npcs(40)
    for i in range(5):
        w.kernel.create_object("Player", {"Name": f"b{i}", "Account": f"b{i}"},
                               scene=1, group=0)
    G = rig.P.game
    stats = list(G.STAT_NAMES)
    rng = np.random.default_rng(seed)
    table = np.zeros((5, len(stats)), np.int64)
    for b in range(5):
        picks = rng.choice(len(stats), 3, replace=False)
        vals = rng.integers(-50, 300, 3)
        table[b, picks] = vals
        w.buffs.define_buff(f"buff{b}", float(rng.integers(1, 20)),
                            {stats[s]: int(v) for s, v in zip(picks, vals)})
    rig.rec("defined")
    k = w.kernel
    for step in range(6):
        tick = int(np.asarray(k.state.tick))
        drawn = {}
        for cname in ("Player", "NPC"):
            cap = k.store.capacity(cname)
            rows = k.store.spec(cname).records["BuffList"].rec.max_rows
            used = rng.random((cap, rows)) < 0.6
            cfg = rng.integers(-2, 8, (cap, rows)).astype(np.int32)
            exp = (tick + rng.integers(-2, 4, (cap, rows))).astype(np.int32)
            _bufflist_write(rig, w, cname, used, cfg, exp)
            drawn[cname] = (used, cfg, exp)
        rig.rec(f"drawn {step}")
        k.tick()
        rig.rec(f"tick {step}")
        tree = state_tree(w)
        for cname, (used, cfg, exp) in drawn.items():
            active = used & (exp > tick)
            want = (table[np.clip(cfg, 0, 4)] * active[:, :, None]).sum(axis=1)
            crec = tree["classes"][cname]["records"][G.COMM_PROPERTY_RECORD]
            cols = k.store.spec(cname).records[G.COMM_PROPERTY_RECORD].cols
            got = crec["i32"][:, int(G.PropertyGroup.RUNTIME_BUFF),
                              [cols[n].col for n in stats]]
            np.testing.assert_array_equal(got, want.astype(np.int32), err_msg=cname)
            np.testing.assert_array_equal(
                tree["classes"][cname]["records"]["BuffList"]["used"], active)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_buff_phase_seeded_walk(seed):
    """The port's buff phase (an accumulation over the 8 BuffList rows)
    against JAX's gather-and-sum on seeded records, Player and NPC rows:
    equal stat records and used masks after every tick, and both equal a
    numpy reference."""
    run_both(buff_walk, seed)


# -- a middleware checkpoint across packages -------------------------------------

CKPT_CONFIG = dict(combat=False, movement=True, regen=True, npc_capacity=64,
                   player_capacity=8, dt=1.0)


def _catalogue(w, G):
    e = w.kernel.elements
    e.add_element("Item", "blade", {"ItemType": int(G.ItemType.EQUIP), "ATK_VALUE": 9})
    e.add_element("Item", "ruby", {"ItemType": int(G.ItemType.GEM), "ATK_VALUE": 3})
    e.add_element("Item", "hero_mage", {"ItemType": int(G.ItemType.CARD), "ATK_VALUE": 4})
    e.add_element("Item", "bread", {"ItemType": int(G.ItemType.ITEM)})
    e.add_element("Building", "farm", {"Type": 3, "ItemID": "bread", "ProduceTime": 4})
    e.add_element("Shop", "shop_farm", {"Type": int(G.EShopType.BUILDING), "Level": 1,
                                        "Gold": 50, "ItemID": "farm"})
    w.tasks.define_task(G.TaskDef("t_any", count=5, award_gold=3))


def _middleware_script(w, G):
    """Host state in every middleware module: a worn equip with a gem, a
    fighting hero, an accepted task, two buffs (one expiring inside the
    next 30 ticks), a team, a guild, mail, a rank, friends, an SLG
    building mid-upgrade with production queued."""
    k = w.kernel
    w.scene.create_scene(1)
    w.seed_npcs(24)
    ps = [k.create_object("Player", {"Name": f"P{i}", "Account": f"a{i}"}, scene=1,
                          group=0) for i in range(4)]
    for p in ps:
        k.set_property(p, "Level", 3)
        k.set_property(p, "Gold", 400)
    p = ps[0]
    w.pack.create_item(p, "blade", 1)
    w.items.use_item(p, "blade")
    row = next(iter(w.pack.equips(p)))
    w.pack.create_item(p, "ruby", 1)
    w.items.use_item(p, "ruby", target=row)
    w.equip.wear(p, row)
    hero = w.heroes.add_hero(p, "hero_mage")
    w.heroes.set_fight_hero(p, hero, pos=0)
    w.tasks.accept(p, "t_any")
    w.buffs.define_buff("short", 5.0, {"ATK_VALUE": 2})
    w.buffs.define_buff("long", 100.0, {"DEF_VALUE": 6})
    for q in ps:
        w.buffs.apply_buff(q, "short")
        w.buffs.apply_buff(q, "long")
    team = w.team.create_team(ps[0])
    w.team.join(team, ps[1])
    guild = w.guilds.create_guild(ps[2], "Axiom")
    w.guilds.join(guild, ps[3])
    w.mail.send("a1", "system", "Hello", gold=5, items={"bread": 2})
    w.rank.update("level", "a0", 30)
    w.rank.update("level", "a1", 40)
    w.friends.add_friend("a0", "a2")
    w.slg_shop.buy(p, "shop_farm", x=3, y=4)
    b = next(iter(w.slg_building.buildings(p)))
    w.slg_building.upgrade_s = 12
    w.slg_building.upgrade(p, b)
    w.slg_building.produce(p, b, "bread", 3)
    k.enable_digest()
    w.run(3)


def _checkpoint_state(w) -> dict:
    return {m.name: canon(m.checkpoint_state()) for m in w.all_modules}


@pytest.mark.parametrize("saver", [JAX, PORT])
def test_middleware_checkpoint_loads_across_packages(saver, tmp_path):
    """A middleware world saved by one package loads into a fresh world of
    the other: equal banks and module checkpoint state, then equal
    digests on each of the next 30 ticks (the short buff expires, the SLG
    upgrade completes and production lands inside the window), and equal
    banks and module state at the end."""
    loader = PORT if saver == JAX else JAX
    S, L = PKGS[saver], PKGS[loader]
    a = Rig(S).world(**CKPT_CONFIG)
    _catalogue(a, S.game)
    _middleware_script(a, S.game)
    a.save(tmp_path / "mw")
    b = Rig(L).world(**CKPT_CONFIG)
    _catalogue(b, L.game)
    b.kernel.enable_digest()
    b.load(tmp_path / "mw")
    assert_tree_equal(state_tree(a), state_tree(b))
    assert _checkpoint_state(a) == _checkpoint_state(b)
    assert _checkpoint_state(b)["BuffModule"]["defs"] == {"short": 0, "long": 1}
    digests = []
    for t in range(30):
        a.tick()
        b.tick()
        da = a.kernel.last_counters["state_digest"]
        assert da == b.kernel.last_counters["state_digest"], t
        digests.append(da)
    assert len(set(digests)) == 30
    assert_tree_equal(state_tree(a), state_tree(b))
    assert _checkpoint_state(a) == _checkpoint_state(b)
    owner = next(g for g in b.kernel.store.guid_map
                 if b.kernel.store.row_of(g)[0] == "Player"
                 and str(b.kernel.get_property(g, "Account")) == "a0")
    assert b.pack.item_count(owner, "bread") >= 1
    assert b.slg_building.building_level(owner, next(iter(
        b.slg_building.buildings(owner)))) == 2
    assert b.buffs.active_buffs(owner) == ["long"]


# -- examples/tutorial7_gameplay.py's walk ----------------------------------------


def tutorial7(rig):
    """The tutorial's four parts (items and gems, heroes, the SLG city, and
    social persistence across a restart), each answer recorded."""
    G, r = rig.P.game, rig.rec

    def build_world():
        w = rig.world(combat=False, movement=False, regen=False, npc_capacity=64,
                      player_capacity=8, dt=1.0)
        w.scene.create_scene(1)
        e = w.kernel.elements
        e.add_element("Item", "blade", {"ItemType": int(G.ItemType.EQUIP), "ATK_VALUE": 9})
        e.add_element("Item", "ruby", {"ItemType": int(G.ItemType.GEM), "ATK_VALUE": 3})
        e.add_element("Item", "hero_mage", {"ItemType": int(G.ItemType.CARD),
                                            "ATK_VALUE": 4, "Skill1": "fireball_1"})
        e.add_element("Item", "tome", {"ItemType": int(G.ItemType.ITEM),
                                       "ItemSubType": int(G.ItemSubType.EXP),
                                       "AwardValue": 250})
        e.add_element("Skill", "fireball_1", {"AfterUpID": "fireball_2"})
        e.add_element("Skill", "fireball_2", {})
        e.add_element("Building", "farm", {"Type": 3, "ItemID": "bread", "ProduceTime": 2})
        e.add_element("Item", "bread", {"ItemType": int(G.ItemType.ITEM)})
        e.add_element("Shop", "shop_farm", {"Type": int(G.EShopType.BUILDING),
                                            "Level": 1, "Gold": 50, "ItemID": "farm"})
        return w

    kv = rig.P.persist.MemoryKV()
    w = build_world()
    rig.P.persist.SocialDataAgent(kv).bind(w.kernel, mail=w.mail, rank=w.rank,
                                           guilds=w.guilds)
    k = w.kernel
    p = k.create_object("Player", {"Name": "Ada", "Account": "ada"}, scene=1, group=0)
    k.set_property(p, "Level", 3)
    k.set_property(p, "Gold", 500)
    k.set_property(p, "Diamond", 10)
    r("player", p)
    # 1: items and gems
    w.pack.create_item(p, "blade", 1)
    assert r("use blade", w.items.use_item(p, "blade"))
    equip_row = next(iter(w.pack.equips(p)))
    w.pack.create_item(p, "ruby", 1)
    assert r("socket", w.items.use_item(p, "ruby", target=equip_row))
    w.equip.wear(p, equip_row)
    assert r("equip atk", w.properties.get_group_value(
        p, "ATK_VALUE", G.PropertyGroup.EQUIP)) == 12
    # 2: heroes
    w.pack.create_item(p, "hero_mage", 1)
    assert r("card", w.items.use_item(p, "hero_mage"))
    row = w.heroes.hero_row_of(p, "hero_mage")
    w.pack.create_item(p, "tome", 1)
    assert r("tome", w.items.use_item(p, "tome", target=row))
    assert r("skill up", w.heroes.hero_skill_up(p, row, 1))
    w.heroes.set_fight_hero(p, row, pos=0)
    r("award", w.properties.get_group_value(p, "ATK_VALUE", G.PropertyGroup.EQUIP_AWARD))
    assert r("hero level", w.heroes.hero_level(p, row)) == 2
    # 3: the SLG city
    assert r("buy", w.slg_shop.buy(p, "shop_farm", x=3, y=4))
    brow = next(iter(w.slg_building.buildings(p)))
    b = w.slg_building
    b.upgrade_s = 3
    assert r("upgrade", b.upgrade(p, brow))
    for i in range(4):
        w.tick()
        r(f"tick {i}")
    assert r("level", b.building_level(p, brow)) == 2
    assert r("produce", b.produce(p, brow, "bread", 2))
    for i in range(5):
        w.tick()
        r(f"tick {i}")
    assert r("bread", w.pack.item_count(p, "bread")) == 2
    # 4: social persistence across a restart
    w.mail.send("ada", "system", "Welcome!", gold=25)
    w.guilds.create_guild(p, "Pioneers")
    r("kv", {key: kv.get(key) for key in sorted(kv.keys("*"))})
    w2 = build_world()
    rig.P.persist.SocialDataAgent(kv).bind(w2.kernel, mail=w2.mail, rank=w2.rank,
                                           guilds=w2.guilds)
    p2 = w2.kernel.create_object("Player", {"Name": "Ada", "Account": "ada"},
                                 scene=1, group=0)
    assert len(r("mailbox", w2.mail.mailbox("ada"))) == 1
    guild = w2.guilds.find_by_name("Pioneers")
    assert r("relinked", p2 in guild.members)


def test_tutorial7_walk_on_both_packages():
    """examples/tutorial7_gameplay.py's walk (the example itself stays a
    JAX script) on both packages: equal answers, banks and module state
    after every step."""
    run_both(tutorial7)


# -- NPC deaths stay off the host class-event hooks ------------------------------


def npc_deaths(rig):
    """A fighting middleware world whose NPCs die and respawn in place:
    the tick path fires no class event (so the team, guild, hero and SLG
    hooks are never reached from it), while kills reach the batched kill
    subscribers (the task walk among them) every tick they happen."""
    w = rig.world(combat=True, movement=True, regen=True, npc_capacity=256,
                  player_capacity=8, extent=24.0, attack_period_s=1 / 30, respawn_s=0.2)
    w.scene.create_scene(1, width=24.0)
    w.seed_npcs(200, hp=30, atk=12)
    k = w.kernel
    fired, kills = [], []
    k.register_class_event(lambda g, c, ev: fired.append((c, int(ev))))
    k.events.subscribe_batch(int(rig.P.game.GameEvent.ON_OBJECT_BE_KILLED),
                             lambda c, mask, params: kills.append(int(mask.sum())))
    k.enable_digest()
    for t in range(20):
        w.tick()
        rig.rec(f"tick {t}", (k.last_counters["state_digest"], sum(kills)))
    assert fired == []
    assert sum(kills) > 0 and k.counter_totals["respawns"] > 0


def test_npc_deaths_fire_no_class_events():
    """20 ticks of a 200-NPC fight with the middleware on, in both
    packages: kills and respawns happen, no class event fires, and the
    runs stay equal after every tick."""
    run_both(npc_deaths)


def test_buff_table_change_recaptures_with_its_cause():
    """The captured tick closes over the buff table: redefining a buff
    after a capture captures the tick once more, named
    ``static:BuffModule.table`` in the cost book, and the next tick reads
    the new table."""
    w = Rig(PKGS[PORT]).world(combat=False, movement=False, regen=False, npc_capacity=64,
                              player_capacity=8)
    w.scene.create_scene(1)
    g = w.kernel.create_object("Player", {"Name": "T", "Account": "t"}, scene=1, group=0)
    w.buffs.define_buff("might", 10.0, {"ATK_VALUE": 1})
    w.buffs.apply_buff(g, "might")
    w.tick()
    entry = w.kernel.costbook.entries["kernel.step"]
    n0 = entry.compiles
    w.tick()
    assert entry.compiles == n0
    w.buffs.define_buff("might", 10.0, {"ATK_VALUE": 5})
    w.tick()
    assert entry.compiles == n0 + 1
    assert entry.causes == {"static:BuffModule.table": 1}
    assert int(w.kernel.get_property(g, "ATK_VALUE")) == 5


def task_kills_in_a_train(rig):
    """A 4-tick train of a fighting middleware world: the kill subscriber
    (the task walk and a log of each call's dead rows) hears each lane's
    kills in frame order; two NPCs planted at 0 HP with the player as
    their last attacker advance the player's task."""
    w = combat_world(rig)
    player = new_player(rig, w)
    k, t = w.kernel, w.tasks
    t.define_task(rig.P.game.TaskDef("t_hunt", count=3, award_gold=10))
    t.accept(player, "t_hunt")
    w.seed_npcs(40, hp=20, atk=12)
    heard = []
    k.events.subscribe_batch(int(rig.P.game.GameEvent.ON_OBJECT_BE_KILLED),
                             lambda c, mask, params: heard.append(
                                 [int(r) for r in np.flatnonzero(mask)]))
    handle = k.store.handle_of(player)
    for npc in w.scene.objects_in_group(1, 0, "NPC")[:2]:
        k.state = k.store.set_property(k.state, npc, "HP", 0)
        k.state = k.store.set_property(k.state, npc, "LastAttacker", handle)
    rig.rec("planted")
    k.configure_train(4)
    outs = k.train(8)
    rig.rec("trained", ([o.counters["tick"] for o in outs], heard))
    assert rig.rec("process", t.process(player, "t_hunt")) == 2
    assert len(heard) >= 2


def test_task_kills_in_a_train():
    """Kill events inside a train reach the task walk lane by lane, in both
    packages alike."""
    run_both(task_kills_in_a_train)
