"""The port's social modules (game/social.py) and their KV persistence
(persist/social.py) against the JAX package on the CPU: the cases of
tests/test_social.py and tests/test_social_persist.py (the process kill
and reload through SocialDataAgent included), each written once and run
on both packages (test_torch_middleware.run_both), with equal answers,
banks and module state after every step (tolerance 0).  PVP times are
passed as ``now=`` so neither run reads the wall clock."""

from __future__ import annotations

import pytest

from test_torch_middleware import run_both
from test_torch_parity import one_intra_op_thread  # noqa: F401


def social_world(rig):
    w = rig.world(combat=False, movement=False, regen=False, npc_capacity=16,
                  player_capacity=16)
    w.scene.create_scene(1)
    w.kernel.elements.add_element("Item", "apple", {
        "ItemType": int(rig.P.game.ItemType.ITEM), "BuyPrice": 5, "SalePrice": 2})
    return w


def mk_player(rig, w, name):
    return rig.rec(f"player {name}", w.kernel.create_object(
        "Player", {"Name": name, "Account": name.lower()}, scene=1, group=0))


# -- tests/test_social.py -------------------------------------------------------


def so_team_lifecycle(rig):
    w = social_world(rig)
    a, b, c = (mk_player(rig, w, n) for n in ("Ta", "Tb", "Tc"))
    t, r, k = w.team, rig.rec, w.kernel
    tid = r("create", t.create_team(a))
    assert tid is not None
    assert r("create twice", t.create_team(a)) is None
    assert r("join", t.join(tid, b))
    assert not r("join twice", t.join(tid, b))
    assert r("team id", k.get_property(b, "TeamID")) == tid
    assert r("leader", t.team_of(b).leader) == a
    assert r("leave", t.leave(a))
    assert r("leader", t.team_of(b).leader) == b
    assert r("no team", k.get_property(a, "TeamID")) == rig.P.datatypes.NULL_GUID
    assert r("join c", t.join(t.team_of(b).team_id, c))
    assert r("disband", t.disband(b))
    assert r("gone", t.team_of(c)) is None


def so_mail_send_read_draw(rig):
    w = social_world(rig)
    p = mk_player(rig, w, "MailGuy")
    m, r = w.mail, rig.rec
    mid = r("send", m.send("mailguy", "system", "welcome", "hi", gold=50,
                           items={"apple": 3}))
    box = r("box", m.mailbox("mailguy"))
    assert len(box) == 1 and not box[0].read
    assert r("read", m.read("mailguy", mid)).title == "welcome"
    g0 = int(w.kernel.get_property(p, "Gold"))
    assert r("draw", m.draw("mailguy", mid, p))
    assert not r("draw twice", m.draw("mailguy", mid, p))
    assert r("gold", int(w.kernel.get_property(p, "Gold"))) == g0 + 50
    assert r("apples", w.pack.item_count(p, "apple")) == 3
    assert r("delete", m.delete("mailguy", mid))
    assert r("empty", m.mailbox("mailguy")) == []


def so_rank_lists(rig):
    w = social_world(rig)
    rk, r = w.rank, rig.rec
    for name, score in (("a", 30), ("b", 50), ("c", 50), ("d", 10)):
        rk.update("level", name, score)
    assert r("top", rk.top("level", 2)) == [("b", 50), ("c", 50)]
    assert r("b", rk.rank_of("level", "b")) == 1
    assert r("c", rk.rank_of("level", "c")) == 2
    assert r("d", rk.rank_of("level", "d")) == 4
    rk.update("level", "d", 99)
    assert r("d up", rk.rank_of("level", "d")) == 1
    rk.remove("level", "d")
    assert r("removed", rk.score("level", "d")) is None


def so_shop_buy_sell(rig):
    w = social_world(rig)
    p = mk_player(rig, w, "Shopper")
    k, r = w.kernel, rig.rec
    k.set_property(p, "Gold", 12)
    assert r("buy", w.shop.buy(p, "apple", 2))
    assert r("gold", int(k.get_property(p, "Gold"))) == 2
    assert r("apples", w.pack.item_count(p, "apple")) == 2
    assert not r("broke", w.shop.buy(p, "apple", 1))
    assert r("sell", w.shop.sell(p, "apple", 2))
    assert r("gold", int(k.get_property(p, "Gold"))) == 6
    assert r("apples", w.pack.item_count(p, "apple")) == 0


def so_friend_lists_and_blocks(rig):
    w = social_world(rig)
    f, r = w.friends, rig.rec
    assert r("add", f.add_friend("ann", "bob"))
    assert not r("again", f.add_friend("ann", "bob"))
    assert not r("self", f.add_friend("ann", "ann"))
    assert r("mutual", f.friends("bob")) == ["ann"]
    f.block("bob", "ann")
    assert r("blocked", (f.friends("bob"), f.friends("ann"))) == ([], [])
    assert not r("refused", f.add_friend("ann", "bob"))
    f.unblock("bob", "ann")
    assert r("re-add", f.add_friend("ann", "bob"))


def so_guild_lifecycle(rig):
    w = social_world(rig)
    a, b = mk_player(rig, w, "Ga"), mk_player(rig, w, "Gb")
    g, r = w.guilds, rig.rec
    gid = r("create", g.create_guild(a, "Knights"))
    assert gid is not None
    assert r("name taken", g.create_guild(b, "Knights")) is None
    assert r("join", g.join(gid, b))
    assert r("guild id", w.kernel.get_property(b, "GuildID")) == gid
    assert r("members", g.find_by_name("Knights").members) == [a, b]
    assert r("leave a", g.leave(a))
    assert r("leader", g.guild_of(b).leader) == b
    assert r("leave b", g.leave(b))
    assert r("dissolved", g.find_by_name("Knights")) is None


def so_gm_commands_gated(rig):
    w = social_world(rig)
    p = mk_player(rig, w, "Op")
    k, gm, r = w.kernel, w.gm, rig.rec
    assert not r("no level", gm.handle_command(p, "/gold 100"))
    k.set_property(p, "GMLevel", 1)
    g0 = int(k.get_property(p, "Gold"))
    assert r("gold", gm.handle_command(p, "/gold 100"))
    assert r("gold", int(k.get_property(p, "Gold"))) == g0 + 100
    assert r("level", gm.handle_command(p, "/level 9"))
    assert r("level", int(k.get_property(p, "Level"))) == 9
    assert r("item", gm.handle_command(p, "/item apple 4"))
    assert r("apples", w.pack.item_count(p, "apple")) >= 4
    assert not r("chat", gm.handle_command(p, "hello"))
    assert not r("unknown", gm.handle_command(p, "/nosuch"))


def so_pvp_matchmaking_window_and_widening(rig):
    w = social_world(rig)
    pvp, r = w.pvp, rig.rec
    a, b, c = (mk_player(rig, w, n) for n in ("Pa", "Pb", "Pc"))
    assert r("a", pvp.join_queue(a, 1000, now=0.0))
    assert not r("a twice", pvp.join_queue(a, 1000, now=0.0))
    assert r("b", pvp.join_queue(b, 1050, now=0.0))
    assert r("c", pvp.join_queue(c, 5000, now=0.0))
    assert r("pairs", pvp.match_once(now=0.0)) == [(a, b)]
    assert r("queue", [t.player for t in pvp.queue]) == [c]
    d = mk_player(rig, w, "Pd")
    r("d", pvp.join_queue(d, 5900, now=0.0))
    assert r("none", pvp.match_once(now=0.0)) == []
    assert r("widened", pvp.match_once(now=20.0)) == [(c, d)]
    assert r("empty", pvp.queue) == []


def so_destroyed_member_auto_leaves(rig):
    w = social_world(rig)
    a, b = mk_player(rig, w, "Da"), mk_player(rig, w, "Db")
    r = rig.rec
    tid = r("team", w.team.create_team(a))
    r("join", w.team.join(tid, b))
    w.kernel.destroy_object(a)
    t = r("team of b", w.team.team_of(b))
    assert t is not None and a not in t.members
    assert t.leader == b
    assert r("leave", w.team.leave(b))


def so_mail_draw_fails_whole_on_full_bag(rig):
    w = social_world(rig)
    p = mk_player(rig, w, "FullBag")
    r = rig.rec
    for i in range(64):
        assert w.pack.create_item(p, f"junk_{i}", 1)
    mid = r("send", w.mail.send("fullbag", "sys", "loot", gold=10, items={"apple": 1}))
    g0 = int(w.kernel.get_property(p, "Gold"))
    assert not r("full", w.mail.draw("fullbag", mid, p))
    assert r("gold", int(w.kernel.get_property(p, "Gold"))) == g0
    assert not r("undrawn", w.mail.mailbox("fullbag")[0].drawn)
    w.pack.delete_item(p, "junk_0", 1)
    assert r("draw", w.mail.draw("fullbag", mid, p))


def so_shop_missing_price_not_free(rig):
    w = social_world(rig)
    p = mk_player(rig, w, "Cheapo")
    r = rig.rec
    w.kernel.elements.add_element("Item", "priceless", {})
    w.kernel.set_property(p, "Gold", 1000)
    assert r("price", w.shop.price_of("priceless")) is None
    assert not r("buy", w.shop.buy(p, "priceless"))
    assert r("count", w.pack.item_count(p, "priceless")) == 0


def so_gm_malformed_args_return_false(rig):
    w = social_world(rig)
    p = mk_player(rig, w, "Gm2")
    r = rig.rec
    w.kernel.set_property(p, "GMLevel", 1)
    assert not r("level", w.gm.handle_command(p, "/level abc"))
    assert not r("kill", w.gm.handle_command(p, "/kill not-a-guid"))
    assert not r("gold", w.gm.handle_command(p, "/gold"))


SOCIAL = [so_team_lifecycle, so_mail_send_read_draw, so_rank_lists, so_shop_buy_sell,
          so_friend_lists_and_blocks, so_guild_lifecycle, so_gm_commands_gated,
          so_pvp_matchmaking_window_and_widening, so_destroyed_member_auto_leaves,
          so_mail_draw_fails_whole_on_full_bag, so_shop_missing_price_not_free,
          so_gm_malformed_args_return_false]


@pytest.mark.parametrize("case", SOCIAL, ids=lambda c: c.__name__[3:])
def test_social_case(case):
    """tests/test_social.py's cases on both packages, equal after every
    step."""
    run_both(case)


# -- tests/test_social_persist.py ------------------------------------------------


def persist_world(rig):
    w = rig.world(combat=False, movement=False, regen=False, npc_capacity=64,
                  player_capacity=8)
    w.scene.create_scene(1)
    return w


def bind(rig, w, kv):
    return rig.P.persist.SocialDataAgent(kv).bind(w.kernel, mail=w.mail, rank=w.rank,
                                                  guilds=w.guilds)


def player(rig, w, account, name):
    return rig.rec(f"player {account}", w.kernel.create_object(
        "Player", {"Name": name, "Account": account}, scene=1, group=0))


def kv_view(rig, kv, label):
    rig.rec(label, {key: kv.get(key) for key in sorted(kv.keys("*"))})


def sp_mail_survives_process_kill(rig):
    kv, r = rig.P.persist.MemoryKV(), rig.rec
    w1 = persist_world(rig)
    bind(rig, w1, kv)
    mid = r("send", w1.mail.send("alice", "system", "Welcome", "hi", gold=25,
                                 items={"potion": 2}))
    w1.mail.send("bob", "system", "Other")
    kv_view(rig, kv, "kv")
    w2 = persist_world(rig)
    bind(rig, w2, kv)
    box = r("box", w2.mail.mailbox("alice"))
    assert [m.title for m in box] == ["Welcome"]
    assert box[0].gold == 25 and box[0].items == {"potion": 2}
    assert r("next id", w2.mail.send("alice", "system", "Second")) > mid
    w2.kernel.elements.add_element("Item", "potion", {"ItemType": 2})
    p = player(rig, w2, "alice", "Alice")
    assert r("draw", w2.mail.draw("alice", mid, p))
    w3 = persist_world(rig)
    bind(rig, w3, kv)
    assert r("drawn", w3.mail.mailbox("alice")[0].drawn)
    kv_view(rig, kv, "kv")


def sp_rank_survives_process_kill(rig):
    kv, r = rig.P.persist.MemoryKV(), rig.rec
    w1 = persist_world(rig)
    bind(rig, w1, kv)
    w1.rank.update("level", "alice", 30)
    w1.rank.update("level", "bob", 40)
    w1.rank.update("power", "alice", 900)
    w1.rank.remove("power", "alice")
    kv_view(rig, kv, "kv")
    w2 = persist_world(rig)
    bind(rig, w2, kv)
    assert r("top", w2.rank.top("level")) == [("bob", 40), ("alice", 30)]
    assert r("removed", w2.rank.score("power", "alice")) is None


def sp_guild_survives_process_kill_and_relinks_members(rig):
    kv, r = rig.P.persist.MemoryKV(), rig.rec
    w1 = persist_world(rig)
    bind(rig, w1, kv)
    lead = player(rig, w1, "lead", "Lead")
    mate = player(rig, w1, "mate", "Mate")
    gid = r("create", w1.guilds.create_guild(lead, "Axiom"))
    assert gid is not None
    assert r("join", w1.guilds.join(gid, mate))
    w1.kernel.destroy_object(mate)
    w1.kernel.destroy_object(lead)
    assert r("dormant", w1.guilds.find_by_name("Axiom")) is None
    kv_view(rig, kv, "kv")
    w2 = persist_world(rig)
    bind(rig, w2, kv)
    mate2 = player(rig, w2, "mate", "Mate")
    info = r("resurrected", w2.guilds.find_by_name("Axiom"))
    assert info is not None and mate2 in info.members
    lead2 = player(rig, w2, "lead", "Lead")
    info = r("relinked", w2.guilds.find_by_name("Axiom"))
    assert lead2 in info.members and info.leader == lead2
    assert r("guild id", w2.kernel.get_property(mate2, "GuildID")) == info.group_id


def sp_voluntary_leave_drops_durable_membership(rig):
    kv, r = rig.P.persist.MemoryKV(), rig.rec
    w1 = persist_world(rig)
    bind(rig, w1, kv)
    lead = player(rig, w1, "lead", "Lead")
    mate = player(rig, w1, "mate", "Mate")
    gid = r("create", w1.guilds.create_guild(lead, "Axiom"))
    r("join", w1.guilds.join(gid, mate))
    assert r("leave", w1.guilds.leave(mate))
    kv_view(rig, kv, "kv")
    w2 = persist_world(rig)
    bind(rig, w2, kv)
    player(rig, w2, "mate", "Mate")
    assert r("not a member", w2.guilds.find_by_name("Axiom")) is None
    player(rig, w2, "lead", "Lead")
    info = r("lead back", w2.guilds.find_by_name("Axiom"))
    assert info is not None and len(info.members) == 1


def sp_disband_deletes_the_record(rig):
    kv, r = rig.P.persist.MemoryKV(), rig.rec
    w1 = persist_world(rig)
    bind(rig, w1, kv)
    lead = player(rig, w1, "lead", "Lead")
    r("create", w1.guilds.create_guild(lead, "Axiom"))
    assert r("disband", w1.guilds.disband(lead))
    w2 = persist_world(rig)
    bind(rig, w2, kv)
    player(rig, w2, "lead", "Lead")
    assert r("gone", w2.guilds.find_by_name("Axiom")) is None
    assert r("keys", kv.keys("guild:*")) == []


def sp_social_kv_coexists_with_player_blobs(rig):
    kv, r = rig.P.persist.MemoryKV(), rig.rec
    w1 = persist_world(rig)
    bind(rig, w1, kv)
    rig.P.agent.PlayerDataAgent(kv).bind(w1.kernel)
    p = player(rig, w1, "carol", "Carol")
    w1.kernel.set_property(p, "Level", 12)
    w1.mail.send("carol", "system", "Hello")
    w1.kernel.destroy_object(p)
    kv_view(rig, kv, "kv")
    w2 = persist_world(rig)
    bind(rig, w2, kv)
    rig.P.agent.PlayerDataAgent(kv).bind(w2.kernel)
    p2 = player(rig, w2, "carol", "Carol")
    assert r("level", int(w2.kernel.get_property(p2, "Level"))) == 12
    assert r("titles", [m.title for m in w2.mail.mailbox("carol")]) == ["Hello"]


def sp_dormant_guild_name_not_claimable_by_strangers(rig):
    kv, r = rig.P.persist.MemoryKV(), rig.rec
    w1 = persist_world(rig)
    bind(rig, w1, kv)
    lead = player(rig, w1, "lead", "Lead")
    r("create", w1.guilds.create_guild(lead, "Axiom"))
    w1.kernel.destroy_object(lead)
    stranger = player(rig, w1, "stranger", "Stranger")
    assert r("reserved", w1.guilds.create_guild(stranger, "Axiom")) is None
    assert r("other", w1.guilds.create_guild(stranger, "Other")) is not None
    lead2 = player(rig, w1, "lead", "Lead")
    info = r("back", w1.guilds.find_by_name("Axiom"))
    assert info is not None and info.leader == lead2 and stranger not in info.members


PERSIST = [sp_mail_survives_process_kill, sp_rank_survives_process_kill,
           sp_guild_survives_process_kill_and_relinks_members,
           sp_voluntary_leave_drops_durable_membership, sp_disband_deletes_the_record,
           sp_social_kv_coexists_with_player_blobs,
           sp_dormant_guild_name_not_claimable_by_strangers]


@pytest.mark.parametrize("case", PERSIST, ids=lambda c: c.__name__[3:])
def test_social_persist_case(case):
    """tests/test_social_persist.py's cases on both packages (each process
    kill is a fresh world over the same KV), equal after every step,
    the KV's keys and bytes included."""
    run_both(case)
