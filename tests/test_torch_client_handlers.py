"""The port's middleware wire handlers (net/roles/game_handlers.py over the
port's middleware stack) against the JAX package on the CPU: the rig of
tests/test_client_handlers.py (a game role over a middleware world, its
sends captured, sessions seated by hand), with the port's role beside
JAX's role.  Every case runs on both packages; after every step the
answers, the banks, the module state and every byte the role sent are
equal (frame-trace sidecars, which carry wall-clock stamps, left out).
The PVP queue's wall clock is pinned (``social._time``) in both packages,
so both pair the same tickets."""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import pytest

from test_torch_middleware import WireRig, run_both
from test_torch_parity import one_intra_op_thread  # noqa: F401


@pytest.fixture(autouse=True)
def pinned_pvp_clock(monkeypatch):
    for name in ("noahgameframe_tpu", "noahgameframe_tpu_torch"):
        social = importlib.import_module(f"{name}.game.social")
        monkeypatch.setattr(social, "_time", SimpleNamespace(monotonic=lambda: 1000.0))


def rig_world(rig):
    w = rig.world(combat=False, movement=False, regen=False, npc_capacity=64,
                  player_capacity=8)
    return w, WireRig(rig, w)


def rec_sent(rig, wr, label):
    rig.rec(label, list(wr.sent))


def ch_use_item_and_equip_handlers(rig):
    w, wr = rig_world(rig)
    G, W, M, r = rig.P.game, rig.P.wire, rig.P.msg.MsgID, rig.rec
    e = w.kernel.elements
    e.add_element("Item", "hp_water", {"ItemType": int(G.ItemType.ITEM),
                                       "ItemSubType": int(G.ItemSubType.HP),
                                       "AwardValue": 30})
    e.add_element("Item", "axe", {"ItemType": int(G.ItemType.EQUIP), "ATK_VALUE": 6})
    ident, g = wr.seat(1, "ann")
    k = w.kernel
    w.properties.set_group_value(g, "MAXHP", G.PropertyGroup.EFFECTVALUE, 100)
    k.set_property(g, "HP", 10)
    w.pack.create_item(g, "hp_water", 1)
    wr.send(ident, M.REQ_ITEM_OBJECT,
            W.ReqAckUseItem(item=W.ItemStruct(item_id=b"hp_water", item_count=1)))
    assert r("hp", int(k.get_property(g, "HP"))) == 40
    assert wr.acks(101, M.ACK_ITEM_OBJECT)
    rec_sent(rig, wr, "used")
    w.pack.create_item(g, "axe", 1)
    wr.send(ident, M.REQ_ITEM_OBJECT,
            W.ReqAckUseItem(item=W.ItemStruct(item_id=b"axe", item_count=1)))
    row = next(iter(w.pack.equips(g)))
    wr.send(ident, M.WEAR_EQUIP, W.ReqWearEquip(equipid=W.Ident(svrid=0, index=row)))
    assert r("worn", w.properties.get_group_value(g, "ATK_VALUE",
                                                  G.PropertyGroup.EQUIP)) == 6
    wr.send(ident, M.TAKEOFF_EQUIP, W.TakeOffEquip(equipid=W.Ident(svrid=0, index=row)))
    assert r("off", w.properties.get_group_value(g, "ATK_VALUE",
                                                 G.PropertyGroup.EQUIP)) == 0
    rec_sent(rig, wr, "sent")


def ch_task_handlers(rig):
    w, wr = rig_world(rig)
    G, W, M, r = rig.P.game, rig.P.wire, rig.P.msg.MsgID, rig.rec
    w.tasks.define_task(G.TaskDef("t1", target_config="", count=1, award_exp=0,
                                  award_gold=7))
    ident, g = wr.seat(1, "bob")
    wr.send(ident, M.REQ_ACCEPT_TASK, W.ReqAcceptTask(task_id=b"t1"))
    assert r("accepted", w.tasks.status(g, "t1")) == G.TaskState.IN_PROCESS
    w.tasks.add_process(g, "t1", 1)
    assert r("done", w.tasks.status(g, "t1")) == G.TaskState.DONE
    gold0 = int(w.kernel.get_property(g, "Gold"))
    wr.send(ident, M.REQ_COMPLETE_TASK, W.ReqCompeleteTask(task_id=b"t1"))
    assert r("gold", int(w.kernel.get_property(g, "Gold"))) == gold0 + 7
    rec_sent(rig, wr, "sent")


def ch_team_handlers_create_join_kick_leave(rig):
    w, wr = rig_world(rig)
    W, M, r = rig.P.wire, rig.P.msg.MsgID, rig.rec
    cap_ident, cap = wr.seat(1, "cap")
    mem_ident, mem = wr.seat(2, "mem")
    wr.send(cap_ident, M.REQ_CREATE_TEAM, W.ReqAckCreateTeam())
    ack = wr.acks(101, M.ACK_CREATE_TEAM)
    assert ack
    _, created = W.unwrap(ack[-1], W.ReqAckCreateTeam)
    team_id = created.team_id
    wr.send(mem_ident, M.REQ_JOIN_TEAM, W.ReqAckJoinTeam(team_id=team_id))
    info = r("team", w.team.team_of(mem))
    assert info is not None and len(info.members) == 2
    joins = wr.acks(102, M.ACK_JOIN_TEAM)
    _, jmsg = W.unwrap(joins[-1], W.ReqAckJoinTeam)
    assert len(jmsg.xTeamInfo.teammemberInfo) == 2
    rec_sent(rig, wr, "joined")
    wr.send(mem_ident, M.REQ_OPRMEMBER_TEAM, W.ReqAckOprTeamMember(
        team_id=team_id, member_id=W.Ident(svrid=cap.head, index=cap.data), type=2))
    assert len(r("no kick", w.team.team_of(cap)).members) == 2
    wr.send(cap_ident, M.REQ_OPRMEMBER_TEAM, W.ReqAckOprTeamMember(
        team_id=team_id, member_id=W.Ident(svrid=mem.head, index=mem.data), type=2))
    assert r("kicked", w.team.team_of(mem)) is None
    wr.send(cap_ident, M.REQ_LEAVE_TEAM, W.ReqAckLeaveTeam())
    assert r("left", w.team.team_of(cap)) is None
    rec_sent(rig, wr, "sent")


def ch_guild_handlers_create_join_search_leave(rig):
    w, wr = rig_world(rig)
    W, M, r = rig.P.wire, rig.P.msg.MsgID, rig.rec
    lead_ident, lead = wr.seat(1, "lead")
    mate_ident, mate = wr.seat(2, "mate")
    wr.send(lead_ident, M.REQ_CREATE_GUILD, W.ReqAckCreateGuild(guild_name=b"Axiom"))
    assert wr.acks(101, M.ACK_CREATE_GUILD)
    assert r("created", w.guilds.find_by_name("Axiom")) is not None
    wr.send(mate_ident, M.REQ_JOIN_GUILD, W.ReqAckJoinGuild(guild_name=b"Axiom"))
    assert len(r("joined", w.guilds.find_by_name("Axiom")).members) == 2
    wr.send(mate_ident, M.REQ_SEARCH_GUILD, W.ReqSearchGuild(guild_name=b"axi"))
    _, found = W.unwrap(wr.acks(102, M.ACK_SEARCH_GUILD)[-1], W.AckSearchGuild)
    assert [x.guild_name for x in found.guild_list] == [b"Axiom"]
    assert found.guild_list[0].guild_member_count == 2
    wr.send(mate_ident, M.REQ_LEAVE_GUILD, W.ReqAckLeaveGuild())
    assert len(r("left", w.guilds.find_by_name("Axiom")).members) == 1
    assert wr.acks(102, M.ACK_LEAVE_GUILD)
    rec_sent(rig, wr, "sent")


def ch_use_item_targets_row_zero(rig):
    w, wr = rig_world(rig)
    G, W, M, r = rig.P.game, rig.P.wire, rig.P.msg.MsgID, rig.rec
    e = w.kernel.elements
    e.add_element("Item", "saber", {"ItemType": int(G.ItemType.EQUIP), "ATK_VALUE": 5})
    e.add_element("Item", "opal", {"ItemType": int(G.ItemType.GEM), "ATK_VALUE": 2})
    ident, g = wr.seat(1, "zed")
    assert r("row", w.pack.create_equip(g, "saber")) == 0
    w.pack.create_item(g, "opal", 1)
    wr.send(ident, M.REQ_ITEM_OBJECT, W.ReqAckUseItem(
        item=W.ItemStruct(item_id=b"opal", item_count=1), targetid=W.Ident(svrid=1, index=0)))
    assert r("gems", w.items.gems_of(g, 0)) == ["opal"]
    w.pack.create_item(g, "opal", 1)
    wr.send(ident, M.REQ_ITEM_OBJECT, W.ReqAckUseItem(
        item=W.ItemStruct(item_id=b"opal", item_count=1), targetid=W.Ident(svrid=0, index=0)))
    assert r("gems", w.items.gems_of(g, 0)) == ["opal"]
    assert r("bag", w.pack.item_count(g, "opal")) == 1
    rec_sent(rig, wr, "sent")


def ch_gm_command_wire(rig):
    w, wr = rig_world(rig)
    W, M, r, k = rig.P.wire, rig.P.msg.MsgID, rig.rec, w.kernel
    ident, g = wr.seat(1, "gm")
    cmd = W.ReqCommand(command_id=0, command_str_value=b"Level", command_value_int=9)
    wr.send(ident, M.REQ_CMD_NORMAL, cmd)
    assert r("denied", int(k.get_property(g, "Level"))) != 9
    k.set_property(g, "GMLevel", 1)
    wr.send(ident, M.REQ_CMD_NORMAL, cmd)
    assert r("level", int(k.get_property(g, "Level"))) == 9
    k.elements.add_element("Item", "gm_box", {"ItemType": 2})
    wr.send(ident, M.REQ_CMD_NORMAL, W.ReqCommand(command_id=1, command_str_value=b"gm_box",
                                                  command_value_int=3))
    assert r("box", w.pack.item_count(g, "gm_box")) == 3
    rec_sent(rig, wr, "sent")


def ch_pvp_match_and_ectype_wire(rig):
    w, wr = rig_world(rig)
    W, M, r, k = rig.P.wire, rig.P.msg.MsgID, rig.rec, w.kernel
    a_ident, a = wr.seat(1, "reda")
    b_ident, b = wr.seat(2, "blub")
    wr.send(a_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=1, score=100))
    assert not wr.acks(101, M.ACK_PVP_APPLY_MATCH)
    wr.send(b_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=1, score=120))
    got_a = wr.acks(101, M.ACK_PVP_APPLY_MATCH)
    assert got_a and wr.acks(102, M.ACK_PVP_APPLY_MATCH)
    _, ack = W.unwrap(got_a[-1], W.AckPVPApplyMatch)
    assert ack.nResult == 1 and ack.xRoomInfo is not None
    rec_sent(rig, wr, "matched")
    wr.send(a_ident, M.REQ_CREATE_PVP_ECTYPE, W.ReqCreatePVPEctype(xRoomInfo=ack.xRoomInfo))
    assert wr.acks(101, M.ACK_CREATE_PVP_ECTYPE) and wr.acks(102, M.ACK_CREATE_PVP_ECTYPE)
    ga = r("group", int(k.get_property(a, "GroupID")))
    assert ga == int(k.get_property(b, "GroupID")) and ga > 1
    n = len(wr.acks(101, M.ACK_CREATE_PVP_ECTYPE))
    wr.send(a_ident, M.REQ_CREATE_PVP_ECTYPE, W.ReqCreatePVPEctype(xRoomInfo=ack.xRoomInfo))
    assert len(wr.acks(101, M.ACK_CREATE_PVP_ECTYPE)) == n
    rec_sent(rig, wr, "sent")


def ch_pvp_mode_segmentation_and_room_protection(rig):
    w, wr = rig_world(rig)
    W, M = rig.P.wire, rig.P.msg.MsgID
    a_ident, a = wr.seat(1, "ma")
    b_ident, b = wr.seat(2, "mb")
    x_ident, x = wr.seat(3, "mx")
    wr.send(a_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=1, score=100))
    wr.send(b_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=2, score=100))
    assert not wr.acks(101, M.ACK_PVP_APPLY_MATCH)
    wr.send(x_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=1, score=105))
    got = wr.acks(101, M.ACK_PVP_APPLY_MATCH)
    assert got
    _, ack = W.unwrap(got[-1], W.AckPVPApplyMatch)
    rec_sent(rig, wr, "matched")
    wr.send(b_ident, M.REQ_CREATE_PVP_ECTYPE, W.ReqCreatePVPEctype(xRoomInfo=ack.xRoomInfo))
    assert not wr.acks(102, M.ACK_CREATE_PVP_ECTYPE)
    wr.send(a_ident, M.REQ_CREATE_PVP_ECTYPE, W.ReqCreatePVPEctype(xRoomInfo=ack.xRoomInfo))
    assert wr.acks(101, M.ACK_CREATE_PVP_ECTYPE)
    rec_sent(rig, wr, "sent")


def ch_gm_modify_property_sets_named_property(rig):
    w, wr = rig_world(rig)
    W, M, r, k = rig.P.wire, rig.P.msg.MsgID, rig.rec, w.kernel
    ident, g = wr.seat(1, "gm2")
    k.set_property(g, "GMLevel", 1)
    gold0 = int(k.get_property(g, "Gold"))
    cmd = W.ReqCommand(command_id=0, command_str_value=b"HP", command_value_int=55)
    wr.send(ident, M.REQ_CMD_NORMAL, cmd)
    assert r("hp", int(k.get_property(g, "HP"))) == 55
    assert r("gold", int(k.get_property(g, "Gold"))) == gold0
    wr.send(ident, M.REQ_CMD_NORMAL, cmd)
    assert r("hp", int(k.get_property(g, "HP"))) == 55
    rec_sent(rig, wr, "sent")


def ch_pvp_room_mode_is_the_pairs_not_the_requesters(rig):
    w, wr = rig_world(rig)
    W, M, r = rig.P.wire, rig.P.msg.MsgID, rig.rec
    a_ident, a = wr.seat(1, "wa")
    b_ident, b = wr.seat(2, "wb")
    c_ident, c = wr.seat(3, "wc")
    pvp = w.pvp
    pvp.window = 10
    wr.send(a_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=2, score=100))
    wr.send(b_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=2, score=150))
    assert not wr.acks(101, M.ACK_PVP_APPLY_MATCH)
    for t in pvp.queue:
        t.queued_at -= 10.0
    wr.send(c_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=1, score=100000))
    got_a = wr.acks(101, M.ACK_PVP_APPLY_MATCH)
    _, ack = W.unwrap(got_a[-1], W.AckPVPApplyMatch)
    assert r("mode", ack.xRoomInfo.nPVPMode) == 2
    pvp.leave_queue(c)
    wr.send(c_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=3, score=0))
    assert r("zero", [t.score for t in pvp.queue if t.player == c]) == [0]
    rec_sent(rig, wr, "sent")


def ch_pvp_despawn_cleans_queue_and_rooms(rig):
    w, wr = rig_world(rig)
    W, M, r = rig.P.wire, rig.P.msg.MsgID, rig.rec
    role, key = wr.role, rig.P.wire.ident_key
    a_ident, a = wr.seat(1, "da")
    b_ident, b = wr.seat(2, "db")
    pvp = w.pvp
    wr.send(a_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=1, score=100))
    assert r("queued", any(t.player == a for t in pvp.queue))
    role._despawn(role.sessions[key(a_ident)])
    assert not r("gone", any(t.player == a for t in pvp.queue))
    a2_ident, a2 = wr.seat(3, "da2")
    wr.send(a2_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=1, score=100))
    wr.send(b_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=1, score=110))
    assert r("room", len(role._pvp_rooms)) == 1
    role._despawn(role.sessions[key(b_ident)])
    assert r("dropped", len(role._pvp_rooms)) == 0
    rec_sent(rig, wr, "sent")


def ch_pvp_ectype_ack_self_id_is_per_recipient(rig):
    w, wr = rig_world(rig)
    W, M = rig.P.wire, rig.P.msg.MsgID
    a_ident, a = wr.seat(1, "ea")
    b_ident, b = wr.seat(2, "eb")
    wr.send(a_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=1, score=100))
    wr.send(b_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=1, score=100))
    _, ack = W.unwrap(wr.acks(101, M.ACK_PVP_APPLY_MATCH)[-1], W.AckPVPApplyMatch)
    wr.send(a_ident, M.REQ_CREATE_PVP_ECTYPE, W.ReqCreatePVPEctype(xRoomInfo=ack.xRoomInfo))
    for conn, g in ((101, a), (102, b)):
        _, e = W.unwrap(wr.acks(conn, M.ACK_CREATE_PVP_ECTYPE)[-1], W.AckCreatePVPEctype)
        want = rig.P.role.guid_ident(g)
        assert (e.self_id.svrid, e.self_id.index) == (want.svrid, want.index)
    rec_sent(rig, wr, "sent")


def ch_pvp_survivor_notified_and_reapply_switches_mode(rig):
    w, wr = rig_world(rig)
    W, M, r = rig.P.wire, rig.P.msg.MsgID, rig.rec
    role, key = wr.role, rig.P.wire.ident_key
    a_ident, a = wr.seat(1, "sa")
    b_ident, b = wr.seat(2, "sb")
    wr.send(a_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=1, score=100))
    wr.send(b_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=1, score=110))
    assert role._pvp_rooms
    n_before = len(wr.acks(101, M.ACK_PVP_APPLY_MATCH))
    role._despawn(role.sessions[key(b_ident)])
    got = wr.acks(101, M.ACK_PVP_APPLY_MATCH)
    assert len(got) == n_before + 1
    _, cancel = W.unwrap(got[-1], W.AckPVPApplyMatch)
    assert cancel.nResult == 0
    wr.send(a_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=1, score=50))
    wr.send(a_ident, M.REQ_PVP_APPLY_MATCH, W.ReqPVPApplyMatch(nPVPMode=2, score=70))
    assert r("switched", [(t.mode, t.score) for t in w.pvp.queue if t.player == a]) \
        == [(2, 70)]
    rec_sent(rig, wr, "sent")


def ch_sdk_set_fight_hero_bytes_drive_the_server(rig):
    w, wr = rig_world(rig)
    G, W, M, r = rig.P.game, rig.P.wire, rig.P.msg.MsgID, rig.rec
    w.kernel.elements.add_element("Item", "hero_mage", {"ItemType": int(G.ItemType.CARD),
                                                        "ATK_VALUE": 4})
    ident, g = wr.seat(1, "ann")
    row = r("hero", w.heroes.add_hero(g, "hero_mage"))
    cli = rig.P.client.GameClient("ann")
    captured = []

    class FakeConn:
        def send_msg(self, mid, body):
            captured.append((mid, bytes(body)))
            return True

    cli._conn = FakeConn()
    cli.set_fight_hero(row, fight_pos=1)
    (mid, body), = r("client bytes", captured)
    assert mid == int(M.REQ_SET_FIGHT_HERO)
    base = W.MsgBase.decode(body)
    wr.role.server.dispatch.feed([rig.P.transport.NetEvent(
        rig.P.transport.EV_MSG, 101, mid,
        W.MsgBase(player_id=ident, msg_data=base.msg_data).encode())])
    assert r("fight", w.heroes.fight_hero(g, 1)) == row
    rec_sent(rig, wr, "sent")


CASES = [ch_use_item_and_equip_handlers, ch_task_handlers,
         ch_team_handlers_create_join_kick_leave, ch_guild_handlers_create_join_search_leave,
         ch_use_item_targets_row_zero, ch_gm_command_wire, ch_pvp_match_and_ectype_wire,
         ch_pvp_mode_segmentation_and_room_protection,
         ch_gm_modify_property_sets_named_property,
         ch_pvp_room_mode_is_the_pairs_not_the_requesters,
         ch_pvp_despawn_cleans_queue_and_rooms, ch_pvp_ectype_ack_self_id_is_per_recipient,
         ch_pvp_survivor_notified_and_reapply_switches_mode,
         ch_sdk_set_fight_hero_bytes_drive_the_server]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[3:])
def test_client_handler_case(case):
    """tests/test_client_handlers.py's rig cases on both packages: equal
    answers, banks, module state and sends after every step."""
    run_both(case)


# -- the five-role cluster's default game world --------------------------------


def test_default_cluster_game_world_carries_the_middleware():
    """``LocalCluster``'s default game world follows ``GameRole()``'s, which
    is JAX's: the same module list, middleware included, in both packages
    (the cluster is built, not started)."""
    from test_torch_middleware import PKGS

    names = []
    for P in PKGS.values():
        c = P.roles.LocalCluster(backend="py", http_port=0, **P.kw)
        try:
            w = c.game.game_world
            assert w.config.middleware and w.guilds is not None and w.slg_shop is not None
            names.append([m.name for m in w.all_modules])
        finally:
            c.shut()
    assert names[0] == names[1]
