"""The port's client SDK against the JAX package's, byte for byte.

Every ``GameClient`` request method, the middleware families included,
must hand its connection the same (msg id, envelope) bytes in both
packages.  Then one server byte stream (every message family the SDK
mirrors: the handshake acks, entry and leave lists, the property and
record snapshots, per-change property and record sync, the columnar and
interest lanes, move, chat, skill, switch notices, frame traces and the
middleware acks) is fed to both SDKs, and the mirrors, ``chat_log``,
``moves``, ``skills`` and the kept acks must be equal; the frame-trace
echo must be equal with its receive stamp (wall clock) masked.
"""

from __future__ import annotations

import numpy as np
import pytest

import noahgameframe_tpu.client.sdk as jsdk
import noahgameframe_tpu.net.defines as jdefines
import noahgameframe_tpu.net.transport as jtransport
import noahgameframe_tpu.net.wire as jwire
import noahgameframe_tpu_torch.client.sdk as tsdk
import noahgameframe_tpu_torch.net.defines as tdefines
import noahgameframe_tpu_torch.net.transport as ttransport
import noahgameframe_tpu_torch.net.wire as twire
from noahgameframe_tpu_torch.net.defines import MsgID
from noahgameframe_tpu_torch.telemetry.pipeline import TraceContext, decode_trace, encode_trace

PKGS = {
    "jax": (jsdk, jwire, jtransport, jdefines),
    "port": (tsdk, twire, ttransport, tdefines),
}


class FakeConn:
    """A connection that records what the SDK sends and hands it a
    scripted list of events on its first poll."""

    def __init__(self, events=()):
        self.sent = []
        self.events = list(events)

    def send_msg(self, msg_id, body):
        self.sent.append((int(msg_id), bytes(body)))
        return True

    def poll(self):
        out, self.events = self.events, []
        return out

    def close(self):
        pass


def make_client(pkg, events=()):
    sdk, wire, _tr, _df = PKGS[pkg]
    c = sdk.GameClient("ada", "pw")
    c._conn = FakeConn(events)
    c.player_ident = wire.Ident(svrid=5, index=3)
    c.player_guid = wire.Ident(svrid=7_000_001, index=42)
    c.world_grant = wire.AckConnectWorldResult(world_key=b"k3y", world_port=4000,
                                               world_ip=b"127.0.0.1")
    return c


def _room(wire):
    return wire.PVPRoomInfo(RoomID=wire.Ident(svrid=3, index=9), nPVPMode=1,
                            xRedPlayer=[wire.Ident(svrid=1, index=2)])


# (method, args built from the package's wire module)
REQUESTS = [
    ("login", lambda w: ()),
    ("request_world_list", lambda w: ()),
    ("connect_world", lambda w: (7,)),
    ("verify_key", lambda w: ()),
    ("select_server", lambda w: (16,)),
    ("request_role_list", lambda w: (6,)),
    ("create_role", lambda w: ("Ada", 2, 6)),
    ("enter_game", lambda w: ("Ada", 6)),
    ("move_to", lambda w: (10.5, -3.25, 1.0)),
    ("use_item", lambda w: ("potion_small",)),
    ("use_item", lambda w: ("hero_card", 0)),
    ("wear_equip", lambda w: (3,)),
    ("take_off_equip", lambda w: (3,)),
    ("accept_task", lambda w: ("task_1",)),
    ("complete_task", lambda w: ("task_1",)),
    ("create_team", lambda w: ()),
    ("join_team", lambda w: (w.Ident(svrid=2, index=8),)),
    ("leave_team", lambda w: ()),
    ("opr_team_member", lambda w: (w.Ident(svrid=2, index=8), w.Ident(svrid=1, index=4), 2)),
    ("create_guild", lambda w: ("Owls",)),
    ("join_guild", lambda w: ("Owls",)),
    ("leave_guild", lambda w: ()),
    ("search_guild", lambda w: ("Ow",)),
    ("chat", lambda w: ("hello, world",)),
    ("use_skill", lambda w: (w.Ident(svrid=7_000_001, index=43), "skill_2")),
    ("slg_buy", lambda w: ("shop_1", 1.0, 2.0, 0.5)),
    ("slg_move", lambda w: (4, 3.0, 4.0)),
    ("slg_upgrade", lambda w: (4,)),
    ("slg_produce", lambda w: (4, "item_9", 3)),
    ("slg_operate", lambda w: (4, 2)),
    ("slg_collect", lambda w: (4, "Gold")),
    ("set_fight_hero", lambda w: (2, 1)),
    ("switch_server", lambda w: (16, 1, 2)),
    ("gm_command", lambda w: (0, "Gold", 500)),
    ("gm_command", lambda w: (3, "", 0)),
    ("pvp_apply_match", lambda w: (1, 1200)),
    ("pvp_apply_match", lambda w: ()),
    ("pvp_create_ectype", lambda w: (_room(w),)),
]


@pytest.mark.parametrize("method,args", REQUESTS,
                         ids=[f"{m}-{i}" for i, (m, _a) in enumerate(REQUESTS)])
def test_request_bytes_equal_jax(method, args):
    sent = {}
    for pkg in PKGS:
        c = make_client(pkg)
        getattr(c, method)(*args(PKGS[pkg][1]))
        sent[pkg] = c._conn.sent
    assert sent["port"] and sent["port"] == sent["jax"]


def test_pvp_create_ectype_defaults_to_last_match():
    """No room given: the most recent match's room (none: nothing sent)."""
    sent = {}
    for pkg in PKGS:
        _sdk, wire, _tr, _df = PKGS[pkg]
        c = make_client(pkg)
        c.pvp_create_ectype()
        assert c._conn.sent == []
        c.pvp_matches.append(wire.AckPVPApplyMatch(xRoomInfo=_room(wire)))
        c.pvp_create_ectype()
        sent[pkg] = c._conn.sent
    assert sent["port"] and sent["port"] == sent["jax"]


# ------------------------------------------------------------ server stream


def _i64(xs):
    return np.asarray(xs, np.int64).tobytes()


def server_stream(w):
    """One scripted server byte stream (the port's wire; the JAX wire is
    byte-equal) touching every handler the SDK installs."""
    me, other, npc = (w.Ident(svrid=7_000_001, index=42), w.Ident(svrid=7_000_001, index=43),
                      w.Ident(svrid=7_000_000, index=5))
    ok = lambda code, obj=None: w.AckEventResult(event_code=int(code), event_object=obj)  # noqa: E731
    from noahgameframe_tpu_torch.net.defines import EventCode, SwitchNoticeCode
    from noahgameframe_tpu_torch.net.wire_families import (ReqAckBuyObjectFormShop,
                                                            ReqAckMoveBuildObject)

    row = lambda r, **kw: w.RecordAddRowStruct(row=r, **kw)  # noqa: E731
    msgs = [
        (MsgID.ACK_LOGIN, ok(EventCode.ACCOUNT_SUCCESS, w.Ident())),
        (MsgID.ACK_WORLD_LIST, w.AckServerList(type=7, info=[
            w.ServerInfo(server_id=7, name=b"World1", wait_count=3, status=1)])),
        (MsgID.ACK_CONNECT_WORLD, w.AckConnectWorldResult(
            world_id=7, account=b"ada", world_ip=b"127.0.0.1", world_port=4242,
            world_key=b"0123abcd")),
        (MsgID.ACK_CONNECT_KEY, ok(EventCode.VERIFY_KEY_SUCCESS, w.Ident(svrid=5, index=3))),
        (MsgID.ACK_SELECT_SERVER, ok(EventCode.SELECTSERVER_SUCCESS)),
        (MsgID.ACK_ROLE_LIST, w.AckRoleLiteInfoList(char_data=[
            w.RoleLiteInfo(id=me, career=1, noob_name=b"Ada", game_id=6)])),
        (MsgID.ACK_ENTER_GAME, ok(EventCode.ENTER_GAME_SUCCESS, me)),
        (MsgID.ACK_OBJECT_ENTRY, w.AckPlayerEntryList(object_list=[
            w.PlayerEntryInfo(object_guid=g, x=1.0 + i, y=2.0, z=0.0, config_id=b"cfg",
                              scene_id=1, class_id=cls)
            for i, (g, cls) in enumerate(((me, b"Player"), (other, b"Player"), (npc, b"NPC")))])),
        (MsgID.ACK_OBJECT_PROPERTY_ENTRY, w.ObjectPropertyList(
            player_id=me,
            property_int_list=[w.PropertyInt(property_name=b"HP", data=120),
                               w.PropertyInt(property_name=b"Level", data=1)],
            property_float_list=[w.PropertyFloat(property_name=b"Speed", data=1.5)],
            property_string_list=[w.PropertyString(property_name=b"Name", data=b"Ada")],
            property_vector3_list=[w.PropertyVector3(property_name=b"Position",
                                                     data=w.Vector3(x=1.0, y=2.0, z=0.0)),
                                   w.PropertyVector3(property_name=b"Home")])),
        (MsgID.ACK_OBJECT_RECORD_ENTRY, w.ObjectRecordList(player_id=me, record_list=[
            w.ObjectRecordBase(record_name=b"BagItemList", row_struct=[
                row(0, record_string_list=[w.RecordString(row=0, col=0, data=b"potion")],
                    record_int_list=[w.RecordInt(row=0, col=1, data=3)]),
                row(1, record_float_list=[w.RecordFloat(row=1, col=2, data=0.25)],
                    record_object_list=[w.RecordObject(row=1, col=3, data=other)],
                    record_vector2_list=[w.RecordVector2(row=1, col=4,
                                                         data=w.Vector2(x=1.0, y=2.0))],
                    record_vector3_list=[w.RecordVector3(row=1, col=5)]),
            ])])),
        (MsgID.ACK_PROPERTY_INT, w.ObjectPropertyInt(player_id=me, property_list=[
            w.PropertyInt(property_name=b"HP", data=110)])),
        (MsgID.ACK_PROPERTY_FLOAT, w.ObjectPropertyFloat(player_id=other, property_list=[
            w.PropertyFloat(property_name=b"Speed", data=2.25)])),
        (MsgID.ACK_PROPERTY_STRING, w.ObjectPropertyString(player_id=other, property_list=[
            w.PropertyString(property_name=b"Name", data=b"B\xc3\xb8b")])),
        (MsgID.ACK_PROPERTY_OBJECT, w.ObjectPropertyObject(player_id=me, property_list=[
            w.PropertyObject(property_name=b"LastAttacker", data=npc),
            w.PropertyObject(property_name=b"Target")])),
        (MsgID.ACK_PROPERTY_VECTOR2, w.ObjectPropertyVector2(player_id=me, property_list=[
            w.PropertyVector2(property_name=b"Dir", data=w.Vector2(x=0.5, y=-0.5)),
            w.PropertyVector2(property_name=b"Dir0")])),
        (MsgID.ACK_PROPERTY_VECTOR3, w.ObjectPropertyVector3(player_id=other, property_list=[
            w.PropertyVector3(property_name=b"Position", data=w.Vector3(x=3.0, y=4.0, z=0.0))])),
        (MsgID.ACK_ADD_ROW, w.ObjectRecordAddRow(player_id=me, record_name=b"BagItemList",
                                                 row_data=[row(2, record_int_list=[
                                                     w.RecordInt(row=2, col=1, data=9)])])),
        (MsgID.ACK_RECORD_INT, w.ObjectRecordInt(player_id=me, record_name=b"BagItemList",
                                                 property_list=[w.RecordInt(row=0, col=1,
                                                                            data=5)])),
        (MsgID.ACK_RECORD_FLOAT, w.ObjectRecordFloat(player_id=me, record_name=b"BagItemList",
                                                     property_list=[w.RecordFloat(
                                                         row=1, col=2, data=0.75)])),
        (MsgID.ACK_RECORD_STRING, w.ObjectRecordString(player_id=me, record_name=b"BagItemList",
                                                       property_list=[w.RecordString(
                                                           row=2, col=0, data=b"elixir")])),
        (MsgID.ACK_RECORD_OBJECT, w.ObjectRecordObject(player_id=me, record_name=b"BagItemList",
                                                       property_list=[w.RecordObject(
                                                           row=2, col=3, data=me)])),
        (MsgID.ACK_RECORD_VECTOR3, w.ObjectRecordVector3(player_id=me, record_name=b"BagItemList",
                                                         property_list=[w.RecordVector3(
                                                             row=2, col=5,
                                                             data=w.Vector3(x=7.0))])),
        (MsgID.ACK_SWAP_ROW, w.ObjectRecordSwap(player_id=me, origin_record_name=b"BagItemList",
                                                row_origin=0, row_target=2)),
        (MsgID.ACK_REMOVE_ROW, w.ObjectRecordRemove(player_id=me, record_name=b"BagItemList",
                                                    remove_row=[1])),
        (MsgID.ACK_BATCH_PROPERTY, w.BatchPropertySync(
            class_name=b"NPC", property_name=b"HP", ptype=1, count=2,
            svrid=_i64([7_000_000, 7_000_000]), index=_i64([5, 6]),
            data=np.asarray([77, 88], np.int32).tobytes())),
        (MsgID.ACK_BATCH_PROPERTY, w.BatchPropertySync(
            class_name=b"NPC", property_name=b"Speed", ptype=2, count=1,
            svrid=_i64([7_000_000]), index=_i64([5]),
            data=np.asarray([0.5], np.float32).tobytes())),
        (MsgID.ACK_BATCH_PROPERTY, w.BatchPropertySync(
            class_name=b"NPC", property_name=b"Position", ptype=6, count=2,
            svrid=_i64([7_000_000, 7_000_000]), index=_i64([5, 6]),
            data=np.asarray([1, 2, 3, 4, 5, 6], np.float32).tobytes())),
        (MsgID.ACK_BATCH_PROPERTY, w.BatchPropertySync(
            class_name=b"NPC", property_name=b"Dir", ptype=5, count=1,
            svrid=_i64([7_000_000]), index=_i64([6]),
            data=np.asarray([0.5, 0.25, 0.0], np.float32).tobytes())),
        (MsgID.ACK_INTEREST_POS, w.InterestPosSync(
            scale=0.03125, count=2, svrid=_i64([7_000_000, 7_000_000]), index=_i64([7, 8]),
            qpos=np.asarray([10, 20, 0, 30, 40, 0], np.uint16).tobytes(),
            gone_svrid=_i64([7_000_000]), gone_index=_i64([6]))),
        (MsgID.ACK_MOVE, w.ReqAckPlayerMove(mover=other, target_pos=[
            w.Position(x=10.0, y=20.0, z=0.0)])),
        (MsgID.ACK_CHAT, w.ReqAckPlayerChat(chat_id=other, chat_info=b"hello")),
        (MsgID.ACK_CHAT, w.ReqAckPlayerChat(chat_info=b"anon")),
        (MsgID.ACK_SKILL_OBJECTX, w.ReqAckUseSkill(user=other, skill_id=b"skill_1",
                                                   effect_data=[w.EffectData(
                                                       effect_ident=me, effect_value=10)])),
        (MsgID.ACK_OBJECT_LEAVE, w.AckPlayerLeaveList(object_list=[npc])),
        (MsgID.ACK_ITEM_OBJECT, w.ReqAckUseItem(item=w.ItemStruct(item_id=b"potion",
                                                                   item_count=1))),
        (MsgID.ACK_CREATE_TEAM, w.ReqAckCreateTeam(team_id=w.Ident(svrid=2, index=8))),
        (MsgID.ACK_JOIN_TEAM, w.ReqAckJoinTeam(team_id=w.Ident(svrid=2, index=8))),
        (MsgID.ACK_LEAVE_TEAM, w.ReqAckLeaveTeam(team_id=w.Ident(svrid=2, index=8))),
        (MsgID.ACK_OPRMEMBER_TEAM, w.ReqAckOprTeamMember(team_id=w.Ident(svrid=2, index=8),
                                                        member_id=other, type=2)),
        (MsgID.ACK_CREATE_GUILD, w.ReqAckCreateGuild(guild_name=b"Owls")),
        (MsgID.ACK_JOIN_GUILD, w.ReqAckJoinGuild(guild_name=b"Owls")),
        (MsgID.ACK_LEAVE_GUILD, w.ReqAckLeaveGuild()),
        (MsgID.ACK_SEARCH_GUILD, w.AckSearchGuild(guild_list=[w.SearchGuildObject(
            guild_ID=w.Ident(svrid=4, index=1), guild_name=b"Owls", guild_member_count=3)])),
        (MsgID.ACK_BUY_FORM_SHOP, ReqAckBuyObjectFormShop(config_id=b"shop_1", x=1.0)),
        (MsgID.ACK_MOVE_BUILD_OBJECT, ReqAckMoveBuildObject(row=4, x=3.0, y=4.0)),
        (MsgID.ACK_PVP_APPLY_MATCH, w.AckPVPApplyMatch(self_id=me, xRoomInfo=_room(w))),
        (MsgID.ACK_CREATE_PVP_ECTYPE, w.AckCreatePVPEctype(self_id=me, xRoomInfo=_room(w))),
        (MsgID.ACK_SWITCH_NOTICE, w.SwitchNotice(code=int(SwitchNoticeCode.REHOMING),
                                                 target_serverid=6, retry_after_ms=500)),
        (MsgID.ACK_ENTER_GAME, ok(EventCode.ENTER_GAME_SUCCESS + 1)),
    ]
    out = [(int(m), w.wrap(msg, player_id=me)) for m, msg in msgs]
    trace = TraceContext(tick=12, game_id=6, seq=3, t_encode_ns=1000, proxy_in_ns=1500,
                         proxy_out_ns=1700)
    out.append((int(MsgID.FRAME_TRACE), w.MsgBase(msg_data=encode_trace(trace)).encode()))
    out.append((int(MsgID.FRAME_TRACE), w.MsgBase(msg_data=b"torn").encode()))
    return out


def _norm(v):
    if hasattr(v, "svrid"):
        return ("ident", v.svrid, v.index)
    if isinstance(v, (list, tuple)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if hasattr(v, "encode") and hasattr(v, "FIELDS"):
        return (type(v).__name__, v.encode())
    return v


def _view(c):
    objs = {k: (_norm(o.ident), o.class_id, o.config_id, o.scene_id, _norm(o.position),
                _norm(o.properties), _norm(o.records)) for k, o in c.objects.items()}
    kept = {n: _norm(getattr(c, n)) for n in (
        "chat_log", "moves", "skills", "item_acks", "team_acks", "guild_acks", "guild_search",
        "slg_acks", "pvp_matches", "pvp_ectypes", "switch_notices", "traces", "worlds", "roles")}
    state = (c.logged_in, _norm(c.world_grant), c.key_verified, c.server_selected,
             _norm(c.player_ident), _norm(c.player_guid), c.entered, c.last_enter_code)
    return objs, kept, state


def test_server_stream_gives_equal_mirrors():
    stream = server_stream(twire)
    views, echoes = {}, {}
    for pkg in PKGS:
        _sdk, _wire, tr, _df = PKGS[pkg]
        events = [tr.NetEvent(tr.EV_CONNECTED, 0)] + [
            tr.NetEvent(tr.EV_MSG, 0, m, b) for m, b in stream]
        c = make_client(pkg, events)
        c.player_guid = None
        c.execute()
        assert c.connected
        views[pkg] = _view(c)
        echo = []
        for mid, body in c._conn.sent:
            base = twire.MsgBase.decode(body)
            ctx = decode_trace(base.msg_data)
            assert ctx.client_recv_ns > 0  # stamped on receipt
            ctx.client_recv_ns = 0  # wall clock: masked
            echo.append((mid, encode_trace(ctx)))
        echoes[pkg] = echo
    port, jax_ = views["port"], views["jax"]
    assert port[0] == jax_[0]
    assert port[1] == jax_[1]
    assert port[2] == jax_[2]
    assert echoes["port"] == echoes["jax"] and len(echoes["port"]) == 1
    objs = port[0]
    # me, the other player and the two interest entities: the leave list
    # despawned NPC 5, the interest stream's gone list NPC 6
    assert sorted(objs) == [(7_000_000, 7), (7_000_000, 8), (7_000_001, 42), (7_000_001, 43)]
    assert port[1]["chat_log"] == (("7000001-43", "hello"), ("?", "anon"))
    # the refused second enter keeps the first success and records its code
    from noahgameframe_tpu_torch.net.defines import EventCode
    assert port[2][-2] is True and port[2][-1] == int(EventCode.ENTER_GAME_SUCCESS) + 1
