"""Python client SDK mirroring the reference Unity3D/Cocos clients.

Reference: `NFClient/Unity3D` — the C# SDK drives the login → select-world
→ connect-key → select-server → role → enter-game pipeline and keeps a
local mirror of every synced object by decoding the property/record sync
messages (SURVEY §2.10 L12).  This is the same state machine in Python:
pump-driven (call ``execute()`` from your loop), every received payload is
a MsgBase envelope (the proxy transponds envelopes verbatim).

Used by the integration tests as the "player" end of the five-role
cluster, and usable as a bot/load-test client against a real deployment.

A copy of ``noahgameframe_tpu/client/sdk.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Dict, List, Optional, Tuple

from ..telemetry.pipeline import TraceError, decode_trace, encode_trace
from ..net.defines import EventCode, MsgID
from ..net.transport import EV_CONNECTED, EV_DISCONNECTED, EV_MSG, PyNetClient
from ..net.wire import (
    AckConnectWorldResult,
    AckEventResult,
    AckPlayerEntryList,
    AckPlayerLeaveList,
    AckRoleLiteInfoList,
    AckServerList,
    Ident,
    Message,
    MsgBase,
    ObjectPropertyFloat,
    ObjectPropertyInt,
    ObjectPropertyList,
    ObjectPropertyObject,
    ObjectPropertyString,
    ObjectPropertyVector2,
    ObjectPropertyVector3,
    ObjectRecordAddRow,
    ObjectRecordFloat,
    ObjectRecordInt,
    ObjectRecordList,
    ObjectRecordObject,
    ObjectRecordRemove,
    ObjectRecordString,
    ObjectRecordSwap,
    ObjectRecordVector3,
    Position,
    ReqAcceptTask,
    ReqAccountLogin,
    ReqAckCreateGuild,
    ReqAckCreateTeam,
    ReqAckJoinGuild,
    ReqAckJoinTeam,
    ReqAckLeaveGuild,
    ReqAckLeaveTeam,
    ReqAckOprTeamMember,
    ReqAckPlayerChat,
    ReqAckPlayerMove,
    ReqAckUseItem,
    ReqAckUseSkill,
    ReqCompeleteTask,
    ReqConnectWorld,
    ReqCreateRole,
    ReqEnterGameServer,
    ReqRoleList,
    ReqSearchGuild,
    ReqSelectServer,
    ReqWearEquip,
    AckSearchGuild,
    ItemStruct,
    RoleLiteInfo,
    TakeOffEquip,
    ident_key as _key,
    unwrap,
    wrap,
)

_IdentKey = Tuple[int, int]


@dataclasses.dataclass
class MirrorObject:
    """Client-side replica of one synced entity."""

    ident: Ident
    class_id: str = ""
    config_id: str = ""
    scene_id: int = 0
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    properties: Dict[str, object] = dataclasses.field(default_factory=dict)
    records: Dict[str, Dict[Tuple[int, int], object]] = dataclasses.field(
        default_factory=dict
    )


class GameClient:
    """One player's connection state machine + world mirror."""

    def __init__(self, account: str, password: str = "") -> None:
        self.account = account
        self.password = password
        self._conn: Optional[PyNetClient] = None
        self.connected = False
        # handshake state
        self.logged_in = False
        self.worlds: List = []
        self.world_grant: Optional[AckConnectWorldResult] = None
        self.key_verified = False
        self.server_selected = False
        self.roles: List[RoleLiteInfo] = []
        self.player_ident: Optional[Ident] = None  # proxy-assigned client id
        self.player_guid: Optional[Ident] = None  # game-side avatar guid
        self.entered = False
        self.last_enter_code: Optional[int] = None  # refusal visibility
        # the world mirror
        self.objects: Dict[_IdentKey, MirrorObject] = {}
        self.chat_log: List[Tuple[str, str]] = []
        self.moves: List[ReqAckPlayerMove] = []
        self.skills: List[ReqAckUseSkill] = []
        self.item_acks: list = []
        self.team_acks: list = []
        self.guild_acks: list = []
        self.guild_search: list = []
        self.slg_acks: list = []
        self.pvp_matches: list = []   # AckPVPApplyMatch (room assignments)
        self.pvp_ectypes: list = []   # AckCreatePVPEctype (instance grants)
        # frame observatory: received trace sidecars (bounded), acked back
        self.traces: List[dict] = []
        # session failover: proxy control notices — REHOMING
        # while a crashed binding re-homes, BUSY with a retry hint when
        # no survivor has capacity, DROPPED when parked frames were lost
        self.switch_notices: list = []
        self._handlers: Dict[int, Callable[[MsgBase], None]] = {}
        self._install()

    # ------------------------------------------------------------- wiring
    def _install(self) -> None:
        h = self._handlers
        h[int(MsgID.ACK_LOGIN)] = self._on_login
        h[int(MsgID.ACK_WORLD_LIST)] = self._on_world_list
        h[int(MsgID.ACK_CONNECT_WORLD)] = self._on_connect_world
        h[int(MsgID.ACK_CONNECT_KEY)] = self._on_connect_key
        h[int(MsgID.ACK_SELECT_SERVER)] = self._on_select_server
        h[int(MsgID.ACK_ROLE_LIST)] = self._on_role_list
        h[int(MsgID.ACK_ENTER_GAME)] = self._on_enter_game
        h[int(MsgID.ACK_OBJECT_ENTRY)] = self._on_object_entry
        h[int(MsgID.ACK_OBJECT_LEAVE)] = self._on_object_leave
        h[int(MsgID.ACK_OBJECT_PROPERTY_ENTRY)] = self._on_property_list
        h[int(MsgID.ACK_OBJECT_RECORD_ENTRY)] = self._on_record_list
        h[int(MsgID.ACK_PROPERTY_INT)] = self._on_property_int
        h[int(MsgID.ACK_PROPERTY_FLOAT)] = self._on_property_float
        h[int(MsgID.ACK_PROPERTY_STRING)] = self._on_property_string
        h[int(MsgID.ACK_PROPERTY_OBJECT)] = self._on_property_object
        h[int(MsgID.ACK_PROPERTY_VECTOR2)] = self._on_property_vector2
        h[int(MsgID.ACK_PROPERTY_VECTOR3)] = self._on_property_vector3
        h[int(MsgID.ACK_ADD_ROW)] = self._on_record_add_row
        h[int(MsgID.ACK_REMOVE_ROW)] = self._on_record_remove
        h[int(MsgID.ACK_SWAP_ROW)] = self._on_record_swap
        h[int(MsgID.ACK_RECORD_INT)] = self._on_record_int
        h[int(MsgID.ACK_RECORD_FLOAT)] = self._on_record_float
        h[int(MsgID.ACK_RECORD_STRING)] = self._on_record_string
        h[int(MsgID.ACK_RECORD_OBJECT)] = self._on_record_object
        h[int(MsgID.ACK_RECORD_VECTOR3)] = self._on_record_vector3
        h[int(MsgID.ACK_BATCH_PROPERTY)] = self._on_batch_property
        h[int(MsgID.ACK_INTEREST_POS)] = self._on_interest_pos
        h[int(MsgID.ACK_MOVE)] = self._on_move
        h[int(MsgID.ACK_CHAT)] = self._on_chat
        h[int(MsgID.ACK_SKILL_OBJECTX)] = self._on_skill
        h[int(MsgID.FRAME_TRACE)] = self._on_frame_trace
        # middleware acks: stored raw-decoded for callers to inspect
        def keep(store: list, cls):
            def on(base: MsgBase) -> None:
                store.append(cls.decode(base.msg_data))
            return on

        h[int(MsgID.ACK_ITEM_OBJECT)] = keep(self.item_acks, ReqAckUseItem)
        h[int(MsgID.ACK_CREATE_TEAM)] = keep(self.team_acks, ReqAckCreateTeam)
        h[int(MsgID.ACK_JOIN_TEAM)] = keep(self.team_acks, ReqAckJoinTeam)
        h[int(MsgID.ACK_LEAVE_TEAM)] = keep(self.team_acks, ReqAckLeaveTeam)
        h[int(MsgID.ACK_OPRMEMBER_TEAM)] = keep(self.team_acks,
                                                ReqAckOprTeamMember)
        h[int(MsgID.ACK_CREATE_GUILD)] = keep(self.guild_acks,
                                              ReqAckCreateGuild)
        h[int(MsgID.ACK_JOIN_GUILD)] = keep(self.guild_acks, ReqAckJoinGuild)
        h[int(MsgID.ACK_LEAVE_GUILD)] = keep(self.guild_acks,
                                             ReqAckLeaveGuild)
        h[int(MsgID.ACK_SEARCH_GUILD)] = keep(self.guild_search,
                                              AckSearchGuild)
        from ..net.wire import AckCreatePVPEctype, AckPVPApplyMatch
        from ..net.wire_families import (
            ReqAckBuyObjectFormShop,
            ReqAckMoveBuildObject,
        )

        h[int(MsgID.ACK_BUY_FORM_SHOP)] = keep(self.slg_acks,
                                               ReqAckBuyObjectFormShop)
        h[int(MsgID.ACK_MOVE_BUILD_OBJECT)] = keep(self.slg_acks,
                                                   ReqAckMoveBuildObject)
        h[int(MsgID.ACK_PVP_APPLY_MATCH)] = keep(self.pvp_matches,
                                                 AckPVPApplyMatch)
        h[int(MsgID.ACK_CREATE_PVP_ECTYPE)] = keep(self.pvp_ectypes,
                                                   AckCreatePVPEctype)
        from ..net.wire import SwitchNotice

        h[int(MsgID.ACK_SWITCH_NOTICE)] = keep(self.switch_notices,
                                               SwitchNotice)

    def connect(self, host: str, port: int) -> None:
        """Dial an endpoint (login first, later the granted proxy)."""
        if self._conn is not None:
            self._conn.close()
        self.connected = False
        self._conn = PyNetClient(host, port)
        self._conn.connect()

    def execute(self) -> None:
        if self._conn is None:
            return
        for ev in self._conn.poll():
            if ev.kind == EV_CONNECTED:
                self.connected = True
            elif ev.kind == EV_DISCONNECTED:
                self.connected = False
            elif ev.kind == EV_MSG:
                base = MsgBase.decode(ev.body)
                fn = self._handlers.get(ev.msg_id)
                if fn is not None:
                    fn(base)

    def _send(self, msg_id: int, msg: Message) -> bool:
        return self._conn is not None and self._conn.send_msg(
            int(msg_id), wrap(msg)
        )

    def _on_frame_trace(self, base: MsgBase) -> None:
        """Frame-observatory sidecar: stamp receipt, keep a bounded local
        log, and echo the header back — the ack rides the normal
        client→proxy→game path so the game measures a true round trip."""
        try:
            ctx = decode_trace(base.msg_data)
        except TraceError:
            return
        ctx.client_recv_ns = _time.perf_counter_ns()
        self.traces.append({
            "tick": ctx.tick,
            "game_id": ctx.game_id,
            "seq": ctx.seq,
            "proxy_relay_ms": (
                (ctx.proxy_out_ns - ctx.proxy_in_ns) / 1e6
                if ctx.proxy_out_ns and ctx.proxy_in_ns else None
            ),
        })
        del self.traces[:-256]
        if self._conn is not None:
            self._conn.send_msg(
                int(MsgID.FRAME_TRACE_ACK),
                MsgBase(msg_data=encode_trace(ctx)).encode(),
            )

    # ------------------------------------------------------------- login flow
    def login(self) -> None:
        self._send(
            MsgID.REQ_LOGIN,
            ReqAccountLogin(
                account=self.account.encode(), password=self.password.encode()
            ),
        )

    def _on_login(self, base: MsgBase) -> None:
        ack = AckEventResult.decode(base.msg_data)
        self.logged_in = int(ack.event_code) == int(EventCode.ACCOUNT_SUCCESS)

    def request_world_list(self) -> None:
        from ..net.wire import ReqServerList
        from ..net.defines import ServerType

        self._send(
            MsgID.REQ_WORLD_LIST, ReqServerList(type=int(ServerType.WORLD))
        )

    def _on_world_list(self, base: MsgBase) -> None:
        self.worlds = list(AckServerList.decode(base.msg_data).info)

    def connect_world(self, world_id: int) -> None:
        self._send(MsgID.REQ_CONNECT_WORLD, ReqConnectWorld(world_id=world_id))

    def _on_connect_world(self, base: MsgBase) -> None:
        self.world_grant = AckConnectWorldResult.decode(base.msg_data)

    # ------------------------------------------------------------- proxy flow
    def connect_proxy(self) -> None:
        """Dial the granted proxy and present the connect key."""
        g = self.world_grant
        if g is None:
            raise RuntimeError("no world grant yet")
        self.connect(g.world_ip.decode(), g.world_port)

    def verify_key(self) -> None:
        g = self.world_grant
        self._send(
            MsgID.REQ_CONNECT_KEY,
            ReqAccountLogin(
                account=self.account.encode(), security_code=g.world_key
            ),
        )

    def _on_connect_key(self, base: MsgBase) -> None:
        ack = AckEventResult.decode(base.msg_data)
        if int(ack.event_code) == int(EventCode.VERIFY_KEY_SUCCESS):
            self.key_verified = True
            self.player_ident = ack.event_object

    def select_server(self, game_id: int) -> None:
        self._send(MsgID.REQ_SELECT_SERVER, ReqSelectServer(world_id=game_id))

    def _on_select_server(self, base: MsgBase) -> None:
        ack = AckEventResult.decode(base.msg_data)
        self.server_selected = int(ack.event_code) == int(
            EventCode.SELECTSERVER_SUCCESS
        )

    # ------------------------------------------------------------- role flow
    def request_role_list(self, game_id: int = 0) -> None:
        self._send(
            MsgID.REQ_ROLE_LIST,
            ReqRoleList(game_id=game_id, account=self.account.encode()),
        )

    def create_role(self, name: str, career: int = 0, game_id: int = 0) -> None:
        self._send(
            MsgID.REQ_CREATE_ROLE,
            ReqCreateRole(
                account=self.account.encode(),
                noob_name=name.encode(),
                career=career,
                game_id=game_id,
            ),
        )

    def _on_role_list(self, base: MsgBase) -> None:
        self.roles = list(AckRoleLiteInfoList.decode(base.msg_data).char_data)

    def enter_game(self, name: str, game_id: int = 0) -> None:
        self._send(
            MsgID.REQ_ENTER_GAME,
            ReqEnterGameServer(
                id=self.player_ident,
                account=self.account.encode(),
                name=name.encode(),
                game_id=game_id,
            ),
        )

    def _on_enter_game(self, base: MsgBase) -> None:
        ack = AckEventResult.decode(base.msg_data)
        self.last_enter_code = int(ack.event_code)
        if int(ack.event_code) == int(EventCode.ENTER_GAME_SUCCESS):
            self.entered = True
            self.player_guid = ack.event_object

    # ------------------------------------------------------------- mirror
    def _obj(self, ident: Optional[Ident]) -> MirrorObject:
        k = _key(ident)
        if k not in self.objects:
            self.objects[k] = MirrorObject(ident=ident or Ident())
        return self.objects[k]

    def _on_object_entry(self, base: MsgBase) -> None:
        for e in AckPlayerEntryList.decode(base.msg_data).object_list:
            o = self._obj(e.object_guid)
            o.class_id = e.class_id.decode("utf-8", "replace")
            o.config_id = e.config_id.decode("utf-8", "replace")
            o.scene_id = e.scene_id
            o.position = (e.x, e.y, e.z)

    def _on_object_leave(self, base: MsgBase) -> None:
        for ident in AckPlayerLeaveList.decode(base.msg_data).object_list:
            self.objects.pop(_key(ident), None)

    def _on_property_list(self, base: MsgBase) -> None:
        pl = ObjectPropertyList.decode(base.msg_data)
        o = self._obj(pl.player_id)
        for p in pl.property_int_list:
            o.properties[p.property_name.decode()] = int(p.data)
        for p in pl.property_float_list:
            o.properties[p.property_name.decode()] = float(p.data)
        for p in pl.property_string_list:
            o.properties[p.property_name.decode()] = p.data.decode("utf-8", "replace")
        for p in pl.property_vector3_list:
            v = p.data
            o.properties[p.property_name.decode()] = (
                (v.x, v.y, v.z) if v is not None else (0.0, 0.0, 0.0)
            )

    def _on_property_int(self, base: MsgBase) -> None:
        pl = ObjectPropertyInt.decode(base.msg_data)
        o = self._obj(pl.player_id)
        for p in pl.property_list:
            o.properties[p.property_name.decode()] = int(p.data)

    def _on_property_float(self, base: MsgBase) -> None:
        pl = ObjectPropertyFloat.decode(base.msg_data)
        o = self._obj(pl.player_id)
        for p in pl.property_list:
            o.properties[p.property_name.decode()] = float(p.data)

    def _on_property_string(self, base: MsgBase) -> None:
        pl = ObjectPropertyString.decode(base.msg_data)
        o = self._obj(pl.player_id)
        for p in pl.property_list:
            o.properties[p.property_name.decode()] = p.data.decode(
                "utf-8", "replace"
            )

    def _on_property_object(self, base: MsgBase) -> None:
        pl = ObjectPropertyObject.decode(base.msg_data)
        o = self._obj(pl.player_id)
        for p in pl.property_list:
            o.properties[p.property_name.decode()] = self._ident_tuple(p.data)

    def _on_property_vector2(self, base: MsgBase) -> None:
        pl = ObjectPropertyVector2.decode(base.msg_data)
        o = self._obj(pl.player_id)
        for p in pl.property_list:
            v = p.data
            o.properties[p.property_name.decode()] = (
                (v.x, v.y) if v is not None else (0.0, 0.0)
            )

    def _on_property_vector3(self, base: MsgBase) -> None:
        pl = ObjectPropertyVector3.decode(base.msg_data)
        o = self._obj(pl.player_id)
        for p in pl.property_list:
            v = p.data
            o.properties[p.property_name.decode()] = (
                (v.x, v.y, v.z) if v is not None else (0.0, 0.0, 0.0)
            )

    @staticmethod
    def _ident_tuple(i: Optional[Ident]) -> Tuple[int, int]:
        return (i.svrid, i.index) if i is not None else (0, 0)

    def _absorb_row_struct(self, cells: Dict, rowmsg) -> None:
        """Fold one RecordAddRowStruct's cells (every column type) into a
        mirror record."""
        for c in rowmsg.record_int_list:
            cells[(c.row, c.col)] = int(c.data)
        for c in rowmsg.record_float_list:
            cells[(c.row, c.col)] = float(c.data)
        for c in rowmsg.record_string_list:
            cells[(c.row, c.col)] = c.data.decode("utf-8", "replace")
        for c in rowmsg.record_object_list:
            cells[(c.row, c.col)] = self._ident_tuple(c.data)
        for c in rowmsg.record_vector2_list:
            v = c.data
            cells[(c.row, c.col)] = (v.x, v.y) if v is not None else (0.0, 0.0)
        for c in rowmsg.record_vector3_list:
            v = c.data
            cells[(c.row, c.col)] = (
                (v.x, v.y, v.z) if v is not None else (0.0, 0.0, 0.0)
            )

    def _on_record_list(self, base: MsgBase) -> None:
        rl = ObjectRecordList.decode(base.msg_data)
        o = self._obj(rl.player_id)
        for rec in rl.record_list:
            cells = o.records.setdefault(rec.record_name.decode(), {})
            for rowmsg in rec.row_struct:
                self._absorb_row_struct(cells, rowmsg)

    # ------------------------------------------------- per-change record sync
    def _rec_cells(self, base_pid: Optional[Ident], record_name: bytes) -> Dict:
        o = self._obj(base_pid)
        return o.records.setdefault(record_name.decode(), {})

    def _on_record_add_row(self, base: MsgBase) -> None:
        msg = ObjectRecordAddRow.decode(base.msg_data)
        cells = self._rec_cells(msg.player_id, msg.record_name)
        for rowmsg in msg.row_data:
            self._absorb_row_struct(cells, rowmsg)

    def _on_record_remove(self, base: MsgBase) -> None:
        msg = ObjectRecordRemove.decode(base.msg_data)
        cells = self._rec_cells(msg.player_id, msg.record_name)
        gone = set(msg.remove_row)
        for key in [k for k in cells if k[0] in gone]:
            del cells[key]

    def _on_record_swap(self, base: MsgBase) -> None:
        msg = ObjectRecordSwap.decode(base.msg_data)
        cells = self._rec_cells(msg.player_id, msg.origin_record_name)
        a, b = msg.row_origin, msg.row_target
        moved = {}
        for (r, c) in list(cells):
            if r == a:
                moved[(b, c)] = cells.pop((r, c))
            elif r == b:
                moved[(a, c)] = cells.pop((r, c))
        cells.update(moved)

    def _on_record_int(self, base: MsgBase) -> None:
        msg = ObjectRecordInt.decode(base.msg_data)
        cells = self._rec_cells(msg.player_id, msg.record_name)
        for c in msg.property_list:
            cells[(c.row, c.col)] = int(c.data)

    def _on_record_float(self, base: MsgBase) -> None:
        msg = ObjectRecordFloat.decode(base.msg_data)
        cells = self._rec_cells(msg.player_id, msg.record_name)
        for c in msg.property_list:
            cells[(c.row, c.col)] = float(c.data)

    def _on_record_string(self, base: MsgBase) -> None:
        msg = ObjectRecordString.decode(base.msg_data)
        cells = self._rec_cells(msg.player_id, msg.record_name)
        for c in msg.property_list:
            cells[(c.row, c.col)] = c.data.decode("utf-8", "replace")

    def _on_record_object(self, base: MsgBase) -> None:
        msg = ObjectRecordObject.decode(base.msg_data)
        cells = self._rec_cells(msg.player_id, msg.record_name)
        for c in msg.property_list:
            cells[(c.row, c.col)] = self._ident_tuple(c.data)

    def _on_record_vector3(self, base: MsgBase) -> None:
        msg = ObjectRecordVector3.decode(base.msg_data)
        cells = self._rec_cells(msg.player_id, msg.record_name)
        for c in msg.property_list:
            v = c.data
            cells[(c.row, c.col)] = (
                (v.x, v.y, v.z) if v is not None else (0.0, 0.0, 0.0)
            )

    def _on_batch_property(self, base: MsgBase) -> None:
        """Columnar batch sync (TPU-native extension): unpack the arrays
        and fold each entity's value into the mirror."""
        import numpy as np

        from ..net.wire import BatchPropertySync

        msg = BatchPropertySync.decode(base.msg_data)
        heads = np.frombuffer(msg.svrid, np.int64)
        datas = np.frombuffer(msg.index, np.int64)
        name = msg.property_name.decode()
        t = msg.ptype
        if t == 5 or t == 6:  # VECTOR2 / VECTOR3 ride as float32[n*3]
            vals = np.frombuffer(msg.data, np.float32).reshape(-1, 3)
            vals = [
                (float(v[0]), float(v[1])) if t == 5
                else (float(v[0]), float(v[1]), float(v[2]))
                for v in vals
            ]
        elif t == 2:  # FLOAT
            vals = [float(v) for v in np.frombuffer(msg.data, np.float32)]
        else:  # INT
            vals = [int(v) for v in np.frombuffer(msg.data, np.int32)]
        for h_, d_, v in zip(heads.tolist(), datas.tolist(), vals):
            o = self._obj(Ident(svrid=h_, index=d_))
            o.properties[name] = v
            if name == "Position":
                o.position = v if len(v) == 3 else (*v, 0.0)

    def _on_interest_pos(self, base: MsgBase) -> None:
        """Per-session interest stream: u16-quantized positions of the
        entities near this client's avatar; scale rides the message."""
        import numpy as np

        from ..net.wire import InterestPosSync

        msg = InterestPosSync.decode(base.msg_data)
        heads = np.frombuffer(msg.svrid, np.int64)
        datas = np.frombuffer(msg.index, np.int64)
        qpos = np.frombuffer(msg.qpos, np.uint16).reshape(-1, 3)
        s = float(msg.scale)
        for h_, d_, qp in zip(heads.tolist(), datas.tolist(), qpos.tolist()):
            o = self._obj(Ident(svrid=h_, index=d_))
            pos = (qp[0] * s, qp[1] * s, qp[2] * s)
            o.properties["Position"] = pos
            o.position = pos
        # the stream is a delta: entities that left this client's view
        # arrive in the gone list and are despawned from the mirror
        for h_, d_ in zip(
            np.frombuffer(msg.gone_svrid, np.int64).tolist(),
            np.frombuffer(msg.gone_index, np.int64).tolist(),
        ):
            self.objects.pop(_key(Ident(svrid=h_, index=d_)), None)

    # ------------------------------------------------------------- gameplay
    def move_to(self, x: float, y: float, z: float = 0.0) -> None:
        self._send(
            MsgID.REQ_MOVE,
            ReqAckPlayerMove(
                mover=self.player_guid,
                target_pos=[Position(x=x, y=y, z=z)],
            ),
        )

    def _on_move(self, base: MsgBase) -> None:
        self.moves.append(ReqAckPlayerMove.decode(base.msg_data))

    def use_item(self, config_id: str, target_row: int | None = None) -> None:
        """EGMI_REQ_ITEM_OBJECT — family targets (hero/equip row) ride
        targetid.index with svrid == 1 (the game role's ROW_TARGET_SVRID
        tag: row 0 is a valid record row, so a zeroed ident must keep
        meaning "no target")."""
        self._send(MsgID.REQ_ITEM_OBJECT, ReqAckUseItem(
            item=ItemStruct(item_id=config_id.encode(), item_count=1),
            targetid=(Ident(svrid=1, index=target_row)
                      if target_row is not None else None),
        ))

    def wear_equip(self, row: int) -> None:
        self._send(MsgID.WEAR_EQUIP,
                   ReqWearEquip(equipid=Ident(svrid=0, index=row)))

    def take_off_equip(self, row: int) -> None:
        self._send(MsgID.TAKEOFF_EQUIP,
                   TakeOffEquip(equipid=Ident(svrid=0, index=row)))

    def accept_task(self, task_id: str) -> None:
        self._send(MsgID.REQ_ACCEPT_TASK,
                   ReqAcceptTask(task_id=task_id.encode()))

    def complete_task(self, task_id: str) -> None:
        self._send(MsgID.REQ_COMPLETE_TASK,
                   ReqCompeleteTask(task_id=task_id.encode()))

    def create_team(self) -> None:
        self._send(MsgID.REQ_CREATE_TEAM, ReqAckCreateTeam())

    def join_team(self, team_id: "Ident") -> None:
        self._send(MsgID.REQ_JOIN_TEAM, ReqAckJoinTeam(team_id=team_id))

    def leave_team(self) -> None:
        self._send(MsgID.REQ_LEAVE_TEAM, ReqAckLeaveTeam())

    def opr_team_member(self, team_id: "Ident", member: "Ident",
                        op_type: int) -> None:
        """EGMI_REQ_OPRMEMBER_TEAM: captain member ops (KICK etc.)."""
        self._send(MsgID.REQ_OPRMEMBER_TEAM, ReqAckOprTeamMember(
            team_id=team_id, member_id=member, type=int(op_type),
        ))

    def create_guild(self, name: str) -> None:
        self._send(MsgID.REQ_CREATE_GUILD,
                   ReqAckCreateGuild(guild_name=name.encode()))

    def join_guild(self, name: str) -> None:
        self._send(MsgID.REQ_JOIN_GUILD,
                   ReqAckJoinGuild(guild_name=name.encode()))

    def leave_guild(self) -> None:
        self._send(MsgID.REQ_LEAVE_GUILD, ReqAckLeaveGuild())

    def search_guild(self, name: str = "") -> None:
        self._send(MsgID.REQ_SEARCH_GUILD,
                   ReqSearchGuild(guild_name=name.encode()))

    def chat(self, text: str) -> None:
        self._send(
            MsgID.REQ_CHAT,
            ReqAckPlayerChat(chat_info=text.encode(), chat_type=0),
        )

    def _on_chat(self, base: MsgBase) -> None:
        msg = ReqAckPlayerChat.decode(base.msg_data)
        who = msg.chat_id
        self.chat_log.append(
            (f"{who.svrid}-{who.index}" if who else "?",
             msg.chat_info.decode("utf-8", "replace"))
        )

    def use_skill(self, target: Ident, skill_id: str = "skill_1") -> None:
        from ..net.wire import EffectData

        self._send(
            MsgID.REQ_SKILL_OBJECTX,
            ReqAckUseSkill(
                user=self.player_guid,
                skill_id=skill_id.encode(),
                effect_data=[EffectData(effect_ident=target)],
            ),
        )

    def _on_skill(self, base: MsgBase) -> None:
        self.skills.append(ReqAckUseSkill.decode(base.msg_data))

    # ------------------------------------------------- SLG city building
    # client side of NFCSLGShopModule / NFCSLGBuildingModule's wire
    # surface (EGEC_REQ_BUY_FORM_SHOP .. EGEC_REQ_BUILD_OPERATE)
    def slg_buy(self, shop_id: str, x: float, y: float,
                z: float = 0.0) -> None:
        from ..net.wire_families import ReqAckBuyObjectFormShop

        self._send(MsgID.REQ_BUY_FORM_SHOP, ReqAckBuyObjectFormShop(
            config_id=shop_id.encode(), x=x, y=y, z=z,
        ))

    def slg_move(self, row: int, x: float, y: float, z: float = 0.0) -> None:
        from ..net.wire_families import ReqAckMoveBuildObject

        self._send(MsgID.REQ_MOVE_BUILD_OBJECT, ReqAckMoveBuildObject(
            row=row, x=x, y=y, z=z,
        ))

    def slg_upgrade(self, row: int) -> None:
        from ..net.wire_families import ReqUpBuildLv

        self._send(MsgID.REQ_UP_BUILD_LVL, ReqUpBuildLv(row=row))

    def slg_produce(self, row: int, config_id: str, count: int = 1) -> None:
        from ..net.wire_families import ReqCreateItem

        self._send(MsgID.REQ_CREATE_ITEM, ReqCreateItem(
            row=row, config_id=config_id.encode(), count=count,
        ))

    def slg_operate(self, row: int, functype: int) -> None:
        from ..net.wire_families import ReqBuildOperate

        self._send(MsgID.REQ_BUILD_OPERATE, ReqBuildOperate(
            row=row, functype=int(functype),
        ))

    def slg_collect(self, row: int, resource: str = "Gold") -> None:
        from ..net.wire_families import SLGFuncType

        self.slg_operate(row, int(SLGFuncType[f"COLLECT_{resource.upper()}"]))

    def set_fight_hero(self, hero_row: int, fight_pos: int = 0) -> None:
        """EGEC_REQ_SET_FIGHT_HERO: pick the battle line-up hero by its
        PlayerHero record row (heroes are row-identified)."""
        from ..net.wire import ReqSetFightHero

        self._send(MsgID.REQ_SET_FIGHT_HERO, ReqSetFightHero(
            selfid=self.player_guid,
            heroid=Ident(svrid=0, index=hero_row),
            fight_pos=fight_pos,
        ))

    def switch_server(self, target_game_id: int, scene_id: int = 1,
                      group_id: int = 0) -> None:
        """EGMI_REQSWICHSERVER (OnClientReqSwichServer): ask to be
        re-homed onto another game server; the proxy re-routes after the
        blob lands there."""
        from ..net.wire import ReqSwitchServer

        self._send(MsgID.REQ_SWITCH_SERVER, ReqSwitchServer(
            selfid=self.player_guid, target_serverid=target_game_id,
            scene_id=scene_id, group_id=group_id,
        ))

    # --------------------------------------------------------- GM + PVP
    def gm_command(self, command_id: int, str_value: str = "",
                   int_value: int = 0) -> None:
        """EGMI_REQ_CMD_NORMAL: 0 = set int property, 1 = give item,
        3 = add exp (gated by the avatar's GMLevel server-side)."""
        from ..net.wire import ReqCommand

        self._send(MsgID.REQ_CMD_NORMAL, ReqCommand(
            command_id=int(command_id),
            command_str_value=str_value.encode() or None,
            command_value_int=int_value,
        ))

    def pvp_apply_match(self, mode: int = 0,
                        score: int | None = None) -> None:
        """Queue for PVP matchmaking; the room assignment arrives as
        AckPVPApplyMatch in `pvp_matches` (both fighters get it)."""
        from ..net.wire import ReqPVPApplyMatch

        self._send(MsgID.REQ_PVP_APPLY_MATCH, ReqPVPApplyMatch(
            self_id=self.player_guid, nPVPMode=mode, score=score,
        ))

    def pvp_create_ectype(self, room=None) -> None:
        """Mint the PVP instance for a granted room (defaults to the
        most recent match's room)."""
        from ..net.wire import ReqCreatePVPEctype

        if room is None and self.pvp_matches:
            room = self.pvp_matches[-1].xRoomInfo
        if room is None:
            return
        self._send(MsgID.REQ_CREATE_PVP_ECTYPE, ReqCreatePVPEctype(
            self_id=self.player_guid, xRoomInfo=room,
        ))

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None
