"""World role: hub for game/proxy registration + enter-world rendezvous.

Reference: NFWorldNet_ServerPlugin / NFWorldLogicPlugin — game and proxy
servers register and refresh here (callbacks
`NFCWorldNet_ServerModule.cpp:28-36`); on a select-world request the world
picks the least-loaded proxy, mints a connect key, pre-authorizes it at
that proxy, and answers Master with the proxy endpoint + key; server
reports from games/proxies are relayed up to Master (SURVEY §3.5).  It
also pushes the live game-server list down to proxies so the gateway can
keep its outbound pool current.

A copy of ``noahgameframe_tpu/net/roles/world.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time as _time
from typing import Dict, List, Optional

from ..defines import LEASE_DOWN_SECONDS, MsgID, ServerState, ServerType
from ..failover import FailoverDriver, SessionInfo, ext_map
from ..transport import EV_DISCONNECTED
from ..wire import (
    AckConnectWorldResult,
    Ident,
    MsgBase,
    ReqConnectWorld,
    RoleOfflineNotify,
    ServerInfoExt,
    ServerInfoReport,
    ServerInfoReportList,
    SessionBindNotify,
    SwitchRefused,
    ident_key as _ident_key,
    unwrap,
    wrap,
)
from .base import RoleConfig, ServerRole, decode_reports

# game→world sync traffic the World relays to every OTHER game server so
# players on different game servers converge on each other's public state
# (reference NFCWorldNet_ServerModule.cpp:600-830 rebuilds and re-sends
# property/record packs world-side; here the already-encoded game message
# is transponded verbatim — the TPU game server already batched it)
CROSS_SYNC_MSGS = (
    MsgID.ACK_ONLINE_NOTIFY,
    MsgID.ACK_OFFLINE_NOTIFY,
    MsgID.ACK_PROPERTY_INT,
    MsgID.ACK_PROPERTY_FLOAT,
    MsgID.ACK_PROPERTY_STRING,
    MsgID.ACK_PROPERTY_OBJECT,
    MsgID.ACK_PROPERTY_VECTOR2,
    MsgID.ACK_PROPERTY_VECTOR3,
    MsgID.ACK_ADD_ROW,
    MsgID.ACK_REMOVE_ROW,
    MsgID.ACK_SWAP_ROW,
    MsgID.ACK_RECORD_INT,
    MsgID.ACK_RECORD_FLOAT,
    MsgID.ACK_RECORD_STRING,
    MsgID.ACK_RECORD_OBJECT,
    MsgID.ACK_RECORD_VECTOR3,
)


@dataclasses.dataclass
class _Downstream:
    report: ServerInfoReport
    conn_id: int
    last_seen: float = 0.0


class WorldRole(ServerRole):
    server_type = int(ServerType.WORLD)

    def __init__(self, config: RoleConfig, backend: str = "auto",
                 lease_down_seconds: float = LEASE_DOWN_SECONDS,
                 recover_store=None, failover: bool = True) -> None:
        self.games: Dict[int, _Downstream] = {}
        self.proxies: Dict[int, _Downstream] = {}
        # a downstream that stops reporting for this long is treated as
        # dead even if its socket looks alive (half-open link/partition)
        self.lease_down_seconds = lease_down_seconds
        # world roster: online player ident -> owning game server id
        # (fed by ACK_ONLINE/OFFLINE_NOTIFY; the reference's OnOnlineProcess)
        self.roster: Dict[tuple, int] = {}
        # session bind metadata per online player (SESSION_BIND_NOTIFY
        # sidecars) — everything the failover driver needs to re-home a
        # session when its game dies
        self.sessions: Dict[tuple, SessionInfo] = {}
        super().__init__(config, backend=backend)
        self._lease_expirations = self.telemetry.registry.counter(
            "nf_lease_expirations_total",
            "downstream leases aged past the DOWN threshold", ("role",),
        )
        self.failover: Optional[FailoverDriver] = (
            FailoverDriver(self, recover_store=recover_store)
            if failover else None
        )
        self.master = self.add_upstream(
            "master",
            [t for t in config.targets if t.server_type == int(ServerType.MASTER)],
            register_msg=MsgID.MTL_WORLD_REGISTERED,
            refresh_msg=MsgID.MTL_WORLD_REFRESH,
        )
        self.master.on(MsgID.REQ_CONNECT_WORLD, self._on_req_connect_world)

    def _install(self) -> None:
        s = self.server
        for msg in (MsgID.GTW_GAME_REGISTERED, MsgID.GTW_GAME_REFRESH):
            s.on(msg, self._on_game_register)
        s.on(MsgID.GTW_GAME_UNREGISTERED, self._on_game_unregister)
        for msg in (MsgID.PTWG_PROXY_REGISTERED, MsgID.PTWG_PROXY_REFRESH):
            s.on(msg, self._on_proxy_register)
        s.on(MsgID.PTWG_PROXY_UNREGISTERED, self._on_proxy_unregister)
        s.on(MsgID.STS_SERVER_REPORT, self._on_server_report)
        for msg in CROSS_SYNC_MSGS:
            s.on(msg, self._on_cross_sync)
        # cross-game-server switch: targeted relays (the reference routes
        # these through the world's cluster link, NFCGSSwichServerModule)
        s.on(MsgID.REQ_SWITCH_SERVER, self._on_switch_relay)
        s.on(MsgID.SWITCH_SERVER_DATA, self._on_switch_relay)
        s.on(MsgID.ACK_SWITCH_SERVER, self._on_switch_relay)
        # session failover: bind metadata + refusal intake
        s.on(MsgID.SESSION_BIND_NOTIFY, self._on_session_bind)
        s.on(MsgID.ACK_SWITCH_REFUSED, self._on_switch_refused)
        s.on_socket_event(self._on_socket)

    def _on_switch_relay(self, conn_id: int, msg_id: int, body: bytes) -> None:
        """Route a switch message to the ONE game it names: REQ/DATA go
        to target_serverid, ACK returns to the originating game
        (self_serverid)."""
        from ..wire import AckSwitchServer, ReqSwitchServer, SwitchServerData

        cls = {
            int(MsgID.REQ_SWITCH_SERVER): ReqSwitchServer,
            int(MsgID.SWITCH_SERVER_DATA): SwitchServerData,
            int(MsgID.ACK_SWITCH_SERVER): AckSwitchServer,
        }[int(msg_id)]
        _, msg = unwrap(body, cls)
        if msg_id == int(MsgID.ACK_SWITCH_SERVER):
            # a failover-staged switch names a DEAD origin: the driver
            # (standing in for it) consumes the ack; anything else is a
            # voluntary switch and relays to the living origin below
            if self.failover is not None and self.failover.on_ack(msg):
                return
            sid = int(msg.self_serverid)
        else:
            sid = int(msg.target_serverid)
        d = self.games.get(sid)
        if d is not None:
            self.server.send_raw(d.conn_id, msg_id, body)

    def _on_session_bind(self, conn_id: int, _msg_id: int,
                         body: bytes) -> None:
        """Game-side sidecar to ACK_ONLINE_NOTIFY: remember everything
        needed to re-home this session if its game dies unasked."""
        _, b = unwrap(body, SessionBindNotify)
        if b.selfid is None:
            return
        client = (_ident_key(b.client_id) if b.client_id is not None
                  else (0, 0))
        info = SessionInfo(
            selfid=_ident_key(b.selfid),
            account=b.account.decode("utf-8", "replace"),
            name=b.name.decode("utf-8", "replace"),
            client_id=client,
            scene_id=int(b.scene_id),
            group_id=int(b.group_id),
            save_key=b.save_key.decode("utf-8", "replace"),
            game_id=int(b.game_id),
        )
        self.sessions[info.selfid] = info

    def _on_switch_refused(self, conn_id: int, _msg_id: int,
                           body: bytes) -> None:
        """A staged target could not admit the switch (capacity / torn
        blob): hand the refusal to the failover driver so it retries
        another survivor.  Voluntary switches have no refusal leg — the
        origin's staged blob simply ages out of its TTL sweep."""
        _, msg = unwrap(body, SwitchRefused)
        if self.failover is not None:
            self.failover.on_refused(msg)

    # ------------------------------------------- cross-game sync relay
    def _on_cross_sync(self, conn_id: int, msg_id: int, body: bytes) -> None:
        """Property/record sync relay game→world→other games
        (NFCWorldNet_ServerModule.cpp:600-830).  The envelope is relayed
        verbatim; the roster tracks online players per game."""
        if msg_id in (int(MsgID.ACK_ONLINE_NOTIFY), int(MsgID.ACK_OFFLINE_NOTIFY)):
            base = MsgBase.decode(body)
            sid = self.server.conn_tags.get(conn_id, {}).get("server_id")
            key = _ident_key(base.player_id)
            if msg_id == int(MsgID.ACK_ONLINE_NOTIFY) and sid is not None:
                self.roster[key] = sid
            else:
                self.roster.pop(key, None)
                self.sessions.pop(key, None)
        for d in self.games.values():
            if d.conn_id != conn_id:
                self.server.send_raw(d.conn_id, msg_id, body)

    # ---------------------------------------------------- registration
    def _on_game_register(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        for r in decode_reports(body):
            self.games[r.server_id] = _Downstream(r, conn_id, _time.monotonic())
            self.server.conn_tags.setdefault(conn_id, {})["server_id"] = r.server_id
            self._relay_report(r)
        self._push_game_list()

    def _on_game_unregister(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        for r in decode_reports(body):
            self.games.pop(r.server_id, None)
        self._push_game_list()

    def _on_proxy_register(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        for r in decode_reports(body):
            self.proxies[r.server_id] = _Downstream(r, conn_id, _time.monotonic())
            self.server.conn_tags.setdefault(conn_id, {})["server_id"] = r.server_id
            self._relay_report(r)
        # a (re)joined proxy needs the current game list immediately
        self._send_game_list(conn_id)

    def _on_proxy_unregister(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        for r in decode_reports(body):
            self.proxies.pop(r.server_id, None)

    def _on_server_report(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        """Keepalive load reports from games/proxies; refresh + relay up
        (`NFCWorldNet_ServerModule.cpp:36` → Master upsert)."""
        now = _time.monotonic()
        for r in decode_reports(body):
            book = self.games if r.server_type == int(ServerType.GAME) else self.proxies
            cur = book.get(r.server_id)
            if cur is not None:
                cur.report = r
                cur.last_seen = now
            elif conn_id >= 0:
                # a live reporter we don't know: its registration was
                # lost (dropped under chaos) or its lease false-expired —
                # re-adopt; the keepalive doubles as registration
                book[r.server_id] = _Downstream(r, conn_id, now)
                self.server.conn_tags.setdefault(conn_id, {})["server_id"] = r.server_id
                if r.server_type == int(ServerType.GAME):
                    self._push_game_list()
            self._relay_report(r)

    def _relay_report(self, r: ServerInfoReport) -> None:
        self.master.send_to_all(
            int(MsgID.STS_SERVER_REPORT),
            wrap(ServerInfoReportList(server_list=[r])),
        )

    def _on_socket(self, conn_id: int, kind: int) -> None:
        if kind != EV_DISCONNECTED:
            return
        dead = [v for v in list(self.games.values()) + list(self.proxies.values())
                if v.conn_id == conn_id]
        self.games = {k: v for k, v in self.games.items() if v.conn_id != conn_id}
        self.proxies = {k: v for k, v in self.proxies.items() if v.conn_id != conn_id}
        if dead:
            self._mark_dead(dead)

    def _sweep_leases(self, now: float) -> None:
        """Expire downstreams whose reports stopped arriving: a link can
        stay ESTABLISHED while the peer is partitioned away or wedged.
        Evicted entries re-adopt on their next report (upsert above)."""
        dead = [v for v in list(self.games.values()) + list(self.proxies.values())
                if now - v.last_seen >= self.lease_down_seconds]
        if not dead:
            return
        gone = {id(v) for v in dead}
        self.games = {k: v for k, v in self.games.items() if id(v) not in gone}
        self.proxies = {k: v for k, v in self.proxies.items() if id(v) not in gone}
        for d in dead:
            role = (
                "game" if d.report.server_type == int(ServerType.GAME)
                else "proxy"
            )
            self._lease_expirations.inc(role=role)
            if d.conn_id >= 0:
                self.server.close_conn(d.conn_id)
        self._mark_dead(dead)

    def _mark_dead(self, dead: List[_Downstream]) -> None:
        """Shared death path (socket loss or lease expiry): tell Master
        (CRASH state) and re-push the game list so proxies stop routing
        to the corpse."""
        dead_ids = set()
        dead_games: Dict[int, _Downstream] = {}
        for d in dead:
            d.report.server_state = int(ServerState.CRASH)
            dead_ids.add(d.report.server_id)
            if d.report.server_type == int(ServerType.GAME):
                dead_games[d.report.server_id] = d
            self._relay_report(d.report)
        # synthesize offline notifies for the dead game's players so other
        # games' clients drop their (now frozen) remote mirrors
        orphans = [k for k, v in self.roster.items() if v in dead_ids]
        for svrid, index in orphans:
            del self.roster[(svrid, index)]
            body = wrap(RoleOfflineNotify(),
                        player_id=Ident(svrid=svrid, index=index))
            for d in self.games.values():
                self.server.send_raw(
                    d.conn_id, int(MsgID.ACK_OFFLINE_NOTIFY), body
                )
        # supervised failover: hand every session bound to a
        # dead game to the driver, with the durable-media locations the
        # corpse last advertised (WAL + checkpoint dirs ride its report
        # ext), so players re-home instead of silently stalling
        if self.failover is not None and dead_games:
            now = _time.monotonic()
            for sid, d in dead_games.items():
                infos = [v for v in self.sessions.values()
                         if v.game_id == sid]
                for v in infos:
                    self.sessions.pop(v.selfid, None)
                if infos:
                    ext = ext_map(d.report)
                    self.failover.game_died(
                        sid, infos, ext.get("wal_dir"),
                        ext.get("ckpt_dir"), now,
                    )
        self._push_game_list()

    # ------------------------------------------------------------ pump
    def execute(self, now: Optional[float] = None) -> None:
        now = _time.monotonic() if now is None else now
        super().execute(now)
        self._sweep_leases(now)
        if self.failover is not None:
            self.failover.execute(now)

    def report(self):
        """Heartbeat report extended with failover health: pending
        re-homes + oldest lag ride the ext map so the master can show
        `failover_pending`/`failover_lag` on /json and the status page."""
        r = super().report()
        if self.failover is None:
            return r
        ext = r.server_info_list_ext
        if ext is None:
            ext = ServerInfoExt()
            r.server_info_list_ext = ext
        now = _time.monotonic()
        for k, v in (
            ("failover_pending", self.failover.pending_count()),
            ("failover_lag", round(self.failover.lag(now), 3)),
        ):
            ext.key.append(k.encode())
            ext.value.append(str(v).encode())
        return r

    # ---------------------------------------------- game list to proxies
    def _game_reports(self) -> ServerInfoReportList:
        return ServerInfoReportList(
            server_list=[d.report for d in self.games.values()]
        )

    def _send_game_list(self, conn_id: int) -> None:
        self.server.send_raw(
            conn_id, int(MsgID.STS_NET_INFO), wrap(self._game_reports())
        )

    def _push_game_list(self) -> None:
        for d in self.proxies.values():
            self._send_game_list(d.conn_id)

    # -------------------------------------------------- enter-world path
    def _pick_proxy(self) -> Optional[_Downstream]:
        """Least-loaded live proxy (`NFCWorldNet_ServerModule` picks by
        current count)."""
        best = None
        for d in self.proxies.values():
            if best is None or d.report.server_cur_count < best.report.server_cur_count:
                best = d
        return best

    def _mint_key(self, account: str) -> str:
        return hashlib.sha1(
            account.encode() + os.urandom(16)
        ).hexdigest()[:32]

    def _on_req_connect_world(self, _sid: int, _msg_id: int, body: bytes) -> None:
        _, req = unwrap(body, ReqConnectWorld)
        account = req.account.decode("utf-8", "replace")
        proxy = self._pick_proxy()
        if proxy is None:
            return
        key = self._mint_key(account)
        grant = AckConnectWorldResult(
            world_id=self.config.server_id,
            sender=req.sender,
            login_id=req.login_id,
            account=account.encode(),
            world_ip=proxy.report.server_ip,
            world_port=proxy.report.server_port,
            world_key=key.encode(),
        )
        # pre-authorize the key at the chosen proxy, then answer Master
        self.server.send_raw(
            proxy.conn_id, int(MsgID.ACK_CONNECT_KEY), wrap(grant)
        )
        self.master.send_to_all(int(MsgID.ACK_CONNECT_WORLD), wrap(grant))
