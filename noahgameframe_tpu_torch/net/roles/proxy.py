"""Proxy (gateway) role: client TCP edge, auth by connect key, routing.

Reference: NFProxyServerNet_ServerPlugin / NFProxyServerNet_ClientPlugin —
clients attach here after the select-world handshake; `OnConnectKeyProcess`
verifies the world-minted key and binds the account to the connection
(`NFCProxyServerNet_ServerModule.cpp:130-163`); every further client
message is stamped with the verified client ident and routed client→game
by selected server id or consistent hash (`OnOtherMessage` `:83-128`);
game→client traffic is fanned out per the envelope's client list
(`Transpond` `:297-352`, which forwards the *inner* payload to each
client).  The proxy learns the live game-server set from World
(STS_NET_INFO) and keeps an outbound pool with the reconnect FSM.

A copy of ``noahgameframe_tpu/net/roles/proxy.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import hmac
import time as _time
from typing import Dict, Optional, Tuple

from ...telemetry.pipeline import TraceError, decode_trace, encode_trace
from ..defines import EventCode, MsgID, ServerState, ServerType, SwitchNoticeCode
from ..failover import ParkingBuffer
from ..module import NORMAL, NetClientModule
from ..transport import EV_DISCONNECTED, EV_MSG
from ..wire import (
    AckConnectWorldResult,
    AckEventResult,
    Ident,
    MsgBase,
    ReqAccountLogin,
    ReqSelectServer,
    SwitchNotice,
    ident_key as _ident_key,
    scan_envelope_targets,
    unwrap,
    wrap,
)
from .base import RoleConfig, ServerRole, decode_reports

_IdentKey = Tuple[int, int]  # (svrid, index)


class ProxyRole(ServerRole):
    server_type = int(ServerType.PROXY)

    KEY_TTL_S = 120.0  # a grant the client never redeems expires
    #: retry hint carried in BUSY/REHOMING notices — roughly one lease
    #: refresh, by which time the world's failover has usually re-staged
    RETRY_AFTER_MS = 500

    def __init__(self, config: RoleConfig, backend: str = "auto") -> None:
        # account -> (world-minted connect key, expiry monotonic time);
        # one-time use, TTL-bounded — a captured account+key pair can't
        # re-authenticate after the legitimate redeem
        self._keys: Dict[str, Tuple[str, float]] = {}
        # verified client ident -> conn_id (the Transpond routing table)
        self._client_conn: Dict[_IdentKey, int] = {}
        # conn_id -> binding info, survives until the disconnect handler has
        # told the game (conn_tags are cleared before our socket hook runs)
        self._conn_info: Dict[int, Dict[str, object]] = {}
        super().__init__(config, backend=backend)
        self.world = self.add_upstream(
            "world",
            [t for t in config.targets if t.server_type == int(ServerType.WORLD)],
            register_msg=MsgID.PTWG_PROXY_REGISTERED,
            refresh_msg=MsgID.PTWG_PROXY_REFRESH,
        )
        self.world.on(MsgID.ACK_CONNECT_KEY, self._on_key_granted)
        self.world.on(MsgID.STS_NET_INFO, self._on_game_list)
        # outbound pool to game servers (fed by World's game list)
        self.games = NetClientModule(backend=self.backend)
        self.clients["games"] = self.games
        self.telemetry.add_net_source("games", self.games.counters)
        self.telemetry.add_pool_source("games", self.games)
        # switch re-route before the catch-all: the target game tells us
        # its client moved; we re-point the binding, the client never
        # sees the control message (reference: gate handles
        # EGMI_REQSWICHSERVER from the game, NFCGSSwichServerModule)
        self.games.on(MsgID.REQ_SWITCH_SERVER, self._on_switch_route)
        # frame observatory: the dispatch tap stamps arrival
        # time for every game→proxy message, so _transpond can attribute
        # its relay latency, and FRAME_TRACE sidecars get proxy_in/out
        # stamps before fan-out (a dedicated handler keeps them off the
        # blind _transpond path)
        self.games.dispatch.tap = self._games_tap
        self.games.on(MsgID.FRAME_TRACE, self._on_frame_trace)
        self.games.on_any(self._transpond)
        self._relay_arrival_ns = 0
        self._relay_hist = self.telemetry.registry.histogram(
            "nf_proxy_relay_seconds",
            "game→client transpond relay latency (arrival to fan-out done)",
        )
        self.traces_relayed = 0
        # session failover: frames headed for a dead/absent
        # binding park here instead of dropping, and replay in order once
        # the world's driver re-homes the session and the target's
        # re-point lands (_on_switch_route)
        self.parking = ParkingBuffer(registry=self.telemetry.registry)
        # switch-notice accounting: the drill's no-silent-drop
        # invariant needs to prove every unbound session *heard* about it
        # — aggregate per code, and per client conn (cleared with the
        # conn) so a specific orphan can be checked, not just totals
        self.notice_counts: Dict[int, int] = {}
        self.conn_notices: Dict[int, Dict[int, int]] = {}
        self._c_notices = self.telemetry.registry.counter(
            "nf_switch_notices_total",
            "ACK_SWITCH_NOTICE control frames pushed to clients",
            ("code",),
        )

    def _install(self) -> None:
        s = self.server
        s.on(MsgID.REQ_CONNECT_KEY, self._on_connect_key)
        s.on(MsgID.REQ_SELECT_SERVER, self._on_select_server)
        s.on_any(self._on_client_message)
        s.on_socket_event(self._on_socket)

    def cur_count(self) -> int:
        return len(self._client_conn)

    # ------------------------------------------------------ world side
    def _on_key_granted(self, _sid: int, _msg_id: int, body: bytes) -> None:
        _, grant = unwrap(body, AckConnectWorldResult)
        now = _time.monotonic()
        # sweep never-redeemed expired grants so the map stays bounded
        self._keys = {a: kv for a, kv in self._keys.items() if kv[1] > now}
        self._keys[grant.account.decode("utf-8", "replace")] = (
            grant.world_key.decode("utf-8", "replace"),
            now + self.KEY_TTL_S,
        )

    def _on_game_list(self, _sid: int, _msg_id: int, body: bytes) -> None:
        """Reconcile the outbound pool against World's authoritative game
        list: add new, re-dial changed endpoints, prune vanished servers
        (a restarted game comes back on a new ephemeral port)."""
        before = set(self.games.servers)
        seen = set()
        for r in decode_reports(body):
            if int(r.server_state) == int(ServerState.CRASH):
                # lease-evicted / crashed upstream: leave it out of
                # `seen` so the prune below stops routing to it
                continue
            sid = r.server_id
            ip = r.server_ip.decode("utf-8", "replace")
            seen.add(sid)
            sd = self.games.servers.get(sid)
            if sd is not None and (sd.ip != ip or sd.port != r.server_port):
                self.games.remove_server(sid)
                sd = None
            if sd is None:
                self.games.add_server(
                    sid, int(r.server_type), ip, r.server_port,
                    r.server_name.decode("utf-8", "replace"),
                )
        for sid in list(self.games.servers):
            if sid not in seen:
                self.games.remove_server(sid)
        # a prune used to silently unbind every client on
        # the vanished game — their messages fell into the void with no
        # signal.  Tell them explicitly: failover is re-homing you, park
        # in the meantime, retry after a beat if nothing arrives.  Only
        # the transition fires (`before - seen`), so a game that stays
        # CRASH across refreshes does not re-notify every push.
        gone = {int(s) for s in before - seen}
        if gone:
            for conn_id, info in self._conn_info.items():
                gid = info.get("game_id")
                if gid is not None and int(gid) in gone:
                    self._notify_switch(
                        conn_id, SwitchNoticeCode.REHOMING, int(gid),
                        self.RETRY_AFTER_MS,
                    )

    def _notify_switch(self, conn_id: int, code: SwitchNoticeCode,
                       target_sid: int, retry_after_ms: int) -> None:
        """Push an ACK_SWITCH_NOTICE control frame to one client (the
        reference has no equivalent — orphaned clients just time out)."""
        notice = SwitchNotice(
            code=int(code),
            target_serverid=int(target_sid),
            retry_after_ms=int(retry_after_ms),
        )
        self.server.send_raw(
            conn_id, int(MsgID.ACK_SWITCH_NOTICE), wrap(notice)
        )
        self.notice_counts[int(code)] = (
            self.notice_counts.get(int(code), 0) + 1)
        per = self.conn_notices.setdefault(conn_id, {})
        per[int(code)] = per.get(int(code), 0) + 1
        try:
            label = SwitchNoticeCode(int(code)).name
        except ValueError:
            label = str(int(code))
        self._c_notices.inc(code=label)

    # ------------------------------------------------------ client side
    def _on_connect_key(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        _, req = unwrap(body, ReqAccountLogin)
        account = req.account.decode("utf-8", "replace")
        key = req.security_code.decode("utf-8", "replace")
        granted = self._keys.get(account)
        if granted is not None and _time.monotonic() >= granted[1]:
            del self._keys[account]  # expired, never redeemable
            granted = None
        ok = (
            bool(account)
            and granted is not None
            and hmac.compare_digest(granted[0], key)
        )
        if ok:
            del self._keys[account]  # one-time use
            ident = Ident(svrid=self.config.server_id, index=conn_id)
            tags = self.server.conn_tags.setdefault(conn_id, {})
            tags["account"] = account
            tags["ident"] = ident
            self._client_conn[_ident_key(ident)] = conn_id
            self._conn_info[conn_id] = {"ident": ident, "account": account}
            ack = AckEventResult(
                event_code=int(EventCode.VERIFY_KEY_SUCCESS), event_object=ident
            )
        else:
            ack = AckEventResult(event_code=int(EventCode.VERIFY_KEY_FAIL))
        self.server.send_pb(conn_id, int(MsgID.ACK_CONNECT_KEY), ack)
        if not ok:
            self.server.close_conn(conn_id)

    def _on_select_server(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        """Bind this client to a specific game server
        (`OnReqServerListProcess`/select path)."""
        tags = self.server.conn_tags.get(conn_id, {})
        if "ident" not in tags:
            return
        _, req = unwrap(body, ReqSelectServer)
        sd = self.games.servers.get(req.world_id)
        if sd is not None and sd.state == NORMAL:
            tags["game_id"] = req.world_id
            info = self._conn_info.get(conn_id)
            if info is not None:
                info["game_id"] = req.world_id
            code = int(EventCode.SELECTSERVER_SUCCESS)
        else:
            code = int(EventCode.SELECTSERVER_FAIL)
        self.server.send_pb(
            conn_id,
            int(MsgID.ACK_SELECT_SERVER),
            AckEventResult(event_code=code),
        )

    def _on_client_message(self, conn_id: int, msg_id: int, body: bytes) -> None:
        """The routing hot path: stamp the verified ident, forward to the
        bound game server or hash-route by account."""
        tags = self.server.conn_tags.get(conn_id, {})
        ident = tags.get("ident")
        if ident is None:
            return  # unauthenticated: drop (reference closes after abuse)
        base = MsgBase.decode(body)
        base.player_id = ident  # server-authoritative identity stamp
        out = base.encode()
        game_id = tags.get("game_id")
        if game_id is not None:
            # order guard: while frames are parked for this session, new
            # arrivals must queue BEHIND them even if the (re-pointed)
            # binding is already sendable — a direct send here would
            # overtake the parked prefix
            if self.parking.depth(conn_id):
                dropped = self.parking.park(
                    conn_id, msg_id, out, _time.monotonic()
                )
                if dropped:
                    self._notify_switch(
                        conn_id, SwitchNoticeCode.DROPPED, int(game_id),
                        self.RETRY_AFTER_MS,
                    )
            elif not self.games.send_by_server_id(game_id, msg_id, out):
                # bound game is gone or not NORMAL: park instead of drop
                # — failover is (or will be) re-homing this session, and
                # _on_switch_route replays the queue in order
                dropped = self.parking.park(
                    conn_id, msg_id, out, _time.monotonic()
                )
                if dropped:
                    self._notify_switch(
                        conn_id, SwitchNoticeCode.DROPPED, int(game_id),
                        self.RETRY_AFTER_MS,
                    )
        else:
            self.games.send_by_suit(tags.get("account", ""), msg_id, out)

    def _on_socket(self, conn_id: int, kind: int) -> None:
        if kind != EV_DISCONNECTED:
            return
        self._client_conn = {
            k: c for k, c in self._client_conn.items() if c != conn_id
        }
        # anything still parked for a dead client socket has no receiver
        # for its replies either — drop it (counted reason="disconnect")
        self.parking.discard(conn_id)
        self.conn_notices.pop(conn_id, None)
        # tell the game its player is gone (the reference proxy fires
        # REQ_LEAVE_GAME upstream when a client socket dies)
        info = self._conn_info.pop(conn_id, None)
        if info is None:
            return
        base = MsgBase(player_id=info["ident"], msg_data=b"")
        game_id = info.get("game_id")
        if game_id is not None:
            self.games.send_by_server_id(
                int(game_id), int(MsgID.REQ_LEAVE_GAME), base.encode()
            )
        else:
            self.games.send_by_suit(
                str(info.get("account", "")), int(MsgID.REQ_LEAVE_GAME),
                base.encode(),
            )

    # ------------------------------------------------------ game → client
    def _on_switch_route(self, _sid: int, _msg_id: int, body: bytes) -> None:
        """Re-point a client's game binding after a cross-server switch:
        subsequent client messages route to the new game server."""
        from ..wire import ReqSwitchServer

        _, req = unwrap(body, ReqSwitchServer)
        if req.client_id is None:
            return
        conn_id = self._client_conn.get(_ident_key(req.client_id))
        if conn_id is None:
            return  # not our client (multi-proxy broadcast)
        tags = self.server.conn_tags.get(conn_id)
        if tags is not None:
            tags["game_id"] = int(req.target_serverid)
        # the disconnect path reads _conn_info, not conn_tags — both must
        # re-point or a later socket death sends REQ_LEAVE_GAME to the
        # OLD game and the new one keeps a ghost avatar forever
        info = self._conn_info.get(conn_id)
        if info is not None:
            info["game_id"] = int(req.target_serverid)
        # new binding is live: replay anything parked while the old one
        # was dead, in arrival order.  A failed send leaves the rest
        # parked; _parking_pump retries on the next execute pass.
        if self.parking.depth(conn_id):
            target = int(req.target_serverid)
            self.parking.replay(
                conn_id,
                lambda m, b: self.games.send_by_server_id(target, m, b),
            )

    def _games_tap(self, ev) -> None:
        """Dispatch-tap seam (net/module.py:_Dispatch.tap): stamp arrival
        time for the message about to be handled.  feed() is synchronous
        — tap fires, then the handler — so the stamp always belongs to
        the event the handler sees."""
        if ev.kind == EV_MSG:
            self._relay_arrival_ns = _time.perf_counter_ns()

    def _on_frame_trace(self, _sid: int, msg_id: int, body: bytes) -> None:
        """Stamp the sampled trace sidecar with proxy in/out times and fan
        it out exactly like _transpond would — re-encoded, since the
        header mutates in flight."""
        arrival = self._relay_arrival_ns
        base = MsgBase.decode(body)
        try:
            ctx = decode_trace(base.msg_data)
        except TraceError:
            return  # malformed sidecar: drop, never crash the edge
        targets = base.player_client_list or (
            [base.player_id] if base.player_id is not None else []
        )
        ctx.proxy_in_ns = arrival
        ctx.proxy_out_ns = _time.perf_counter_ns()
        base.msg_data = encode_trace(ctx)
        out = base.encode()
        for ident in targets:
            conn_id = self._client_conn.get(_ident_key(ident))
            if conn_id is not None:
                self.server.send_raw(conn_id, msg_id, out)
        self.traces_relayed += 1
        done = _time.perf_counter_ns()
        self.games.counters.count_relay(msg_id, done - arrival)
        self._relay_hist.observe((done - arrival) / 1e9)

    def _transpond(self, _sid: int, msg_id: int, body: bytes) -> None:
        """Deliver the enveloped message to each client in the envelope's
        client list (empty list → the envelope's player_id).  The whole
        MsgBase goes through unchanged, exactly like the reference's
        `SendMsgWithOutHead(nMsgID, msg, nLen)` — clients always unwrap.

        Pre-assembled frame scatter: the game already encoded
        the envelope once for ALL recipients, so the relay's only job is
        routing.  `scan_envelope_targets` walks the header fields without
        materializing msg_data (the frame payload — the big part) or
        per-client Ident objects; the SAME `body` buffer is handed to
        every connection.  Per-frame relay cost is O(clients) dict
        lookups, independent of payload size."""
        try:
            keys = scan_envelope_targets(body)
        except (ValueError, IndexError):
            # torn envelope: the tolerant object decode decides (and
            # keeps the drop semantics identical to the legacy path)
            base = MsgBase.decode(body)
            keys = [
                _ident_key(i)
                for i in (base.player_client_list
                          or ([base.player_id]
                              if base.player_id is not None else []))
            ]
        for key in keys:
            conn_id = self._client_conn.get(key)
            if conn_id is not None:
                self.server.send_raw(conn_id, msg_id, body)
        # per-opcode forward-latency attribution:
        # dispatch-tap arrival → fan-out complete, two clock reads
        done = _time.perf_counter_ns()
        self.games.counters.count_relay(msg_id, done - self._relay_arrival_ns)
        self._relay_hist.observe((done - self._relay_arrival_ns) / 1e9)

    def execute(self, now: Optional[float] = None) -> None:
        now = _time.monotonic() if now is None else now
        super().execute(now)
        self._parking_pump(now)

    def _parking_pump(self, now: float) -> None:
        """Per-pump parking maintenance — strictly non-blocking (nf-lint
        `pump-surface` contract, docs/LINT.md): retry replay for
        sessions whose binding healed without a switch-route (e.g. the
        origin game revived on the same id), expire deadline-overdue
        frames, and tell affected clients what was lost."""
        if self.parking.depth() == 0:
            return
        for key in self.parking.keys():
            info = self._conn_info.get(key)
            if info is None:
                self.parking.discard(key)  # client already gone
                continue
            gid = info.get("game_id")
            if gid is None:
                continue
            sd = self.games.servers.get(int(gid))
            if sd is not None and sd.state == NORMAL:
                self.parking.replay(
                    key,
                    lambda m, b, g=int(gid):
                        self.games.send_by_server_id(g, m, b),
                )
        depths = {k: self.parking.depth(k) for k in self.parking.keys()}
        if self.parking.expire(now):
            for key, depth in depths.items():
                if self.parking.depth(key) < depth and isinstance(key, int):
                    info = self._conn_info.get(key)
                    gid = (info or {}).get("game_id") or 0
                    self._notify_switch(
                        key, SwitchNoticeCode.DROPPED, int(gid),
                        self.RETRY_AFTER_MS,
                    )

    def report(self):
        r = super().report()
        ext = r.server_info_list_ext
        h = self._relay_hist
        if h.count > 0:
            ext.key.append(b"relay_p50_ms")
            ext.value.append(
                f"{h.percentile(50.0) * 1e3:.4f}".encode())
            ext.key.append(b"relay_p95_ms")
            ext.value.append(
                f"{h.percentile(95.0) * 1e3:.4f}".encode())
        ext.key.append(b"traces_relayed")
        ext.value.append(str(self.traces_relayed).encode())
        ext.key.append(b"parked_frames")
        ext.value.append(str(self.parking.depth()).encode())
        return r
