"""Server/client network modules: dispatch, envelope, pool, reconnect.

- :class:`NetServerModule` ≙ the reference's `NFINetModule`
  (msgID→handler registry, socket-event callbacks, MsgBase envelope
  send/receive — `NFComm/NFPluginModule/NFINetModule.h:135-520`).
- :class:`NetClientModule` ≙ `NFINetClientModule.hpp`: outbound pool
  keyed by server id, per-link NORMAL/CONNECTING/RECONNECT state
  machine with 10 s backoff (`:312-370`), keepalive hook (`:395-405`),
  `send_by_server_id` / `send_by_suit` (consistent hash) /
  `send_to_all` routing (`:151-239`).

Both are pumped from the main loop via ``execute()`` — no threads.
Time is injected (``now``) so tests can drive the FSM deterministically.

A copy of ``noahgameframe_tpu/net/module.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import time as _time
from typing import Callable, Dict, List, Optional

from ..core.chash import ConsistentHash
from .defines import KEEPALIVE_SECONDS, RECONNECT_SECONDS, ServerType
from .retry import RetryPolicy
from .transport import EV_CONNECTED, EV_DISCONNECTED, EV_MSG, NetEvent, create_client, create_server
from .wire import Ident, Message, MsgBase

ReceiveHandler = Callable[[int, int, bytes], None]  # (conn_id, msg_id, body)
EventHandler = Callable[[int, int], None]  # (conn_id, event_kind)


class NetCounters:
    """Per-opcode message/byte counters for one endpoint (both
    directions).  Plain dicts keyed by msg_id — sampled lazily by
    telemetry's ``nf_net_msgs_total`` / ``nf_net_bytes_total`` callbacks,
    so the hot send/receive path pays two dict bumps and nothing else."""

    def __init__(self) -> None:
        self.in_msgs: Dict[int, int] = {}
        self.in_bytes: Dict[int, int] = {}
        self.out_msgs: Dict[int, int] = {}
        self.out_bytes: Dict[int, int] = {}
        # forward-relay latency per opcode (proxy _transpond): total ns
        # from dispatch arrival to fan-out complete, sampled lazily by
        # telemetry's nf_relay_msgs_total / nf_relay_seconds_total
        self.relay_msgs: Dict[int, int] = {}
        self.relay_ns: Dict[int, int] = {}

    def count_in(self, msg_id: int, nbytes: int) -> None:
        self.in_msgs[msg_id] = self.in_msgs.get(msg_id, 0) + 1
        self.in_bytes[msg_id] = self.in_bytes.get(msg_id, 0) + nbytes

    def count_out(self, msg_id: int, nbytes: int) -> None:
        self.out_msgs[msg_id] = self.out_msgs.get(msg_id, 0) + 1
        self.out_bytes[msg_id] = self.out_bytes.get(msg_id, 0) + nbytes

    def count_relay(self, msg_id: int, dur_ns: int) -> None:
        self.relay_msgs[msg_id] = self.relay_msgs.get(msg_id, 0) + 1
        self.relay_ns[msg_id] = self.relay_ns.get(msg_id, 0) + dur_ns


class _Dispatch:
    """msgID -> handler fan-out with per-message fault isolation.

    A handler that raises (malformed body failing proto decode, capacity
    errors mid-handler, plain bugs) must never kill the server pump: the
    reference logs the packet and keeps serving
    (NFINetModule::OnReceiveNetPack, NFINetModule.h:473-520).  Each
    handler call is isolated; failures are logged and counted."""

    def __init__(self, counters: Optional[NetCounters] = None) -> None:
        self._handlers: Dict[int, List[ReceiveHandler]] = {}
        self._default: List[ReceiveHandler] = []
        self._events: List[EventHandler] = []
        self._log = logging.getLogger("nf.net.dispatch")
        self.dropped_msgs = 0  # observability: handler faults survived
        self.counters = counters
        # flight-recorder seam: when set, sees every event in dispatch
        # order BEFORE any handler runs (replay/journal.py taps here —
        # this is the single choke point both endpoints deliver through)
        self.tap: Optional[Callable[[NetEvent], None]] = None

    def on(self, msg_id: int, fn: ReceiveHandler) -> None:
        self._handlers.setdefault(int(msg_id), []).append(fn)

    def on_any(self, fn: ReceiveHandler) -> None:
        """Catch-all for unregistered ids (the proxy's transpond path)."""
        self._default.append(fn)

    def on_socket_event(self, fn: EventHandler) -> None:
        self._events.append(fn)

    def _safe(self, fn, conn_id: int, msg_id: int, body: bytes) -> None:
        try:
            fn(conn_id, msg_id, body)
        except Exception:  # noqa: BLE001 — isolate the serving edge
            self.dropped_msgs += 1
            self._log.exception(
                "handler failed: conn=%d msg_id=%d len=%d (dropped)",
                conn_id, msg_id, len(body),
            )

    def feed(self, events: List[NetEvent]) -> None:
        for ev in events:
            if self.tap is not None:
                self.tap(ev)
            if ev.kind == EV_MSG:
                if self.counters is not None:
                    self.counters.count_in(ev.msg_id, len(ev.body))
                fns = self._handlers.get(ev.msg_id)
                if fns:
                    for fn in fns:
                        self._safe(fn, ev.conn_id, ev.msg_id, ev.body)
                else:
                    for fn in self._default:
                        self._safe(fn, ev.conn_id, ev.msg_id, ev.body)
            else:
                for fn in self._events:
                    try:
                        fn(ev.conn_id, ev.kind)
                    except Exception:  # noqa: BLE001
                        self.dropped_msgs += 1
                        self._log.exception(
                            "socket-event handler failed: conn=%d kind=%d",
                            ev.conn_id, ev.kind,
                        )


class NetServerModule:
    """Listening endpoint + dispatch + envelope helpers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 backend: str = "auto") -> None:
        self.transport = create_server(host, port, backend=backend)
        self.host = host
        self.port = self.transport.port
        self.counters = NetCounters()
        self.dispatch = _Dispatch(counters=self.counters)
        # connection tags, mirroring NetObject's account/id binding
        # (`NFINet.h:246-405`): conn_id -> dict of app tags
        self.conn_tags: Dict[int, Dict[str, object]] = {}
        self.dispatch.on_socket_event(self._track)

    def _track(self, conn_id: int, kind: int) -> None:
        if kind == EV_CONNECTED:
            self.conn_tags[conn_id] = {}
        elif kind == EV_DISCONNECTED:
            self.conn_tags.pop(conn_id, None)

    # -------------------------------------------------------- registry
    def on(self, msg_id: int, fn: ReceiveHandler) -> None:
        self.dispatch.on(msg_id, fn)

    def on_any(self, fn: ReceiveHandler) -> None:
        self.dispatch.on_any(fn)

    def on_socket_event(self, fn: EventHandler) -> None:
        self.dispatch.on_socket_event(fn)

    # ------------------------------------------------------------ send
    def send_raw(self, conn_id: int, msg_id: int, body: bytes) -> bool:
        ok = self.transport.send(conn_id, msg_id, body)
        if ok:
            self.counters.count_out(msg_id, len(body))
        return ok

    def send_pb(self, conn_id: int, msg_id: int, msg: Message,
                player_id: Optional[Ident] = None,
                clients: Optional[List[Ident]] = None) -> bool:
        env = MsgBase(
            player_id=player_id or Ident(),
            msg_data=msg.encode(),
            player_client_list=clients or [],
        )
        return self.send_raw(conn_id, msg_id, env.encode())

    def broadcast_pb(self, msg_id: int, msg: Message,
                     player_id: Optional[Ident] = None) -> None:
        for conn_id in list(self.conn_tags):
            self.send_pb(conn_id, msg_id, msg, player_id=player_id)

    def close_conn(self, conn_id: int) -> None:
        self.transport.close_conn(conn_id)
        self.conn_tags.pop(conn_id, None)

    # ------------------------------------------------------------ pump
    def execute(self) -> None:
        self.dispatch.feed(self.transport.poll())

    def shut(self) -> None:
        self.transport.close()

    @property
    def num_connections(self) -> int:
        return len(self.conn_tags)


# connection-pool FSM states (NFINetClientModule.hpp ConnectDataState)
DISCONNECT, CONNECTING, NORMAL, RECONNECT = 0, 1, 2, 3


@dataclasses.dataclass
class ServerData:
    server_id: int
    server_type: int
    ip: str
    port: int
    name: str = ""
    state: int = DISCONNECT
    last_attempt: float = 0.0
    client: object = None  # transport client
    attempts: int = 0  # consecutive failed dials (resets on connect)


class NetClientModule:
    """Outbound connection pool with consistent-hash routing."""

    def __init__(self, backend: str = "auto",
                 reconnect_seconds: float = RECONNECT_SECONDS,
                 keepalive_seconds: float = KEEPALIVE_SECONDS,
                 retry: Optional[RetryPolicy] = None) -> None:
        self._backend = backend
        self.servers: Dict[int, ServerData] = {}
        self.ring: ConsistentHash[int] = ConsistentHash()
        self.counters = NetCounters()
        self.dispatch = _Dispatch(counters=self.counters)
        # reconnect_seconds doubles as the CONNECTING timeout and, when
        # no explicit policy is given, the RetryPolicy base delay
        self.reconnect_seconds = reconnect_seconds
        self.retry = retry if retry is not None else RetryPolicy(base=reconnect_seconds)
        self.keepalive_seconds = keepalive_seconds
        # re-dial attempts after a failure, per server id (telemetry:
        # nf_reconnects_total samples this lazily)
        self.retries_total: Dict[int, int] = {}
        # chaos seam: wraps each freshly-created transport client
        # (fn(client, server_data) -> client); see net/chaos.py
        self.transport_wrapper: Optional[Callable] = None
        self._last_keepalive = 0.0
        self._keepalive_fns: List[Callable[[], None]] = []
        self._connected_fns: List[Callable[[int], None]] = []

    # -------------------------------------------------------- topology
    def add_server(self, server_id: int, server_type: int, ip: str,
                   port: int, name: str = "") -> None:
        """Register a target endpoint (AddServer,
        `NFINetClientModule.hpp:90-110`); connection happens in execute()."""
        if server_id in self.servers:
            return
        self.servers[server_id] = ServerData(server_id, server_type, ip, port, name)
        self.ring.add(str(server_id), server_id)

    def remove_server(self, server_id: int) -> None:
        sd = self.servers.pop(server_id, None)
        if sd is not None:
            if sd.client is not None:
                sd.client.close()
            self.ring.remove(str(server_id))

    # -------------------------------------------------------- registry
    def on(self, msg_id: int, fn: ReceiveHandler) -> None:
        """Handler receives (server_id, msg_id, body)."""
        self.dispatch.on(msg_id, fn)

    def on_any(self, fn: ReceiveHandler) -> None:
        self.dispatch.on_any(fn)

    def on_connected(self, fn: Callable[[int], None]) -> None:
        self._connected_fns.append(fn)

    def on_keepalive(self, fn: Callable[[], None]) -> None:
        """Called every keepalive period (the ServerInfoReport hook)."""
        self._keepalive_fns.append(fn)

    # ------------------------------------------------------------ send
    def send_by_server_id(self, server_id: int, msg_id: int, body: bytes) -> bool:
        sd = self.servers.get(server_id)
        if sd is None or sd.state != NORMAL:
            return False
        ok = sd.client.send_msg(msg_id, body)
        if ok:
            self.counters.count_out(msg_id, len(body))
        return ok

    def send_pb_by_server_id(self, server_id: int, msg_id: int, msg: Message,
                             player_id: Optional[Ident] = None,
                             clients: Optional[List[Ident]] = None) -> bool:
        env = MsgBase(player_id=player_id or Ident(), msg_data=msg.encode(),
                      player_client_list=clients or [])
        return self.send_by_server_id(server_id, msg_id, env.encode())

    def send_by_suit(self, key: str, msg_id: int, body: bytes) -> bool:
        """Consistent-hash routing (`SendBySuit`,
        `NFINetClientModule.hpp:214-239`)."""
        sid = self.ring.get(key)
        return sid is not None and self.send_by_server_id(sid, msg_id, body)

    def send_to_all(self, msg_id: int, body: bytes,
                    server_type: Optional[int] = None) -> int:
        n = 0
        for sd in self.servers.values():
            if server_type is not None and sd.server_type != server_type:
                continue
            if self.send_by_server_id(sd.server_id, msg_id, body):
                n += 1
        return n

    def connected_servers(self, server_type: Optional[int] = None) -> List[int]:
        return [
            sd.server_id
            for sd in self.servers.values()
            if sd.state == NORMAL
            and (server_type is None or sd.server_type == server_type)
        ]

    # ------------------------------------------------------------ pump
    def execute(self, now: Optional[float] = None) -> None:
        now = _time.monotonic() if now is None else now
        for sd in self.servers.values():
            self._pump_link(sd, now)
        if now - self._last_keepalive >= self.keepalive_seconds:
            self._last_keepalive = now
            for fn in self._keepalive_fns:
                fn()

    def _pump_link(self, sd: ServerData, now: float) -> None:
        if sd.state in (DISCONNECT, RECONNECT):
            if sd.state == RECONNECT:
                # capped exponential backoff with deterministic jitter
                # replaces the reference's fixed 10 s timer
                wait = self.retry.delay(sd.attempts, key=sd.server_id)
                if now - sd.last_attempt < wait:
                    return
                self.retries_total[sd.server_id] = (
                    self.retries_total.get(sd.server_id, 0) + 1
                )
            if sd.client is not None:
                sd.client.close()
            client = create_client(sd.ip, sd.port, backend=self._backend)
            if self.transport_wrapper is not None:
                client = self.transport_wrapper(client, sd)
            sd.client = client
            sd.client.connect()
            sd.state = CONNECTING
            sd.last_attempt = now
            sd.attempts += 1
            return
        events = sd.client.poll()
        for ev in events:
            if ev.kind == EV_CONNECTED:
                sd.state = NORMAL
                sd.attempts = 0  # reset-on-success: next failure backs off from base
                for fn in self._connected_fns:
                    fn(sd.server_id)
            elif ev.kind == EV_DISCONNECTED:
                sd.state = RECONNECT
                sd.last_attempt = now
            elif ev.kind == EV_MSG:
                # present the *server id* as the connection identity
                self.dispatch.feed(
                    [NetEvent(EV_MSG, sd.server_id, ev.msg_id, ev.body)]
                )
        if sd.state == CONNECTING and now - sd.last_attempt > self.reconnect_seconds:
            sd.client.disconnect()
            sd.state = RECONNECT
            sd.last_attempt = now

    def shut(self) -> None:
        for sd in self.servers.values():
            if sd.client is not None:
                sd.client.close()
