"""Master role: cluster registry, rendezvous relay, status JSON + HTTP.

Reference: NFMasterServerPlugin / NFMasterNet_ServerPlugin /
NFMasterNet_HttpServerPlugin — handlers for world/login register+refresh
and server reports upsert per-type `ServerData` maps
(`NFCMasterNet_ServerModule.cpp:239-249,441-494`); the select-world
handshake is relayed Login→Master→World→Master→Login (`:187-203`);
`GetServersStatus` renders whole-cluster JSON served over evhttp
(`:496-640`, `NFCMasterNet_HttpJsonModule.cpp:22-82`).

A copy of ``noahgameframe_tpu/net/roles/master.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import html
import json as _json
import time as _time
from typing import Dict, Optional

from ...telemetry.pipeline import ClockSync

from ..defines import (
    LEASE_DOWN_SECONDS,
    LEASE_SUSPECT_SECONDS,
    MsgID,
    ServerState,
    ServerType,
)
from ..http import HttpServer
from ..module import EV_DISCONNECTED
from ..transport import EV_CONNECTED
from ..wire import (
    AckConnectWorldResult,
    ReqConnectWorld,
    ServerInfoReport,
    ServerInfoReportList,
    unwrap,
    wrap,
)
from .base import RoleConfig, ServerRole, decode_reports, report_to_dict


# heartbeat-lease states: every refresh/report renews the lease; a
# server that stops reporting ages UP -> SUSPECT -> DOWN (the reference
# lists dead entries forever — NFCMasterNet_ServerModule never expires)
LEASE_UP, LEASE_SUSPECT, LEASE_DOWN = "UP", "SUSPECT", "DOWN"


@dataclasses.dataclass
class _Registered:
    report: ServerInfoReport
    conn_id: int = -1  # -1: known only via relayed report (no direct link)
    last_seen: float = 0.0
    lease: str = LEASE_UP


class MasterRole(ServerRole):
    """The cluster brain: every other role registers here (directly or via
    World relay) and the web monitor reads the aggregate."""

    server_type = int(ServerType.MASTER)

    def __init__(self, config: RoleConfig, backend: str = "auto",
                 http_port: Optional[int] = None,
                 lease_suspect_seconds: float = LEASE_SUSPECT_SECONDS,
                 lease_down_seconds: float = LEASE_DOWN_SECONDS) -> None:
        # per-type registries: type -> server_id -> _Registered
        self.registry: Dict[int, Dict[int, _Registered]] = {}
        self.http: Optional[HttpServer] = None
        # chaos visibility: when a ChaosDirector is active the harness
        # points this at director.status so /json shows the fault-plan
        # seed + per-link budgets (replay can re-derive the chaos run)
        self.chaos_status = None  # Optional[Callable[[], dict]]
        # drill visibility: when a DrillRunner is attached the
        # harness points this at runner.status so /json shows the live
        # campaign clock, fired/remaining steps, and invariant breaches
        self.drill_status = None  # Optional[Callable[[], dict]]
        self.lease_suspect_seconds = lease_suspect_seconds
        self.lease_down_seconds = lease_down_seconds
        # per-role monotonic clock offsets estimated from the mono_ns
        # stamp every heartbeat report carries (frame observatory):
        # offset ≈ sliding min of (master recv − sender stamp)
        self.clock = ClockSync()
        super().__init__(config, backend=backend)
        reg = self.telemetry.registry
        self._lease_expirations = reg.counter(
            "nf_lease_expirations_total",
            "leases aged past the DOWN threshold", ("role",),
        )
        self._lease_recoveries = reg.counter(
            "nf_lease_recoveries_total",
            "DOWN servers seen reporting again", ("role",),
        )
        if http_port is not None:
            self.http = HttpServer(config.ip, http_port)
            self.http.route("/json", lambda _p, _q: self.servers_status())
            self.http.route("/pipeline", lambda _p, _q: self.pipeline_status())
            self.http.route("/", self._index_page)
            # Prometheus exposition rides the same status server
            self.telemetry.mount(self.http)
            # the cluster-aggregated costbook view shadows the mount's
            # per-role snapshot on the master (registered after mount so
            # the later route wins): operators want the fleet rollup here
            self.http.route("/costbook", lambda _p, _q: self.costbook_status())

    def _install(self) -> None:
        s = self.server
        for msg in (MsgID.MTL_WORLD_REGISTERED, MsgID.MTL_WORLD_REFRESH):
            s.on(msg, self._on_register(ServerType.WORLD))
        s.on(MsgID.MTL_WORLD_UNREGISTERED, self._on_unregister)
        for msg in (MsgID.LTM_LOGIN_REGISTERED, MsgID.LTM_LOGIN_REFRESH):
            s.on(msg, self._on_register(ServerType.LOGIN))
        s.on(MsgID.LTM_LOGIN_UNREGISTERED, self._on_unregister)
        s.on(MsgID.STS_SERVER_REPORT, self._on_report)
        s.on(MsgID.REQ_CONNECT_WORLD, self._on_req_connect_world)
        s.on(MsgID.ACK_CONNECT_WORLD, self._on_ack_connect_world)
        s.on_socket_event(self._on_socket)

    # ------------------------------------------------------ registration
    def _on_register(self, expect_type: ServerType):
        def handler(conn_id: int, _msg_id: int, body: bytes) -> None:
            for r in decode_reports(body):
                self._upsert(r, conn_id)
                self.server.conn_tags.setdefault(conn_id, {})["server_id"] = r.server_id
            if expect_type == ServerType.WORLD:
                self._push_world_list()
            elif expect_type == ServerType.LOGIN:
                self._send_world_list(conn_id)
        return handler

    def _on_unregister(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        for r in decode_reports(body):
            self.registry.get(int(r.server_type), {}).pop(r.server_id, None)
        self._push_world_list()

    def _on_report(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        """Game/proxy reports relayed up by World (`OnServerReport`)."""
        for r in decode_reports(body):
            self._upsert(r, -1)

    def _upsert(self, r: ServerInfoReport, conn_id: int) -> None:
        by_id = self.registry.setdefault(int(r.server_type), {})
        prev = by_id.get(r.server_id)
        recovered = prev is not None and prev.lease == LEASE_DOWN
        by_id[r.server_id] = _Registered(r, conn_id, _time.monotonic())
        # clock-sync echo: every report carries the sender's monotonic
        # stamp; min-filter (recv - sent) into the per-role offset
        sent = self._ext_of(r).get("mono_ns")
        if sent:
            try:
                self.clock.update(
                    f"{self._type_name(int(r.server_type))}{r.server_id}",
                    int(sent), _time.perf_counter_ns(),
                )
            except ValueError:
                pass  # garbled stamp: skip the sample
        if recovered:
            # a DOWN server reporting again has recovered (restart or
            # healed partition): count it and restore routing
            self._lease_recoveries.inc(role=self._type_name(int(r.server_type)))
            if int(r.server_type) == int(ServerType.WORLD):
                self._push_world_list()

    @staticmethod
    def _ext_of(r: ServerInfoReport) -> Dict[str, str]:
        """The report's ext map as str→str (wire carries bytes)."""
        ext = r.server_info_list_ext
        if ext is None or not ext.key:
            return {}
        def s(v):
            return (v.decode("utf-8", "replace")
                    if isinstance(v, (bytes, bytearray)) else str(v))
        return {s(k): s(v) for k, v in zip(ext.key, ext.value)}

    @staticmethod
    def _type_name(stype: int) -> str:
        try:
            return ServerType(stype).name.lower()
        except ValueError:
            return str(stype)

    def _sweep_leases(self, now: float) -> None:
        """Age every lease; flips feed the counters, DOWN marks the
        report CRASH and drops the server from routed lists (worlds
        vanish from the login list; world does the same for games)."""
        for stype, by_id in self.registry.items():
            for reg in by_id.values():
                age = now - reg.last_seen
                if age >= self.lease_down_seconds:
                    state = LEASE_DOWN
                elif age >= self.lease_suspect_seconds:
                    state = LEASE_SUSPECT
                else:
                    state = LEASE_UP
                if state == reg.lease:
                    continue
                reg.lease = state
                if state == LEASE_DOWN:
                    reg.report.server_state = int(ServerState.CRASH)
                    self._lease_expirations.inc(role=self._type_name(stype))
                    if stype == int(ServerType.WORLD):
                        self._push_world_list()

    def _on_socket(self, conn_id: int, kind: int) -> None:
        if kind != EV_DISCONNECTED:
            return
        # mark any server registered over this link as crashed
        # (the reference flips EServerState on link loss)
        for by_id in self.registry.values():
            for reg in by_id.values():
                if reg.conn_id == conn_id:
                    reg.report.server_state = int(ServerState.CRASH)
                    reg.conn_id = -1

    # ------------------------------------------------ world list to logins
    def _world_reports(self) -> ServerInfoReportList:
        worlds = self.registry.get(int(ServerType.WORLD), {})
        # DOWN worlds are evicted from the routed list (SUSPECT still
        # routes: one late heartbeat must not unseat a healthy server)
        return ServerInfoReportList(
            server_list=[
                reg.report for reg in worlds.values()
                if reg.lease != LEASE_DOWN
            ]
        )

    def _send_world_list(self, conn_id: int) -> None:
        self.server.send_raw(
            conn_id, int(MsgID.STS_NET_INFO), wrap(self._world_reports())
        )

    def _push_world_list(self) -> None:
        for conn_id, tags in self.server.conn_tags.items():
            sid = tags.get("server_id")
            if sid is None:
                continue
            logins = self.registry.get(int(ServerType.LOGIN), {})
            if sid in logins and logins[sid].conn_id == conn_id:
                self._send_world_list(conn_id)

    # ------------------------------------------------ select-world relay
    def _conn_of(self, server_type: ServerType, server_id: int) -> int:
        reg = self.registry.get(int(server_type), {}).get(server_id)
        return reg.conn_id if reg is not None else -1

    def _on_req_connect_world(self, conn_id: int, msg_id: int, body: bytes) -> None:
        """Login asks for a world slot → relay to that world
        (`OnSelectWorldProcess` `NFCMasterNet_ServerModule.cpp:187-203`)."""
        _, req = unwrap(body, ReqConnectWorld)
        target = self._conn_of(ServerType.WORLD, req.world_id)
        if target >= 0:
            self.server.send_raw(target, msg_id, body)

    def _on_ack_connect_world(self, conn_id: int, msg_id: int, body: bytes) -> None:
        """World answers with proxy endpoint + key → relay to the asking
        login (`OnSelectWorldResultsProcess`)."""
        _, ack = unwrap(body, AckConnectWorldResult)
        target = self._conn_of(ServerType.LOGIN, ack.login_id)
        if target >= 0:
            self.server.send_raw(target, msg_id, body)

    # ------------------------------------------------------ status JSON
    def servers_status(self) -> dict:
        """Whole-cluster aggregate (`GetServersStatus` JSON), one entry
        per server with its lease state and heartbeat age."""
        now = _time.monotonic()
        out: Dict[str, list] = {}
        for stype, by_id in sorted(self.registry.items()):
            key = self._type_name(stype)
            entries = []
            for _, reg in sorted(by_id.items()):
                d = report_to_dict(reg.report)
                d["lease"] = reg.lease
                d["last_seen_age_s"] = round(max(0.0, now - reg.last_seen), 3)
                entries.append(d)
            out[key] = entries
        status = {
            "master": report_to_dict(self.report()),
            "servers": out,
        }
        if self.chaos_status is not None:
            try:
                status["chaos"] = self.chaos_status()
            except Exception:  # noqa: BLE001 — a dead probe must not kill /json
                status["chaos"] = {"error": "chaos status unavailable"}
        if self.drill_status is not None:
            try:
                status["drill"] = self.drill_status()
            except Exception:  # noqa: BLE001 — a dead probe must not kill /json
                status["drill"] = {"error": "drill status unavailable"}
        # session-failover health: each world's heartbeat ext
        # carries pending re-homes + oldest-pending age; aggregate them
        # so operators see a stuck failover without scraping every world
        fo: Dict[str, dict] = {}
        for sid, reg in sorted(
            self.registry.get(int(ServerType.WORLD), {}).items()
        ):
            ext = self._ext_of(reg.report)
            if "failover_pending" not in ext:
                continue
            try:
                fo[str(sid)] = {
                    "pending": int(ext.get("failover_pending", "0")),
                    "lag_s": float(ext.get("failover_lag", "0")),
                }
            except ValueError:
                fo[str(sid)] = {"error": "unparseable failover ext"}
        if fo:
            status["failover"] = fo
        # compiled-cost health: each game's heartbeat ext carries a
        # compact CostBook summary; parse it into a structured block so
        # the dashboard shows recompiles/HBM without scraping every world
        cb = self._costbook_ext()
        if cb:
            status["costbook"] = cb
        # many-worlds occupancy: each game hosting a RoomDirectory ships
        # slot totals + per-room placement in its heartbeat ext; surface
        # them per game plus cluster-wide room totals
        rooms: Dict[str, dict] = {}
        for sid, reg in sorted(
            self.registry.get(int(ServerType.GAME), {}).items()
        ):
            blob = self._ext_of(reg.report).get("rooms")
            if not blob:
                continue
            try:
                rooms[str(sid)] = _json.loads(blob)
            except ValueError:
                rooms[str(sid)] = {"error": "unparseable rooms ext"}
        if rooms:
            status["rooms"] = {
                "games": rooms,
                "total_active": sum(
                    int(g.get("active", 0)) for g in rooms.values()
                    if isinstance(g.get("active", 0), int)),
                "total_slots_free": sum(
                    int(g.get("slots_free", 0)) for g in rooms.values()
                    if isinstance(g.get("slots_free", 0), int)),
            }
        return status

    def _costbook_ext(self) -> Dict[str, dict]:
        """Per-game CostBook summaries parsed from heartbeat ext blobs."""
        out: Dict[str, dict] = {}
        for sid, reg in sorted(
            self.registry.get(int(ServerType.GAME), {}).items()
        ):
            blob = self._ext_of(reg.report).get("costbook")
            if not blob:
                continue
            try:
                out[str(sid)] = _json.loads(blob)
            except ValueError:
                out[str(sid)] = {"error": "unparseable costbook ext"}
        return out

    def costbook_status(self) -> dict:
        """Cluster-wide compiled-cost view (/costbook): per-game CostBook
        summaries plus cluster totals — the aggregate sibling of the
        per-role /costbook snapshot served by TelemetryModule."""
        games = self._costbook_ext()
        totals = {"compiles": 0, "recompiles": 0, "compile_ms": 0.0,
                  "hbm_live_bytes": 0, "hbm_peak_bytes": 0}
        for g in games.values():
            if "error" in g:
                continue
            totals["compiles"] += int(g.get("compiles", 0))
            totals["recompiles"] += int(g.get("recompiles", 0))
            totals["compile_ms"] += float(g.get("compile_ms", 0.0))
            totals["hbm_live_bytes"] += int(g.get("hbm_live", 0) or 0)
            totals["hbm_peak_bytes"] += int(g.get("hbm_peak", 0) or 0)
        totals["compile_ms"] = round(totals["compile_ms"], 3)
        return {"totals": totals, "games": games}

    def pipeline_status(self) -> dict:
        """Frame-pipeline waterfall for the whole cluster (/pipeline):
        per-game stage timings + trace round trips and per-proxy relay
        percentiles, parsed from the heartbeat ext blobs, alongside the
        NTP-style per-role clock offsets for multi-process trace merges."""
        out: Dict[str, object] = {
            "clock_offsets_ns": self.clock.offsets(),
            "games": [],
            "proxies": [],
        }
        for stype, bucket in (
            (int(ServerType.GAME), "games"),
            (int(ServerType.PROXY), "proxies"),
        ):
            for sid, reg in sorted(self.registry.get(stype, {}).items()):
                ext = self._ext_of(reg.report)
                entry: Dict[str, object] = {
                    "server_id": sid,
                    "lease": reg.lease,
                }
                blob = ext.get("pipeline")
                if blob:
                    try:
                        entry["pipeline"] = _json.loads(blob)
                    except ValueError:
                        entry["pipeline"] = {"error": "unparseable blob"}
                for k in ("frame_p50_ms", "frame_p95_ms", "frame_p99_ms",
                          "relay_p50_ms", "relay_p95_ms", "traces_relayed"):
                    if k in ext:
                        entry[k] = ext[k]
                out[bucket].append(entry)  # type: ignore[union-attr]
        return out

    def _index_page(self, _path: str, _params: Dict[str, str]):
        """Dashboard at "/": serves the standalone monitor page
        (tools/web_monitor/index.html, the Tool/NF_Web_Monitor
        equivalent — a static page polling /json) and falls back to a
        server-rendered table when the file is missing."""
        from pathlib import Path

        page = (
            Path(__file__).resolve().parents[3]
            / "tools" / "web_monitor" / "index.html"
        )
        if page.is_file():
            return (200, "text/html", page.read_bytes())
        return self._fallback_page()

    def _fallback_page(self) -> str:
        """Server-rendered table (no-JS fallback)."""
        rows = []
        status = self.servers_status()
        for group, servers in status["servers"].items():
            for s in servers:
                try:
                    state = ServerState(s["state"]).name
                except ValueError:
                    state = str(s["state"])
                name = html.escape(str(s['name']))
                endpoint = html.escape(f"{s['ip']}:{s['port']}")
                lease = html.escape(str(s.get("lease", "?")))
                age = s.get("last_seen_age_s", 0.0)
                ext = s.get("ext", {})
                if "persist_lag_ticks" in ext:
                    persist = f"lag {html.escape(str(ext['persist_lag_ticks']))}"
                    if str(ext.get("persist_degraded", "0")) != "0":
                        persist += " <b>DEGRADED</b>"
                elif "failover_pending" in ext:
                    # world rows repurpose the column for failover health
                    persist = (
                        f"failover {html.escape(str(ext['failover_pending']))}"
                        f" pending, lag "
                        f"{html.escape(str(ext.get('failover_lag', '0')))}s"
                    )
                    if str(ext.get("failover_pending", "0")) != "0":
                        persist = f"<b>{persist}</b>"
                else:
                    persist = "&mdash;"
                rows.append(
                    f"<tr><td>{html.escape(group)}</td><td>{s['server_id']}</td>"
                    f"<td>{name}</td><td>{endpoint}</td>"
                    f"<td>{s['cur_count']}/{s['max_online']}</td>"
                    f"<td>{html.escape(str(state))}</td>"
                    f"<td>{lease} ({age:.1f}s)</td>"
                    f"<td>{persist}</td></tr>"
                )
        return (
            "<html><head><title>cluster status</title></head><body>"
            "<h2>Cluster status</h2>"
            "<table border=1 cellpadding=4><tr><th>role</th><th>id</th>"
            "<th>name</th><th>endpoint</th><th>load</th><th>state</th>"
            "<th>lease (heartbeat age)</th><th>persist</th></tr>"
            + "".join(rows)
            + "</table><p><a href='/json'>raw json</a></p></body></html>"
        )

    # ------------------------------------------------------------ pump
    def execute(self, now: Optional[float] = None) -> None:
        now = _time.monotonic() if now is None else now
        super().execute(now)
        self._sweep_leases(now)
        if self.http is not None:
            self.http.execute()

    def shut(self) -> None:
        super().shut()
        if self.http is not None:
            self.http.close()
