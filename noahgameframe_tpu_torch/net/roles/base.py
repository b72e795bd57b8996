"""Server-role scaffolding: config, registration, report plumbing.

The reference deploys five process roles (Master/Login/World/Proxy/Game),
each a `NFPluginLoader` instance whose net plugins read `Server.xml`
(`_Out/NFDataCfg/Ini/NPC/Server.xml:3-8` — attributes ID/Type/IP/Port/
MaxOnline/CpuCount/Name) and then keep the cluster wired by three
mechanisms (SURVEY §3.5):

- register on connect: client module sends `*_REGISTERED` with a
  ServerInfoReportList describing itself;
- refresh every 10 s: `*_REFRESH` + `STS_SERVER_REPORT` keepalives
  (`NFINetClientModule.hpp:395-405`);
- upstream fan-in: World relays game/proxy reports to Master
  (`NFCWorldNet_ServerModule.cpp:36`), Master aggregates + serves JSON.

`ServerRole` is the shared shell: one listening `NetServerModule`,
any number of upstream `NetClientModule`s, a pump, and report helpers.
Roles are pump-driven and single-threaded like the reference main loop.

A copy of ``noahgameframe_tpu/net/roles/base.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import time as _time
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Optional

from ..defines import MsgID, ServerState, ServerType
from ..module import NetClientModule, NetServerModule
from ..wire import (
    Ident,
    MsgBase,
    ServerInfoExt,
    ServerInfoReport,
    ServerInfoReportList,
    unwrap,
    wrap,
)


@dataclasses.dataclass
class RoleConfig:
    """One server instance's identity + endpoint (Server.xml row)."""

    server_id: int
    server_type: int
    name: str = ""
    ip: str = "127.0.0.1"
    port: int = 0
    max_online: int = 5000
    cpu_count: int = 1
    # upstream endpoints this role dials out to (master for login/world,
    # world for proxy/game); filled from the cluster's Server.xml
    targets: List["RoleConfig"] = dataclasses.field(default_factory=list)


def load_server_xml(path: Path) -> List[RoleConfig]:
    """Parse a reference-format Server.xml: <XML><Server ID=.. Type=..
    IP=.. Port=.. MaxOnline=.. CpuCount=.. Name=../>...</XML>.

    Type may be a ServerType name ("GAME") or its integer value."""
    root = ET.parse(str(path)).getroot()
    out: List[RoleConfig] = []
    for node in root.findall("Server"):
        t = node.get("Type", "0")
        try:
            server_type = int(t)
        except ValueError:
            server_type = int(ServerType[t.upper()])
        out.append(
            RoleConfig(
                server_id=int(node.get("ID", "0")),
                server_type=server_type,
                name=node.get("Name", ""),
                ip=node.get("IP", "127.0.0.1"),
                port=int(node.get("Port", "0")),
                max_online=int(node.get("MaxOnline", "5000")),
                cpu_count=int(node.get("CpuCount", "1")),
            )
        )
    return out


class ServerRole:
    """Base for the five roles: listening endpoint + upstream links."""

    server_type: int = int(ServerType.NONE)

    def __init__(self, config: RoleConfig, backend: str = "auto") -> None:
        self.config = config
        self.server = NetServerModule(config.ip, config.port, backend=backend)
        config.port = self.server.port  # resolve ephemeral port
        self.backend = backend
        self.clients: Dict[str, NetClientModule] = {}
        self.state = int(ServerState.NORMAL)
        # telemetry: one registry per role.  A role that owns a world
        # (GameRole sets self.game_world before super().__init__) adopts
        # the world's TelemetryModule so /metrics includes the kernel's
        # counter bank alongside role/net metrics — ONE registry, never
        # two disagreeing ones.
        from ...telemetry.module import TelemetryModule

        gw = getattr(self, "game_world", None)
        tel = getattr(gw, "telemetry", None)
        self.telemetry: TelemetryModule = (
            tel if tel is not None else TelemetryModule()
        )
        # frame-latency window; run_role's loop (and any operator pump)
        # wraps role.execute in metrics.frame() — percentiles ride the
        # 10 s report's ext map up to the master dashboard AND the
        # nf_frame_seconds histogram on /metrics (same samples)
        self.metrics = self.telemetry.tick
        self.telemetry.attach_role(self)
        self.telemetry.attach_kernel(getattr(self, "kernel", None))
        self._metrics_http = None
        self._install()

    # hook for subclasses to register handlers
    def _install(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    # ---------------------------------------------------------- helpers
    def add_upstream(self, key: str, targets: List[RoleConfig],
                     register_msg: Optional[int] = None,
                     refresh_msg: Optional[int] = None) -> NetClientModule:
        """Create a client pool dialing `targets`; auto-send registration
        on connect and refresh on the 10 s keepalive."""
        pool = NetClientModule(backend=self.backend)
        for t in targets:
            pool.add_server(t.server_id, t.server_type, t.ip, t.port, t.name)
        if register_msg is not None:
            pool.on_connected(
                lambda sid: pool.send_by_server_id(
                    sid, int(register_msg), wrap(self.report_list())
                )
            )
        if refresh_msg is not None:
            pool.on_keepalive(
                lambda: pool.send_to_all(int(refresh_msg), wrap(self.report_list()))
            )
        self.clients[key] = pool
        self.telemetry.add_net_source(key, pool.counters)
        self.telemetry.add_pool_source(key, pool)
        return pool

    def serve_metrics(self, port: int = 0,
                      host: Optional[str] = None):
        """Expose /metrics on a dedicated HttpServer (for roles without a
        status server; Master mounts onto its existing /json server
        instead).  Pumped from execute(); returns the server (inspect
        ``.port`` when asking for an ephemeral one)."""
        if self._metrics_http is None:
            from ..http import HttpServer

            self._metrics_http = HttpServer(
                host if host is not None else self.config.ip, port
            )
            self.telemetry.mount(self._metrics_http)
        return self._metrics_http

    def cur_count(self) -> int:
        """Load metric reported upstream; roles override (players online,
        connections, …)."""
        return self.server.num_connections

    def report(self) -> ServerInfoReport:
        c = self.config
        r = ServerInfoReport(
            server_id=c.server_id,
            server_name=c.name.encode() if isinstance(c.name, str) else c.name,
            server_ip=c.ip.encode(),
            server_port=c.port,
            server_max_online=c.max_online,
            server_cur_count=self.cur_count(),
            server_state=self.state,
            server_type=self.server_type,
        )
        ext = ServerInfoExt()
        # clock-sync echo: the sender's monotonic stamp lets
        # the master estimate per-role clock offsets NTP-style (sliding
        # min of recv - sent over the heartbeat stream)
        ext.key.append(b"mono_ns")
        ext.value.append(str(_time.perf_counter_ns()).encode())
        if self.metrics.frames:
            p = self.metrics.percentiles()
            for k in ("p50_ms", "p95_ms", "p99_ms"):
                ext.key.append(f"frame_{k}".encode())
                ext.value.append(f"{p[k]:.3f}".encode())
        r.server_info_list_ext = ext
        return r

    def report_list(self) -> ServerInfoReportList:
        return ServerInfoReportList(server_list=[self.report()])

    def ident(self) -> Ident:
        return Ident(svrid=self.config.server_id, index=0)

    # ---------------------------------------------------------- pump
    def execute(self, now: Optional[float] = None) -> None:
        now = _time.monotonic() if now is None else now
        self.server.execute()
        for pool in self.clients.values():
            pool.execute(now)
        if self._metrics_http is not None:
            self._metrics_http.execute()

    def run(self, seconds: float, sleep: float = 0.001) -> None:
        end = _time.monotonic() + seconds
        while _time.monotonic() < end:
            self.execute()
            _time.sleep(sleep)

    def shut(self) -> None:
        self.server.shut()
        for pool in self.clients.values():
            pool.shut()
        if self._metrics_http is not None:
            self._metrics_http.close()
            self._metrics_http = None


def decode_reports(body: bytes) -> List[ServerInfoReport]:
    """Unwrap a MsgBase-enveloped ServerInfoReportList."""
    _, payload = unwrap(body, ServerInfoReportList)
    return list(payload.server_list)


def report_to_dict(r: ServerInfoReport) -> dict:
    d = {
        "server_id": r.server_id,
        "name": _s(r.server_name),
        "ip": _s(r.server_ip),
        "port": r.server_port,
        "max_online": r.server_max_online,
        "cur_count": r.server_cur_count,
        "state": int(r.server_state),
        "type": int(r.server_type),
    }
    ext = r.server_info_list_ext
    if ext is not None and ext.key:
        d["ext"] = {_s(k): _s(v) for k, v in zip(ext.key, ext.value)}
    return d


def _s(v) -> str:
    return v.decode("utf-8", "replace") if isinstance(v, (bytes, bytearray)) else str(v)
