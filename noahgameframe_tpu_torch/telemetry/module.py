"""TelemetryModule: one registry per world, every world source wired in.

Counterpart of ``noahgameframe_tpu/telemetry/module.py``.  Sources are
sampled lazily at scrape time:

- frame latency: :class:`~noahgameframe_tpu_torch.utils.metrics.TickMetrics`
  observing into ``nf_frame_seconds``, plus the quantile gauges
  ``nf_frame_latency_ms``;
- the kernel's on-device counter bank (``nf_tick_counters_total`` /
  ``nf_tick_counters``), decoded from the summary each observed tick
  already fetches;
- the train counters ``nf_train_{dispatches,ticks,fetch_bytes}_total``;
- the Verlet caches (``nf_grid_*``), the memory census (``nf_census``,
  ``nf_device_bytes``) and per-class live rows (``nf_entities_live``);
- the cost book: ``nf_recompiles_total{entry,cause}``,
  ``nf_compiles_total`` (captures), ``nf_compile_seconds_total``
  (warm-up plus capture), ``nf_graph_launches_per_replay``, the
  ``nf_hbm_*`` memory gauges, the per-entry cost gauges
  ``nf_entry_{flops,bytes_accessed,temp_bytes}`` (no samples until an
  entry carries a cost record);
- a role's net sources: per-opcode ``nf_net_msgs_total`` /
  ``nf_net_bytes_total`` (direction/link/opcode labels) from every
  NetServerModule and NetClientModule pool (:meth:`add_net_source`), the
  proxy's relay counters, ``nf_reconnects_total`` per pool
  (:meth:`add_pool_source`) and the ``nf_role_info`` identity gauge
  (:meth:`attach_role`);
- the injected faults of a cluster's ChaosDirector (net/chaos.py),
  ``nf_chaos_faults_total{link,kind}`` (:meth:`add_chaos_source`).

:meth:`mount` routes ``/metrics`` and ``/costbook`` on a net/http.py
HttpServer; ServerRole.serve_metrics() starts a dedicated one.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, Optional, Tuple

from ..kernel.module import Module
from .costbook import CostBook
from .registry import MetricsRegistry
from .tracing import SpanTracer


class TelemetryModule(Module):
    name = "TelemetryModule"

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 window: int = 512) -> None:
        super().__init__()
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = SpanTracer(enabled=False)
        from ..utils.metrics import MemoryCensus, TickMetrics

        self.tick = TickMetrics(
            window=window,
            histogram=self.registry.histogram(
                "nf_frame_seconds", "main-loop frame latency (seconds)", window=window,
            ),
        )
        self.census = MemoryCensus()
        # replaced by the kernel's book in attach_kernel
        self.costbook = CostBook()
        self._net_sources: Dict[str, object] = {}
        self._pool_sources: Dict[str, object] = {}  # link -> NetClientModule
        self._chaos_sources: list = []  # (link prefix, ChaosDirector)
        self._kernel_attached = False
        self._role_attached = False
        reg = self.registry
        reg.register_callback(
            "nf_net_msgs_total", lambda: self._net_samples(0),
            kind="counter", help="messages per link/direction/opcode",
        )
        reg.register_callback(
            "nf_net_bytes_total", lambda: self._net_samples(1),
            kind="counter", help="payload bytes per link/direction/opcode",
        )
        reg.register_callback(
            "nf_relay_msgs_total", lambda: self._relay_samples(0),
            kind="counter", help="proxy-forwarded messages per link/opcode",
        )
        reg.register_callback(
            "nf_relay_seconds_total", lambda: self._relay_samples(1),
            kind="counter", help="cumulative proxy forward latency per link/opcode",
        )
        reg.register_callback(
            "nf_chaos_faults_total", self._chaos_samples, kind="counter",
            help="injected faults per link and kind (net/chaos.py)",
        )
        reg.register_callback(
            "nf_reconnects_total", self._pool_samples, kind="counter",
            help="re-dial attempts after a link failure, per pool/server",
        )
        reg.register_callback(
            "nf_frame_latency_ms", self._frame_quantiles, kind="gauge",
            help="frame latency quantiles in ms (exact, window-based)",
        )
        # the lambdas read self.costbook at scrape time, so adopting the
        # kernel's book retargets every series
        reg.register_callback(
            "nf_recompiles_total", lambda: self.costbook.recompile_samples(),
            kind="counter", help="re-captures per entry with cause attribution",
        )
        reg.register_callback(
            "nf_compiles_total", lambda: self.costbook.compile_samples(0),
            kind="counter", help="captures per entry (the first included)",
        )
        reg.register_callback(
            "nf_compile_seconds_total", lambda: self.costbook.compile_samples(1),
            kind="counter", help="cumulative warm-up plus capture wall seconds per entry",
        )
        reg.register_callback(
            "nf_graph_launches_per_replay", lambda: self.costbook.launch_samples(),
            kind="gauge", help="device launches of one replay of each entry's CUDA graph",
        )
        # the cost gauges read an entry's cost record; no capture record
        # carries one yet, so they have no samples on the port
        reg.register_callback(
            "nf_entry_flops", lambda: self.costbook.cost_samples("flops"),
            kind="gauge", help="FLOPs of each entry's latest cost record",
        )
        reg.register_callback(
            "nf_entry_bytes_accessed", lambda: self.costbook.cost_samples("bytes_accessed"),
            kind="gauge", help="bytes accessed per entry (latest cost record)",
        )
        reg.register_callback(
            "nf_entry_temp_bytes", lambda: self.costbook.cost_samples("temp_bytes"),
            kind="gauge", help="temp buffer bytes per entry (latest cost record)",
        )
        reg.register_callback(
            "nf_hbm_bytes_in_use", lambda: self._hbm("live_bytes", fresh=True),
            kind="gauge", help="device allocator live bytes",
        )
        reg.register_callback(
            "nf_hbm_peak_bytes", lambda: self._hbm("peak_bytes"), kind="gauge",
            help="device allocator peak bytes since the last reset",
        )
        reg.register_callback(
            "nf_hbm_bytes_limit", lambda: self._hbm("limit_bytes"), kind="gauge",
            help="device memory capacity (0 when unknown)",
        )

    def _hbm(self, key: str, fresh: bool = False) -> Iterable[Tuple[dict, float]]:
        hbm = self.costbook.hbm if (self.costbook.hbm and not fresh) else \
            self.costbook.hbm_sample()
        yield ({}, float(hbm.get(key, 0)))

    def _frame_quantiles(self) -> Iterable[Tuple[dict, float]]:
        h = self.tick.hist
        for q in (50, 95, 99):
            yield ({"quantile": f"p{q}"}, h.percentile(q) * 1e3)

    def add_net_source(self, link: str, counters) -> None:
        """Register a NetCounters (net/module.py) under a link label."""
        self._net_sources[str(link)] = counters

    def add_pool_source(self, link: str, pool) -> None:
        """Register a NetClientModule whose ``retries_total`` feeds
        ``nf_reconnects_total`` under a link label."""
        self._pool_sources[str(link)] = pool

    def _pool_samples(self) -> Iterable[Tuple[dict, float]]:
        for link, pool in sorted(self._pool_sources.items()):
            for sid in sorted(pool.retries_total):
                yield ({"link": link, "server_id": str(sid)}, pool.retries_total[sid])

    def add_chaos_source(self, director, prefix: str = "") -> None:
        """Register a ChaosDirector (net/chaos.py); only links starting
        with `prefix` are exposed (one role sees its own links)."""
        self._chaos_sources.append((str(prefix), director))

    def _chaos_samples(self) -> Iterable[Tuple[dict, float]]:
        for prefix, director in self._chaos_sources:
            for link in sorted(director.counts):
                if prefix and not link.startswith(prefix):
                    continue
                for kind, v in sorted(director.counts[link].items()):
                    yield ({"link": link, "kind": kind}, v)

    def _net_samples(self, which: int) -> Iterable[Tuple[dict, float]]:
        for link, c in sorted(self._net_sources.items()):
            for direction, d in (
                ("in", (c.in_msgs, c.in_bytes)[which]),
                ("out", (c.out_msgs, c.out_bytes)[which]),
            ):
                for opcode in sorted(d):
                    yield ({"link": link, "direction": direction, "opcode": str(opcode)},
                           d[opcode])

    def _relay_samples(self, which: int) -> Iterable[Tuple[dict, float]]:
        """which: 0 = relayed message count, 1 = forward latency seconds
        (NetCounters.count_relay; only a proxy feeds these)."""
        for link, c in sorted(self._net_sources.items()):
            msgs = getattr(c, "relay_msgs", None)
            if not msgs:
                continue
            for opcode in sorted(msgs):
                v = msgs[opcode] if which == 0 else c.relay_ns.get(opcode, 0) / 1e9
                yield ({"link": link, "opcode": str(opcode)}, v)

    def attach_role(self, role) -> None:
        """Wire a ServerRole: identity gauge + its net counter sources.
        (Frame timing attaches by the role adopting ``self.tick``.)"""
        if self._role_attached:
            return
        self._role_attached = True
        info = self.registry.gauge(
            "nf_role_info", "role identity (value is always 1)", ("role", "server_id"),
        )
        info.set(1, role=type(role).__name__, server_id=str(role.config.server_id))
        self.add_net_source("server", role.server.counters)

    def attach_kernel(self, kernel) -> None:
        """Wire a Kernel: counter bank, train counters, ticks, entities,
        census, Verlet caches, and its cost book."""
        if self._kernel_attached or kernel is None:
            return
        self._kernel_attached = True
        self.census.kernel = kernel
        self.tick.kernel = kernel
        # one tracer for the kernel's spans and its cost book's, its
        # spans stamped with the kernel's tick count as their frame
        kernel.tracer = self.tracer
        kernel.costbook.tracer = self.tracer
        self.tracer.frame_source = lambda: kernel.tick_count
        self.costbook = kernel.costbook
        self.costbook.host_census = self.census.device_bytes
        reg = self.registry
        reg.register_callback(
            "nf_ticks_total", lambda: kernel.tick_count, kind="counter",
            help="world ticks advanced (tick + run_device + train)",
        )
        reg.register_callback(
            "nf_tick_counters_total",
            lambda: (({"counter": k}, v) for k, v in sorted(kernel.counter_totals.items())),
            kind="counter", help="on-device counter bank, cumulative over observed ticks",
        )
        reg.register_callback(
            "nf_tick_counters",
            lambda: (({"counter": k}, v) for k, v in sorted(kernel.last_counters.items())),
            kind="gauge", help="on-device counter bank, last observed tick",
        )
        for attr, what in (("dispatches", "K-tick train dispatches"),
                           ("ticks", "ticks advanced by train dispatches"),
                           ("fetch_bytes", "summary bytes fetched by trains")):
            reg.register_callback(
                f"nf_train_{attr}_total",
                (lambda a=attr: getattr(kernel, f"train_{a}")),
                kind="counter", help=what,
            )
        reg.register_callback(
            "nf_entities_live",
            lambda: (({"class": c}, kernel.store.live_count(c))
                     for c in kernel.store.class_order) if kernel.store is not None else (),
            kind="gauge", help="live entity rows per class",
        )
        reg.register_callback(
            "nf_census",
            lambda: (({"kind": k}, v) for k, v in sorted(self.census.census().items())),
            kind="gauge", help="memory census: live objects per kind",
        )
        reg.register_callback(
            "nf_device_bytes", self.census.device_bytes, kind="gauge",
            help="bytes held on the world's device",
        )
        reg.register_callback(
            "nf_grid_rebuilds_total", lambda: self._verlet_samples(0), kind="counter",
            help="binning rebuilds per Verlet-cached grid",
        )
        reg.register_callback(
            "nf_grid_rebuild_interval_ticks", lambda: self._verlet_samples(3),
            kind="gauge", help="mean ticks between rebuilds (builds+reuses per build)",
        )
        reg.register_callback(
            "nf_grid_staleness_ticks", lambda: self._verlet_samples(2), kind="gauge",
            help="ticks since each Verlet grid's last rebuild (cache age)",
        )

    def _verlet_samples(self, which: int) -> Iterable[Tuple[dict, float]]:
        """which: 0=rebuilds, 1=reuses, 2=age, 3=mean rebuild interval."""
        kernel = self.census.kernel
        state = getattr(kernel, "state", None)
        for key, cache in sorted((getattr(state, "aux", None) or {}).items()):
            if not key.startswith("verlet/"):
                continue
            grid = key[len("verlet/"):]
            if which == 3:
                reb, reu = float(cache.rebuilds), float(cache.reuses)
                yield ({"grid": grid}, (reb + reu) / max(reb, 1.0))
            else:
                v = (cache.rebuilds, cache.reuses, cache.age)[which]
                yield ({"grid": grid}, float(v))

    def after_init(self) -> None:
        self.attach_kernel(self.kernel)

    def costbook_handler(self, _path=None, _params=None):
        """HTTP handler for ``/costbook``: the book's full snapshot with a
        fresh device-memory census folded in."""
        self.costbook.hbm_sample()
        body = json.dumps(self.costbook.snapshot()).encode()
        return 200, "application/json", body

    def mount(self, http) -> None:
        """Route /metrics and /costbook on an existing HttpServer."""
        http.route("/metrics", self.registry.handler)
        http.route("/costbook", self.costbook_handler)

    def exposition(self) -> str:
        return self.registry.exposition()
