"""TelemetryModule: one registry per world, every world source wired in.

Counterpart of the parts of ``noahgameframe_tpu/telemetry/module.py``
that a world has (the net, pool, chaos and role sources come with the
serving edge).  Sources are sampled lazily at scrape time:

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
  (warm-up plus capture), ``nf_graph_launches_per_replay`` and the
  ``nf_hbm_*`` memory gauges.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

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
        self._kernel_attached = False
        reg = self.registry
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

    def attach_kernel(self, kernel) -> None:
        """Wire a Kernel: counter bank, train counters, ticks, entities,
        census, Verlet caches, and its cost book."""
        if self._kernel_attached or kernel is None:
            return
        self._kernel_attached = True
        self.census.kernel = kernel
        self.tick.kernel = kernel
        kernel.tracer = self.tracer
        self.costbook = kernel.costbook
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

    def exposition(self) -> str:
        return self.registry.exposition()
