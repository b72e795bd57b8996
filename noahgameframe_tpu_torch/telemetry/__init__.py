"""Telemetry: metrics registry, span tracing, the cost book, and the
world's wiring of them (``module.TelemetryModule``).  Counterpart of
``noahgameframe_tpu/telemetry`` with its exports."""


from .registry import (
    CallbackMetric,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    escape_label_value,
)
from .costbook import CostBook, roofline_fold
from .tracing import SpanTracer
from .module import TelemetryModule

__all__ = [
    "CallbackMetric",
    "CostBook",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SpanTracer",
    "TelemetryModule",
    "escape_label_value",
    "roofline_fold",
]
