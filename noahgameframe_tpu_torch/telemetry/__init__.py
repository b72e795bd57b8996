"""Telemetry: metrics registry, span tracing, the cost book, and the
world's wiring of them (``module.TelemetryModule``).  Counterpart of
``noahgameframe_tpu/telemetry``; the submodules are imported by path."""
