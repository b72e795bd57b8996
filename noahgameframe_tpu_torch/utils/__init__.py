"""Infra utilities: logging, per-frame metrics, the profiler hook.
Counterpart of ``noahgameframe_tpu/utils``; its ``platform.py`` holds only
jax backend shims and has no port."""

from .log import LogLevel, LogModule  # noqa: F401
from .metrics import TickMetrics, profiler_trace  # noqa: F401
