"""Host-side span tracing: ring buffer + Chrome trace-event export.

Counterpart of ``noahgameframe_tpu/telemetry/tracing.py``.  Two timelines
answer "where does a tick go":

- DEVICE stages: the kernel runs every phase of the step under
  ``torch.profiler.record_function`` (``nf.schedule``, ``nf.phase.*``,
  ``nf.diff``), so a ``torch.profiler`` trace attributes each launch to
  its stage (:func:`device_annotation` is the same range for host code).
- HOST framing: this tracer records wall-clock spans (dispatch, summary
  fetch, post-tick fan-out) into a fixed-size ring buffer and exports
  them as Chrome trace-event JSON, which ``chrome://tracing`` and
  Perfetto load directly.

The tracer is disabled by default: ``span()`` then returns a shared
no-op context manager, so instrumented hot paths pay one attribute read
and a truthiness check per span.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

_NULL_CTX = contextlib.nullcontext()


class _Span:
    """Re-entrant-safe timed block writing one complete ("X") event."""

    __slots__ = ("tracer", "name", "args", "t0")

    def __init__(self, tracer: "SpanTracer", name: str, args: Optional[dict]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        self.tracer._record(self.name, self.t0, t1 - self.t0, self.args)


class SpanTracer:
    """Fixed-capacity ring buffer of (name, ts, dur) spans."""

    def __init__(self, capacity: int = 65536, enabled: bool = False) -> None:
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._events: List[tuple] = []  # (name, ts_ns, dur_ns, tid, args)
        self._head = 0  # next write slot once the ring is full
        self._lock = threading.Lock()
        self._epoch_ns = time.perf_counter_ns()

    # ------------------------------------------------------------ record
    def span(self, name: str, **args):
        """Context manager timing a block; no-op when disabled."""
        if not self.enabled:
            return _NULL_CTX
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker event."""
        if not self.enabled:
            return
        self._record(name, time.perf_counter_ns(), -1, args or None)

    def _record(self, name: str, t0_ns: int, dur_ns: int,
                args: Optional[dict]) -> None:
        ev = (name, t0_ns, dur_ns, threading.get_ident(), args)
        with self._lock:
            if len(self._events) < self.capacity:
                self._events.append(ev)
            else:
                self._events[self._head] = ev
                self._head = (self._head + 1) % self.capacity

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._head = 0
            self._epoch_ns = time.perf_counter_ns()

    def __len__(self) -> int:
        return len(self._events)

    @property
    def epoch_ns(self) -> int:
        """perf_counter_ns at construction/clear — ts=0 in the export.
        To merge same-clock tracers, pass
        ``offset_us=(tracer.epoch_ns - ref_epoch_ns) / 1e3``."""
        return self._epoch_ns

    # ------------------------------------------------------------ export
    def events(self) -> List[tuple]:
        """Chronological (name, ts_ns, dur_ns, tid, args) tuples."""
        with self._lock:
            ring = self._events[self._head:] + self._events[:self._head]
        return ring

    def chrome_trace(self, process_name: str = "noahgameframe_tpu_torch",
                     pid: Optional[int] = None,
                     offset_us: float = 0.0) -> dict:
        """Chrome trace-event JSON object (Perfetto/about:tracing).

        ``pid`` overrides the OS pid so several tracers captured in one
        process (LocalCluster roles) still render as distinct Perfetto
        process tracks; ``offset_us`` shifts all timestamps onto a
        reference clock so a multi-process merge lines up.
        """
        pid = os.getpid() if pid is None else int(pid)
        tid_map: Dict[int, int] = {}
        trace_events: List[dict] = [
            {
                "ph": "M", "pid": pid, "tid": 0,
                "name": "process_name",
                "args": {"name": process_name},
            }
        ]
        for name, ts_ns, dur_ns, tid, args in self.events():
            small_tid = tid_map.setdefault(tid, len(tid_map) + 1)
            ev = {
                "name": name,
                "pid": pid,
                "tid": small_tid,
                # trace-event timestamps are microseconds
                "ts": (ts_ns - self._epoch_ns) / 1000.0 + offset_us,
            }
            if dur_ns < 0:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = dur_ns / 1000.0
            if args:
                ev["args"] = {k: _jsonable(v) for k, v in args.items()}
            trace_events.append(ev)
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    def export(self, path: str, process_name: str = "noahgameframe_tpu_torch") -> int:
        """Write the Chrome trace JSON; returns the span count."""
        doc = self.chrome_trace(process_name)
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"]) - 1  # minus the metadata event


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def device_annotation(name: str):
    """A named range on the ``torch.profiler`` timeline
    (``record_function``), beside the device launches it encloses."""
    from torch.profiler import record_function

    return record_function(name)
