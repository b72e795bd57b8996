"""Host-side span tracing: ring buffer + Chrome trace-event export.

Counterpart of ``noahgameframe_tpu/telemetry/tracing.py``.  Two timelines
answer "where does a tick go":

- DEVICE stages: the kernel runs every phase of the step under
  ``torch.profiler.record_function`` (``nf.schedule``, ``nf.phase.*``,
  ``nf.diff``), so a ``torch.profiler`` trace attributes each launch to
  its stage (:func:`device_annotation` is the same range for host code).
  While a step is captured under :func:`device_marks` (the cost book does
  so when its tracer is on), each outermost range also records a timing
  event at its end: the captured graph then times its own phases on
  every replay (:class:`DeviceMarks`), with no profiler.
- HOST framing: this tracer records wall-clock spans (frame, dispatch,
  the cost book's key and copy-in, graph replay, capture, world build,
  summary fetch, post-tick fan-out) into a fixed-size ring buffer and
  exports them as Chrome trace-event JSON, which ``chrome://tracing`` and
  Perfetto load directly.  Each span records the span it ran inside on
  its thread and the frame it belongs to (``frame_source``, the kernel's
  ``tick_count`` once a kernel owns the tracer).

Spans are stamped with ``time.perf_counter_ns``.  Turning the tracer on
(or :meth:`SpanTracer.clear`) pairs that clock with the wall clock, the
clock ``torch.profiler`` exports on, so :meth:`SpanTracer.chrome_trace`
can place the spans on a profiler trace's own timeline
(``base_time_ns``, the trace's ``baseTimeNanoseconds``).

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
from contextvars import ContextVar
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple


class _NullSpan:
    """The disabled tracer's span: enters and exits doing nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **args) -> None:
        return None


_NULL_CTX = _NullSpan()


class SpanEvent(NamedTuple):
    """One recorded span (``dur_ns`` -1 for an instant).  ``parent`` is
    the id of the span it ran inside on its thread (0 at the top) and
    ``frame`` the tracer's ``frame_source()`` when it began (None
    without one)."""

    name: str
    ts_ns: int
    dur_ns: int
    tid: int
    args: Optional[dict]
    id: int
    parent: int
    frame: Optional[int]


class _Span:
    """Timed block writing one complete ("X") event."""

    __slots__ = ("tracer", "name", "args", "t0", "id", "parent", "frame")

    def __init__(self, tracer: "SpanTracer", name: str, args: Optional[dict]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0

    def __enter__(self) -> "_Span":
        tr = self.tracer
        self.id, self.parent, self.frame = tr._open()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        tr = self.tracer
        tr._stack().pop()
        tr._record(SpanEvent(self.name, self.t0, t1 - self.t0, threading.get_ident(),
                             self.args, self.id, self.parent, self.frame))

    def set(self, **args) -> None:
        """Add arguments to the span (a count known only at its end)."""
        self.args = {**(self.args or {}), **args}


class SpanTracer:
    """Fixed-capacity ring buffer of spans (:class:`SpanEvent`)."""

    def __init__(self, capacity: int = 65536, enabled: bool = False) -> None:
        self.capacity = int(capacity)
        self._events: List[SpanEvent] = []
        self._head = 0  # next write slot once the ring is full
        self._lock = threading.Lock()
        self._local = threading.local()
        self._next_id = 0
        #: the frame a span belongs to, read when it begins (the kernel's
        #: tick count once a kernel owns the tracer)
        self.frame_source: Optional[Callable[[], int]] = None
        self._epoch_ns = time.perf_counter_ns()
        self._anchor = _clock_pair()
        self._enabled = False
        self.enabled = enabled

    def __bool__(self) -> bool:
        # a tracer is a tracer, with or without spans recorded yet
        return True

    @property
    def enabled(self) -> bool:
        return self._enabled

    @enabled.setter
    def enabled(self, on: bool) -> None:
        on = bool(on)
        if on and not self._enabled:
            self._anchor = _clock_pair()
        self._enabled = on

    # ------------------------------------------------------------ record
    def span(self, name: str, **args):
        """Context manager timing a block; no-op when disabled."""
        if not self._enabled:
            return _NULL_CTX
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker event."""
        if not self._enabled:
            return
        sid, parent, frame = self._open()
        self._stack().pop()
        self._record(SpanEvent(name, time.perf_counter_ns(), -1, threading.get_ident(),
                               args or None, sid, parent, frame))

    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _open(self) -> Tuple[int, int, Optional[int]]:
        """A new span's id, its parent's id, and its frame; pushes it."""
        with self._lock:
            self._next_id += 1
            sid = self._next_id
        st = self._stack()
        parent = st[-1] if st else 0
        st.append(sid)
        src = self.frame_source
        return sid, parent, (None if src is None else int(src()))

    def _record(self, ev: SpanEvent) -> None:
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
            self._anchor = _clock_pair()

    def __len__(self) -> int:
        return len(self._events)

    @property
    def epoch_ns(self) -> int:
        """perf_counter_ns at construction/clear — ts=0 in the export.
        To merge same-clock tracers, pass
        ``offset_us=(tracer.epoch_ns - ref_epoch_ns) / 1e3``."""
        return self._epoch_ns

    # ------------------------------------------------------------ read
    def events(self) -> List[SpanEvent]:
        """Chronological spans, by their end (a span is recorded when it
        ends, so a parent follows its children)."""
        with self._lock:
            ring = self._events[self._head:] + self._events[:self._head]
        return ring

    def self_ns(self, span: SpanEvent, spans: Optional[List[SpanEvent]] = None) -> int:
        """``span``'s duration less what its children cover (``spans``:
        the events to look for children in, by default all of them)."""
        kids = sum(e.dur_ns for e in (spans if spans is not None else self.events())
                   if e.parent == span.id and e.dur_ns > 0)
        return span.dur_ns - kids

    # ------------------------------------------------------------ export
    def chrome_trace(self, process_name: str = "noahgameframe_tpu_torch",
                     pid: Optional[int] = None,
                     offset_us: float = 0.0,
                     base_time_ns: Optional[int] = None) -> dict:
        """Chrome trace-event JSON object (Perfetto/about:tracing).

        ``pid`` overrides the OS pid so several tracers captured in one
        process (LocalCluster roles) still render as distinct Perfetto
        process tracks; ``offset_us`` shifts all timestamps onto a
        reference clock so a multi-process merge lines up.  With
        ``base_time_ns`` (a ``torch.profiler`` trace's
        ``baseTimeNanoseconds``) the timestamps are on that trace's
        clock instead: the wall clock less ``base_time_ns``, plus
        ``offset_us``.  Each span's args carry its ``id``, ``parent`` and
        ``frame``.
        """
        pid = os.getpid() if pid is None else int(pid)
        if base_time_ns is None:
            zero_ns = self._epoch_ns
        else:
            wall, perf = self._anchor
            zero_ns = int(base_time_ns) - wall + perf
        tid_map: Dict[int, int] = {}
        trace_events: List[dict] = [
            {
                "ph": "M", "pid": pid, "tid": 0,
                "name": "process_name",
                "args": {"name": process_name},
            }
        ]
        for e in self.events():
            small_tid = tid_map.setdefault(e.tid, len(tid_map) + 1)
            ev = {
                "name": e.name,
                "pid": pid,
                "tid": small_tid,
                # trace-event timestamps are microseconds
                "ts": (e.ts_ns - zero_ns) / 1000.0 + offset_us,
            }
            if e.dur_ns < 0:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = e.dur_ns / 1000.0
            args = {k: _jsonable(v) for k, v in (e.args or {}).items()}
            args.update(id=e.id, parent=e.parent, frame=e.frame)
            ev["args"] = args
            trace_events.append(ev)
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    def export(self, path: str, process_name: str = "noahgameframe_tpu_torch") -> int:
        """Write the Chrome trace JSON; returns the span count."""
        doc = self.chrome_trace(process_name)
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"]) - 1  # minus the metadata event


def _clock_pair() -> Tuple[int, int]:
    """(wall ns, perf_counter ns) read together: the wall clock between
    two reads of the counter, paired with their midpoint."""
    p0 = time.perf_counter_ns()
    wall = time.time_ns()
    p1 = time.perf_counter_ns()
    return wall, (p0 + p1) // 2


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class DeviceMarks:
    """Timing events recorded on the current stream at the boundaries of
    a step: ``mark(name)`` ends the span ``name`` that began at the
    previous mark.  Recorded while a CUDA graph captures (``external``
    events, one event-record node each), the graph re-records them on
    every replay; :meth:`spans` reads the last replay's, once the caller
    has synchronised."""

    def __init__(self) -> None:
        self.names: List[str] = []
        self.events: list = []
        self._depth = 0  # device_annotation ranges open

    def mark(self, name: str) -> None:
        import torch

        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        self.names.append(name)
        self.events.append(ev)

    def spans(self) -> List[Tuple[str, float]]:
        """``(name, ms)`` from each mark to the next, named by the later."""
        ev = self.events
        return [(self.names[i], ev[i - 1].elapsed_time(ev[i])) for i in range(1, len(ev))]


_MARKS: ContextVar[Optional[DeviceMarks]] = ContextVar("nf_device_marks", default=None)


@contextlib.contextmanager
def device_marks(marks: Optional[DeviceMarks]):
    """``with device_marks(marks):`` every outermost
    :func:`device_annotation` range inside the block marks ``marks`` at
    its end (None: no marks)."""
    token = _MARKS.set(marks)
    try:
        yield marks
    finally:
        _MARKS.reset(token)


class _MarkedRange:
    """A profiler range that marks its :class:`DeviceMarks` at its end
    when it is the outermost one open."""

    __slots__ = ("rf", "marks", "name")

    def __init__(self, rf, marks: DeviceMarks, name: str) -> None:
        self.rf, self.marks, self.name = rf, marks, name

    def __enter__(self):
        self.marks._depth += 1
        return self.rf.__enter__()

    def __exit__(self, *exc):
        out = self.rf.__exit__(*exc)
        self.marks._depth -= 1
        if self.marks._depth == 0:
            self.marks.mark(self.name)
        return out


def device_annotation(name: str):
    """A named range on the ``torch.profiler`` timeline
    (``record_function``), beside the device launches it encloses; under
    :func:`device_marks`, the outermost range also marks the device's
    time at its end."""
    from torch.profiler import record_function

    marks = _MARKS.get()
    if marks is None:
        return record_function(name)
    return _MarkedRange(record_function(name), marks, name)
