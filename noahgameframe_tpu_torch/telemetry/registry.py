"""Prometheus-style metrics registry with text-format exposition.

A copy of ``noahgameframe_tpu/telemetry/registry.py`` (pure Python; the
port imports nothing of the JAX package), so both packages expose the
same text for the same updates.

Only what the stack needs is implemented (the same economy as
net/http.py): counters, gauges, histograms, callback-backed collectors,
and the text exposition format v0.0.4 — enough for a Prometheus scrape
of ``/metrics`` or the web monitor's regex parser.  No third-party
client library: the container must not grow dependencies, and the whole
surface is ~200 lines.

Design points:

- Metrics are cheap to update on the hot path (dict bump / deque
  append); all formatting cost is paid at scrape time.
- :class:`Histogram` owns BOTH the cumulative-bucket exposition and the
  exact percentile math over a bounded sample window — the single
  source of truth for every p50/p95/p99 in the repo (bench JSON, role
  reports, /metrics can never disagree).
- :class:`CallbackMetric` samples an external source lazily at scrape
  time (kernel counter bank totals, net counter dicts, memory census) —
  zero per-tick cost for anything nobody is scraping.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Callable, Deque, Dict, Iterable, Optional, Sequence, Tuple

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# frame/tick latency buckets in seconds: sub-ms host pumps up to
# multi-second 1M-entity compiles land in a real bucket
DEFAULT_TIME_BUCKETS_S = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

LabelValues = Tuple[str, ...]
Sample = Tuple[str, Dict[str, str], float]  # (name suffix, labels, value)


def escape_label_value(v: str) -> str:
    """Escape a label value per the exposition format: backslash,
    double-quote and newline."""
    return (
        str(v)
        .replace("\\", r"\\")
        .replace("\n", r"\n")
        .replace('"', r"\"")
    )


def _escape_help(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


def _fmt_value(v: float) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def format_sample(name: str, labels: Dict[str, str], value: float) -> str:
    if labels:
        body = ",".join(
            f'{k}="{escape_label_value(v)}"' for k, v in sorted(labels.items())
        )
        return f"{name}{{{body}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


class Metric:
    """Base: a named family yielding (suffix, labels, value) samples."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)

    def _key(self, labels: Dict[str, str]) -> LabelValues:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != "
                f"declared {sorted(self.labelnames)}"
            )
        return tuple(str(labels[k]) for k in self.labelnames)

    def samples(self) -> Iterable[Sample]:  # pragma: no cover - overridden
        return ()

    def expose(self) -> str:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        for suffix, labels, value in self.samples():
            lines.append(format_sample(self.name + suffix, labels, value))
        return "\n".join(lines)


class Counter(Metric):
    """Monotonically increasing value, optionally per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()) -> None:
        super().__init__(name, help, labelnames)
        self._values: Dict[LabelValues, float] = {}
        # metrics may be bumped from several threads: the
        # read-modify-write below must not lose increments
        self._mu = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counter decrease ({amount})")
        key = self._key(labels)
        with self._mu:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        return self._values.get(self._key(labels), 0.0)

    def samples(self) -> Iterable[Sample]:
        if not self._values and not self.labelnames:
            yield ("", {}, 0.0)
            return
        for key in sorted(self._values):
            yield ("", dict(zip(self.labelnames, key)), self._values[key])


class Gauge(Metric):
    """Value that can go up and down; optionally backed by a callable."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()) -> None:
        super().__init__(name, help, labelnames)
        self._values: Dict[LabelValues, float] = {}
        self._fn: Optional[Callable[[], float]] = None
        self._mu = threading.Lock()

    def set(self, value: float, **labels: str) -> None:
        with self._mu:
            self._values[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._mu:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set_function(self, fn: Callable[[], float]) -> None:
        """Label-less gauge evaluated at scrape time."""
        self._fn = fn

    def value(self, **labels: str) -> float:
        if self._fn is not None and not labels:
            return float(self._fn())
        return self._values.get(self._key(labels), 0.0)

    def samples(self) -> Iterable[Sample]:
        if self._fn is not None:
            try:
                yield ("", {}, float(self._fn()))
            except Exception:  # noqa: BLE001 — a dead probe must not kill scrape
                yield ("", {}, float("nan"))
            return
        if not self._values and not self.labelnames:
            yield ("", {}, 0.0)
            return
        for key in sorted(self._values):
            yield ("", dict(zip(self.labelnames, key)), self._values[key])


class Histogram(Metric):
    """Cumulative-bucket histogram + exact percentiles over a window.

    The buckets serve Prometheus (quantile estimation server-side); the
    bounded deque window serves in-process consumers (role reports,
    bench JSON) that want exact percentiles without a scrape loop.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS_S,
                 window: int = 512) -> None:
        super().__init__(name, help, ())
        b = sorted(float(x) for x in buckets)
        if not b or math.isinf(b[-1]):
            raise ValueError("buckets must be finite and non-empty")
        self.buckets = tuple(b)
        self._counts = [0] * (len(b) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._window: Deque[float] = collections.deque(maxlen=window)
        # observe() runs a multi-field read-modify-write from both the
        # tick thread and the write-behind flusher; an unlocked race
        # drops counts and skews _sum 
        self._mu = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._mu:
            self._sum += v
            self._count += 1
            self._window.append(v)
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    # -- exact window math (the one percentile implementation) -----------
    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def window_values(self) -> list:
        with self._mu:
            return list(self._window)

    def window_mean(self) -> float:
        with self._mu:
            if not self._window:
                return 0.0
            return sum(self._window) / len(self._window)

    def percentile(self, p: float) -> float:
        """Exact p-th percentile (linear interpolation) over the sample
        window; 0.0 when empty."""
        with self._mu:
            vals = sorted(self._window)
        if not vals:
            return 0.0
        if len(vals) == 1:
            return vals[0]
        rank = (p / 100.0) * (len(vals) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(vals) - 1)
        frac = rank - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    def samples(self) -> Iterable[Sample]:
        with self._mu:  # consistent snapshot: sum/count/buckets agree
            counts = list(self._counts)
            total, n = self._sum, self._count
        cum = 0
        for ub, c in zip(self.buckets, counts):
            cum += c
            yield ("_bucket", {"le": _fmt_value(ub)}, float(cum))
        cum += counts[-1]
        yield ("_bucket", {"le": "+Inf"}, float(cum))
        yield ("_sum", {}, total)
        yield ("_count", {}, float(n))


class CallbackMetric(Metric):
    """Samples an external source at scrape time.

    ``fn`` returns either a plain number (label-less) or an iterable of
    ``(labels_dict, value)`` pairs.  Used for sources that already keep
    their own counters (kernel counter bank, net opcode dicts, census).
    """

    def __init__(self, name: str, fn: Callable[[], object],
                 kind: str = "gauge", help: str = "") -> None:
        super().__init__(name, help, ())
        self.kind = kind
        self._fn = fn

    def samples(self) -> Iterable[Sample]:
        try:
            out = self._fn()
        except Exception:  # noqa: BLE001 — a dead source must not kill scrape
            return
        if isinstance(out, (int, float)):
            yield ("", {}, float(out))
            return
        for labels, value in out:
            yield ("", dict(labels), float(value))


class MetricsRegistry:
    """Named metric collection with Prometheus text exposition."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    # -------------------------------------------------------- factories
    def register(self, metric: Metric) -> Metric:
        with self._lock:
            cur = self._metrics.get(metric.name)
            if cur is metric:
                return metric
            if cur is not None:
                raise ValueError(f"metric {metric.name!r} already registered")
            self._metrics[metric.name] = metric
        return metric

    def _get_or_make(self, cls, name: str, **kwargs) -> Metric:
        with self._lock:
            cur = self._metrics.get(name)
            if cur is not None:
                if not isinstance(cur, cls):
                    raise ValueError(
                        f"metric {name!r} exists with kind {cur.kind!r}"
                    )
                return cur
            m = cls(name, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help=help, labelnames=labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help=help, labelnames=labelnames)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS_S,
                  window: int = 512) -> Histogram:
        return self._get_or_make(
            Histogram, name, help=help, buckets=buckets, window=window
        )

    def register_callback(self, name: str, fn: Callable[[], object],
                          kind: str = "gauge", help: str = "") -> CallbackMetric:
        m = CallbackMetric(name, fn, kind=kind, help=help)
        self.register(m)
        return m

    # ---------------------------------------------------------- queries
    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def value(self, name: str, **labels: str) -> float:
        """Read one sample back out (tests, bench JSON).  For callback
        metrics the labels must match a yielded sample exactly."""
        m = self._metrics.get(name)
        if m is None:
            raise KeyError(name)
        if isinstance(m, (Counter, Gauge)):
            return m.value(**labels)
        want = {k: str(v) for k, v in labels.items()}
        for suffix, lbls, value in m.samples():
            if suffix == "" and lbls == want:
                return value
        raise KeyError(f"{name}{labels}")

    # ------------------------------------------------------- exposition
    def exposition(self) -> str:
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return "\n".join(m.expose() for m in metrics) + "\n"

    def handler(self, _path: str = "", _params: Optional[dict] = None):
        """An HttpServer route handler serving this registry."""
        return (200, CONTENT_TYPE, self.exposition().encode("utf-8"))
