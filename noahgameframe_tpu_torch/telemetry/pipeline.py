"""Frame-pipeline attribution: stage clock, wire trace context, clock sync.

The frame observatory.  Three cooperating pieces:

- :class:`StageClock` — exclusive-time stage accounting for the served
  frame path (tick → diff harvest → interest query → encode → send).
  Nested stages subtract child time from the parent so the per-frame
  waterfall *sums* to the frame wall time (an explicit ``other`` bucket
  absorbs unattributed time).  Per-stage label-less histograms land in
  the role's :class:`~noahgameframe_tpu_torch.telemetry.registry.MetricsRegistry`.

- Trace context codec — a fixed-size little-endian header that rides
  sampled served frames as the ``msg_data`` of a ``FRAME_TRACE``
  MsgBase envelope.  The game stamps ``t_encode_ns``, the proxy stamps
  ``proxy_in_ns``/``proxy_out_ns`` in :meth:`_transpond`'s dispatch
  seam, the client stamps ``client_recv_ns`` and echoes the header back
  as ``FRAME_TRACE_ACK``.  All stamps are ``time.perf_counter_ns()``
  reads — monotonic, per-process clocks; cross-process deltas are only
  meaningful after :class:`ClockSync` alignment, while same-clock
  deltas (game RTT, proxy relay) are exact.

- :class:`ClockSync` — NTP-style min-delay filter over heartbeat
  echoes: each report carries the sender's monotonic stamp, the master
  records ``recv - sent`` and keeps a sliding minimum as the offset
  estimate (bias = one-way network delay of the luckiest sample).

Nothing here may feed the journal, the state digest, or any compiled
function — the nf-lint ``wall-clock`` rule scans this file and the
wire path for wall-clock leaks (docs/LINT.md), and ``tests/test_pipeline.py`` proves a
journaled run replays bit-identically with tracing on.

A copy of ``noahgameframe_tpu/telemetry/pipeline.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.  The
``wall-clock`` lint rule and ``tests/test_pipeline.py`` named above are the
JAX package's.
"""

from __future__ import annotations

import os
import struct
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "StageClock",
    "TraceContext",
    "TraceError",
    "TRACE_VERSION",
    "TRACE_SIZE",
    "encode_trace",
    "decode_trace",
    "trace_sample_n",
    "stage_timing_enabled",
    "ClockSync",
    "merge_chrome_traces",
]


# --------------------------------------------------------------------------
# env knobs
# --------------------------------------------------------------------------

def trace_sample_n(default: int = 64) -> int:
    """``NF_TRACE_SAMPLE``: trace 1-in-N sessions (0 disables).

    Defaults to 64 — cheap enough to stay on (one ~60-byte sidecar per
    sampled session per flush), so production captures always carry
    end-to-end latency without a redeploy.
    """
    try:
        return max(0, int(os.environ.get("NF_TRACE_SAMPLE", default)))
    except ValueError:
        return default


def stage_timing_enabled() -> bool:
    """``NF_STAGE_TIMING=1``: honest per-stage device timing.

    Inserts a ``torch.cuda.synchronize()`` after the tick dispatch so the
    ``kernel.dispatch`` span measures real device time instead of async
    dispatch latency (the JAX package blocks on the outputs there).  Never on by default — it serializes the device
    queue and de-fuses the production overlap.
    """
    return os.environ.get("NF_STAGE_TIMING", "0") == "1"


# --------------------------------------------------------------------------
# stage clock
# --------------------------------------------------------------------------

class _StageCtx:
    """Context manager for one stage interval (re-entrant per frame).

    Exclusive-time accounting: on exit the *full* interval is charged to
    the parent's child-counter while only ``interval - child_time`` is
    charged to this stage, so nesting ``send`` inside ``encode`` never
    double-counts.
    """

    __slots__ = ("_clock", "_name", "_t0", "_child_ns")

    def __init__(self, clock: "StageClock", name: str):
        self._clock = clock
        self._name = name
        self._t0 = 0
        self._child_ns = 0

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        self._child_ns = 0
        self._clock._stack.append(self)
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._t0
        clock = self._clock
        clock._stack.pop()
        clock._acc[self._name] = (
            clock._acc.get(self._name, 0) + dur - self._child_ns
        )
        if clock._stack:
            clock._stack[-1]._child_ns += dur
        return False


class StageClock:
    """Per-frame exclusive stage timing for the served pipeline.

    Usage (one frame)::

        sc.frame_begin(tick)
        with sc.stage("tick"): ...
        with sc.stage("encode"):
            with sc.stage("send"): ...   # excluded from "encode"
        sc.frame_end()

    ``frame_end`` freezes the waterfall into :attr:`last` (stage → ns,
    plus ``other`` = wall - attributed so the dict sums to
    :attr:`last_wall_ns` exactly) and feeds per-stage histograms.
    """

    STAGES: Tuple[str, ...] = ("tick", "migrate", "harvest", "interest",
                               "encode", "assemble", "send", "reshard",
                               "other")

    def __init__(self, registry=None, window: int = 512):
        self._acc: Dict[str, int] = {}
        self._stack: List[_StageCtx] = []
        # per-frame histogram divisors (stage -> int), cleared by
        # frame_begin: a K-tick train charges K frames of device work
        # to ONE "tick" stage span, so the banked histogram sample is
        # divided by K to stay per-tick comparable across NF_TICK_TRAIN
        # settings.  ONLY the histogram observation scales — the
        # waterfall (`last`, `other`, wall) stays exact.
        self._scale: Dict[str, int] = {}
        self._frame_t0 = 0
        self.last: Dict[str, int] = {}
        self.last_tick = -1
        self.last_wall_ns = 0
        self.frames = 0
        self._hists: Dict[str, object] = {}
        if registry is not None:
            for s in self.STAGES:
                self._hists[s] = registry.histogram(
                    f"nf_stage_{s}_seconds",
                    f"exclusive time of served-frame stage '{s}'",
                    window=window,
                )

    def stage(self, name: str) -> _StageCtx:
        return _StageCtx(self, name)

    def add_ns(self, name: str, ns: int) -> None:
        """Charge ``ns`` to ``name`` outside a context manager (and to the
        innermost open stage's child-counter, preserving exclusivity)."""
        self._acc[name] = self._acc.get(name, 0) + ns
        if self._stack:
            self._stack[-1]._child_ns += ns

    def set_scale(self, name: str, k: int) -> None:
        """Amortize this frame's ``name`` stage over ``k`` logical ticks
        when banking its histogram (``nf_stage_<name>_seconds`` stays a
        PER-TICK distribution under K-tick trains).  Resets each frame."""
        self._scale[name] = max(1, int(k))

    def frame_begin(self, tick: int) -> None:
        self._acc = {}
        self._stack = []
        self._scale = {}
        self.last_tick = int(tick)
        self._frame_t0 = time.perf_counter_ns()

    def frame_end(self) -> Dict[str, int]:
        wall = time.perf_counter_ns() - self._frame_t0
        acc = self._acc
        attributed = sum(acc.values())
        acc["other"] = max(0, wall - attributed)
        self.last = dict(acc)
        self.last_wall_ns = wall
        self.frames += 1
        for name, ns in acc.items():
            h = self._hists.get(name)
            if h is not None:
                h.observe(ns / 1e9 / self._scale.get(name, 1))
        return self.last

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per-stage p50/p95/mean in ms from the histogram windows."""
        out: Dict[str, Dict[str, float]] = {}
        for name, h in self._hists.items():
            if getattr(h, "count", 0) <= 0:
                continue
            out[name] = {
                "p50_ms": round(h.percentile(50.0) * 1e3, 4),
                "p95_ms": round(h.percentile(95.0) * 1e3, 4),
                "mean_ms": round(h.sum / max(1, h.count) * 1e3, 4),
            }
        return out


# --------------------------------------------------------------------------
# trace context codec
# --------------------------------------------------------------------------

TRACE_VERSION = 1

# version u8 | flags u8 | reserved u16 | game_id u32 | seq u32 |
# tick u64 | t_encode u64 | proxy_in u64 | proxy_out u64 | client_recv u64
_TRACE_STRUCT = struct.Struct("<BBHIIQQQQQ")
TRACE_SIZE = _TRACE_STRUCT.size  # 52 bytes


class TraceError(ValueError):
    """Malformed trace header (torn, oversize, or unknown version)."""


@dataclass
class TraceContext:
    tick: int
    game_id: int
    seq: int
    t_encode_ns: int
    proxy_in_ns: int = 0
    proxy_out_ns: int = 0
    client_recv_ns: int = 0
    flags: int = 0


_U64 = (1 << 64) - 1
_U32 = (1 << 32) - 1


def encode_trace(ctx: TraceContext) -> bytes:
    return _TRACE_STRUCT.pack(
        TRACE_VERSION, ctx.flags & 0xFF, 0,
        ctx.game_id & _U32, ctx.seq & _U32,
        ctx.tick & _U64, ctx.t_encode_ns & _U64,
        ctx.proxy_in_ns & _U64, ctx.proxy_out_ns & _U64,
        ctx.client_recv_ns & _U64,
    )


def decode_trace(buf: bytes) -> TraceContext:
    if len(buf) != TRACE_SIZE:
        raise TraceError(
            f"trace header is {len(buf)} bytes, want {TRACE_SIZE}")
    (version, flags, _reserved, game_id, seq, tick,
     t_encode, proxy_in, proxy_out, client_recv) = _TRACE_STRUCT.unpack(buf)
    if version != TRACE_VERSION:
        raise TraceError(f"unknown trace version {version}")
    return TraceContext(tick=tick, game_id=game_id, seq=seq,
                        t_encode_ns=t_encode, proxy_in_ns=proxy_in,
                        proxy_out_ns=proxy_out, client_recv_ns=client_recv,
                        flags=flags)


# --------------------------------------------------------------------------
# clock sync (master side)
# --------------------------------------------------------------------------

class ClockSync:
    """Per-source monotonic clock-offset estimation from one-way stamps.

    Every heartbeat report carries the sender's ``perf_counter_ns`` in
    its ext map; :meth:`update` records ``recv_ns - sent_ns`` =
    ``offset + network_delay``.  The sliding *minimum* over a window is
    the NTP-style estimate: delay is non-negative, so the min converges
    on ``offset + min_delay`` — biased high by the best-case one-way
    delay, which on a LAN is microseconds against millisecond frames.
    """

    def __init__(self, window: int = 64):
        self._window = max(1, int(window))
        self._samples: Dict[str, Deque[int]] = {}

    def update(self, key: str, sent_ns: int, recv_ns: int) -> None:
        d = self._samples.get(key)
        if d is None:
            d = self._samples[key] = deque(maxlen=self._window)
        d.append(int(recv_ns) - int(sent_ns))

    def offset_ns(self, key: str) -> Optional[int]:
        d = self._samples.get(key)
        return min(d) if d else None

    def offsets(self) -> Dict[str, int]:
        return {k: min(d) for k, d in sorted(self._samples.items()) if d}


# --------------------------------------------------------------------------
# multi-process chrome-trace merge
# --------------------------------------------------------------------------

def merge_chrome_traces(docs: Sequence[dict],
                        offsets_us: Optional[Sequence[float]] = None) -> dict:
    """Merge per-process chrome-trace docs into one Perfetto timeline.

    Each doc should already carry a distinct ``pid`` (see
    ``SpanTracer.chrome_trace(pid=...)``); ``offsets_us[i]`` shifts doc
    *i*'s timestamps onto the reference clock (use ``ClockSync`` offsets
    divided by 1e3).  Metadata events (``ph == "M"``) pass through
    unshifted — they carry no timestamp semantics.
    """
    merged: List[dict] = []
    for i, doc in enumerate(docs):
        shift = float(offsets_us[i]) if offsets_us else 0.0
        for ev in doc.get("traceEvents", []):
            if shift and ev.get("ph") != "M":
                ev = dict(ev)
                ev["ts"] = ev.get("ts", 0.0) + shift
            merged.append(ev)
    return {"traceEvents": merged, "displayTimeUnit": "ms"}
