"""Per-frame timing, the memory census and the profiler hook.

Counterpart of ``noahgameframe_tpu/utils/metrics.py``.  The timing window
and all percentile math live in
:class:`~noahgameframe_tpu_torch.telemetry.registry.Histogram`:
:class:`TickMetrics` is a frame-timing facade over one histogram, so a
report, the bench line and a ``/metrics`` scrape read the same numbers
from the same samples.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Optional

import torch

from ..core.tree import flatten
from ..kernel.module import Module
from ..telemetry.registry import Histogram


class TickMetrics(Module):
    """Rolling window of frame timings: p50/p95/p99, entities per second,
    and a JSON line."""

    name = "TickMetrics"

    def __init__(self, window: int = 512,
                 histogram: Optional[Histogram] = None) -> None:
        super().__init__()
        self.window = window
        self.hist = histogram if histogram is not None else Histogram(
            "nf_frame_seconds", "main-loop frame latency", window=window
        )
        self._t0: Optional[float] = None
        self.frames = 0

    def frame_start(self) -> None:
        self._t0 = time.perf_counter()

    def frame_end(self) -> None:
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.frames += 1
        self.hist.observe(dt)

    @contextlib.contextmanager
    def frame(self):
        self.frame_start()
        try:
            yield
        finally:
            self.frame_end()

    def _mean_s(self) -> float:
        return self.hist.window_mean()

    def percentiles(self) -> Dict[str, float]:
        if not self.hist.count:
            return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0, "mean_ms": 0.0}
        return {
            "p50_ms": self.hist.percentile(50) * 1e3,
            "p95_ms": self.hist.percentile(95) * 1e3,
            "p99_ms": self.hist.percentile(99) * 1e3,
            "mean_ms": self._mean_s() * 1e3,
        }

    def live_entities(self) -> int:
        if self.kernel is None:
            return 0
        return sum(self.kernel.store.live_count(c) for c in self.kernel.store.class_order)

    def entities_per_second(self) -> float:
        mean_s = self._mean_s()
        return self.live_entities() / mean_s if mean_s > 0 else 0.0

    def snapshot(self) -> Dict[str, float]:
        out = dict(self.percentiles())
        out["frames"] = self.frames
        out["entities_per_s"] = self.entities_per_second()
        out["live"] = self.live_entities()
        return out

    def json_line(self) -> str:
        return json.dumps(self.snapshot())


class MemoryCensus(Module):
    """Live-object census per kind: entity rows per class from the store
    allocators, plus host-side registries registered as probes.
    :meth:`device_bytes` reads the CUDA allocator on a card and the
    world state's own tensor bytes on the CPU."""

    name = "MemoryCensus"

    def __init__(self, log_module=None) -> None:
        super().__init__()
        self._probes: Dict[str, object] = {}
        # a failing probe reports -1 and is logged once per kind
        self.log_module = log_module
        self._failed_probes: set = set()

    def register_probe(self, kind: str, fn) -> None:
        """fn() -> int live count for a host-side object kind."""
        self._probes[kind] = fn
        self._failed_probes.discard(kind)

    def _log_probe_failure(self, kind: str, exc: Exception) -> None:
        if kind in self._failed_probes:
            return
        self._failed_probes.add(kind)
        msg = "memory census probe %r failed (reporting -1): %s: %s"
        args = (kind, type(exc).__name__, exc)
        if self.log_module is not None:
            self.log_module.warning(msg, *args)
        else:
            logging.getLogger("nf.metrics").warning(msg, *args)

    def census(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        if self.kernel is not None and self.kernel.store is not None:
            for c in self.kernel.store.class_order:
                out[f"entity:{c}"] = self.kernel.store.live_count(c)
        for kind, fn in self._probes.items():
            try:
                out[kind] = int(fn())
            except Exception as e:  # noqa: BLE001 — census must never throw
                self._log_probe_failure(kind, e)
                out[kind] = -1
        return out

    def device_bytes(self) -> int:
        """Bytes held on the world's device: the CUDA allocator's live
        bytes on a card, the world state's tensors on the CPU."""
        k = self.kernel
        if k is None or k.state is None:
            return 0
        if k.device.type == "cuda":
            return int(torch.cuda.memory_allocated(k.device))
        seen = set()
        total = 0
        for x in flatten(k.state)[0]:
            if isinstance(x, torch.Tensor):
                st = x.untyped_storage()
                if st.data_ptr() not in seen:
                    seen.add(st.data_ptr())
                    total += st.nbytes()
        return total

    def json_line(self) -> str:
        out = dict(self.census())
        out["device_bytes"] = self.device_bytes()
        return json.dumps(out)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """``torch.profiler`` capture around a block (the JAX package's
    ``jax.profiler`` trace): CPU activity, and CUDA activity when a card
    is present.  Yields the profiler (``key_averages()`` sums by kernel)
    and writes a Chrome trace, ``<log_dir>/trace.json`` (open it in
    Perfetto), when the block ends, also when it raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
