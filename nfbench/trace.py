"""The device trace of a stretch of frames, and its reduction.

``Tracer`` runs ``torch.profiler`` with CUDA activity only (the device's
kernels, copies and fills, and the host's CUDA runtime calls) over the
frames it is started and stopped around, and writes the Chrome trace into
a temporary directory (``TMPDIR``).  Host operator recording is left off:
it slows every launch of the host, which would show as device idle time.
``reduce`` reads the trace back:

- the traced window: from the first event to the end of the last, that is
  from the first frame's first CUDA call to the end of the last frame's
  device sync;
- ``busy_s``: the union of the device's kernel, copy and fill intervals;
- ``device_s``: device seconds per operation name;
- ``idle_gaps``: the longest stretches with no device activity, each named
  by the host's CUDA call covering its middle (``host`` where the host ran
  no CUDA call: Python between calls).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation")


class Tracer:
    def __init__(self):
        self.prof = None
        self.frames = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        # without a card (the harness's CPU tests) the trace holds host
        # events only, and no device time
        on_card = torch.cuda.is_available()
        acts = [ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def stop(self, frames: int) -> None:
        self.prof.__exit__(None, None, None)
        self.frames = frames

    def result(self) -> dict:
        """Export the recorded trace and reduce it (after the window)."""
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self.prof = None
        out = reduce(events)
        out["frames"] = self.frames
        return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def reduce(events: List[dict], top: int = 10) -> dict:
    """Chrome trace events (``ts``, ``dur`` in microseconds) -> busy and
    window seconds, device seconds by name, and the longest idle gaps."""
    device: List[Tuple[float, float]] = []
    by_name: Dict[str, float] = {}
    host: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((a, b))
            name = e.get("name", "?")
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        elif cat in HOST_CATS:
            host.append((a, b, e.get("name", "?")))
    spans = device + [(a, b) for a, b, _ in host]
    if not spans:
        return {"busy_s": 0.0, "window_s": 0.0, "device_s": {},
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    w0 = min(a for a, _ in spans)
    w1 = max(b for _, b in spans)
    busy = _union(device)
    gaps = []
    cursor = w0
    for a, b in busy + [(w1, w1)]:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        covering = [(hb - ha, n) for ha, hb, n in host if ha <= mid <= hb]
        name = min(covering)[1] if covering else "host"
        named.append([name[:80], (b - a) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "device_s": by_name,
            "breakdown": {"device_ops": [[n[:80], s] for n, s in ops[:top]],
                          "idle_gaps": named}}
