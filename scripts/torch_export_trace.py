#!/usr/bin/env python
"""Capture a Chrome trace-event JSON of a benchmark world run on the
PyTorch port.

    python scripts/torch_export_trace.py --ticks 100 --out nf_trace.json
    python scripts/torch_export_trace.py --device cpu --profile prof_dir

The port's copy of ``scripts/export_trace.py``.  Open the result in
Perfetto (https://ui.perfetto.dev) or chrome://tracing.  The host-side
spans come from the SpanTracer the kernel dispatch/fetch/post stages
record into (telemetry/tracing.py).  For the DEVICE timeline use
``--profile DIR`` (the JAX script's ``--xprof DIR``): it wraps the run
in ``utils/metrics.profiler_trace``, a ``torch.profiler`` capture
written to ``DIR/trace.json``, whose ranges carry the per-stage names
(``nf.schedule``, ``nf.phase.*``, ``nf.diff``) and, on a CUDA device,
the hand kernels (``combat_fold_kernel``, and ``fused_neighborhood_kernel``
under ``NF_PALLAS=2``).  The world runs on ``--device`` (default
``cuda``; without a card that raises).

Merge mode stitches per-role trace JSONs into ONE Perfetto timeline
with aligned clocks:

    python scripts/torch_export_trace.py --merge game.json proxy.json \
        --offsets-us 0,1234.5 --out cluster.json

Offsets come from the master's /pipeline endpoint
(``clock_offsets_ns``, NTP-style sliding-min estimates) or, for
same-machine tracers, from ``SpanTracer.epoch_ns`` deltas.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def merge_files(paths, offsets_us, out: Path) -> int:
    """Merge chrome-trace JSON docs into one timeline; returns event count."""
    import json

    from noahgameframe_tpu_torch.telemetry.pipeline import merge_chrome_traces

    docs = [json.loads(Path(p).read_text()) for p in paths]
    merged = merge_chrome_traces(docs, offsets_us=offsets_us)
    out.write_text(json.dumps(merged))
    return len(merged["traceEvents"])


def run(entities: int = 1024, ticks: int = 100, out=Path("nf_trace.json"),
        profile=None, device=None) -> dict:
    """Tick ``build_benchmark_world(entities)`` on ``device`` (``None`` =
    ``"cuda"``) ``ticks`` times with the span tracer on (and, with
    ``profile``, under a ``torch.profiler`` capture written to
    ``profile/trace.json``); writes the spans to ``out``.  Returns the
    span count, the paths written and the device."""
    import contextlib

    from noahgameframe_tpu_torch.game.world import build_benchmark_world
    from noahgameframe_tpu_torch.utils.metrics import profiler_trace

    world = build_benchmark_world(entities, device=device)
    tracer = world.telemetry.tracer
    tracer.enabled = True
    k = world.kernel

    k.tick()  # capture outside the trace
    tracer.clear()

    prof = (profiler_trace(str(profile)) if profile is not None
            else contextlib.nullcontext())
    with prof:
        for _ in range(ticks):
            with tracer.span("tick", tick=k.tick_count):
                k.tick()
    n = tracer.export(str(out))
    return {"spans": n, "ticks": ticks, "out": str(out), "device": str(k.device),
            "profile": None if profile is None else str(Path(profile) / "trace.json")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--entities", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--out", type=Path, default=Path("nf_trace.json"))
    ap.add_argument("--device", default=None, help="the world's device (default cuda)")
    ap.add_argument("--profile", type=Path, default=None,
                    help="also wrap the run in a torch.profiler capture "
                         "written to this dir as trace.json")
    ap.add_argument("--merge", nargs="+", type=Path, default=None,
                    metavar="TRACE_JSON",
                    help="merge existing chrome-trace files into --out "
                         "instead of running a capture")
    ap.add_argument("--offsets-us", type=str, default=None,
                    help="comma-separated per-file clock offsets (µs) "
                         "added to each merged file's timestamps")
    args = ap.parse_args()

    if args.merge is not None:
        offsets = ([float(x) for x in args.offsets_us.split(",")]
                   if args.offsets_us else None)
        if offsets is not None and len(offsets) != len(args.merge):
            ap.error("--offsets-us must list one offset per --merge file")
        n = merge_files(args.merge, offsets, args.out)
        print(f"merged {len(args.merge)} traces ({n} events) into {args.out}")
        return 0

    info = run(args.entities, args.ticks, args.out, args.profile, args.device)
    print(f"wrote {info['spans']} spans over {args.ticks} ticks to {args.out}")
    if args.profile is not None:
        print(f"device profile in {info['profile']} (open it in Perfetto)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
