#!/usr/bin/env python
"""Capture a ``torch.profiler`` trace of the 1M graph tick on the PyTorch
port and tar it for offline op-level analysis.

    python scripts/torch_capture_trace.py [--entities 1000000] [--ticks 3]
        [--engine 2] [--device cuda] [--out chiprun_out/torch_trace_1m.tar.gz]

The port's copy of ``scripts/capture_trace.py``: the world of
``build_benchmark_world(entities, combat=True, seed=42)`` on ``--device``
(default ``cuda``; without a card that raises) runs ``run_device(1)``
once outside the trace (the CUDA-graph capture), then ``--ticks`` more
under ``utils/metrics.profiler_trace``.  The Chrome trace
(``trace/trace.json``) is tarred to ``--out``, by default under
``chiprun_out/`` (which git ignores), never into ``bench_runs/``.
``--engine 2`` runs the fold under ``NF_PALLAS=2`` (the fused kernel)
instead of the default engine 1.  Prints one JSON line: the traced wall,
the archive's size and the hand kernels the trace names.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tarfile
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REPO = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
#: the hand kernels' names as a trace shows them
KERNEL_NAMES = ("combat_fold", "fused_neighborhood")


def kernels_named(trace_json: str) -> dict:
    """How many trace events name each hand kernel."""
    with open(trace_json) as f:
        events = json.load(f).get("traceEvents", [])
    return {k: sum(1 for e in events if k in str(e.get("name", ""))) for k in KERNEL_NAMES}


def run(entities: int = 1_000_000, ticks: int = 3, out=None, engine=None,
        device=None) -> dict:
    """Trace ``ticks`` graph ticks of the benchmark world on ``device``
    (``None`` = ``"cuda"``) under ``NF_PALLAS=engine`` (``None`` leaves the
    knob as it is); writes the tarred trace to ``out`` (default
    ``chiprun_out/torch_trace_1m.tar.gz``) and returns the report line."""
    import torch

    from noahgameframe_tpu_torch.game import build_benchmark_world
    from noahgameframe_tpu_torch.utils.metrics import profiler_trace

    out = out or os.path.join(REPO, "chiprun_out", "torch_trace_1m.tar.gz")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    old = os.environ.get("NF_PALLAS")
    if engine is not None:
        os.environ["NF_PALLAS"] = str(engine)
    try:
        world = build_benchmark_world(entities, combat=True, seed=42, device=device)
        k = world.kernel

        def sync():
            if k.device.type == "cuda":
                torch.cuda.synchronize(k.device)

        k.run_device(1)  # capture outside the trace
        sync()
        tmp = tempfile.mkdtemp(prefix="nf_trace_")
        t0 = time.perf_counter()
        with profiler_trace(os.path.join(tmp, "trace")):
            for _ in range(ticks):
                k.run_device(1, reconcile=False)
            sync()
        elapsed = time.perf_counter() - t0
    finally:
        if engine is not None:
            if old is None:
                os.environ.pop("NF_PALLAS", None)
            else:
                os.environ["NF_PALLAS"] = old
    trace_json = os.path.join(tmp, "trace", "trace.json")
    named = kernels_named(trace_json)
    with tarfile.open(out, "w:gz") as tar:
        tar.add(tmp, arcname="trace")
    n_files = sum(len(fs) for _, _, fs in os.walk(tmp))
    return {
        "metric": "trace_capture",
        "entities": entities,
        "ticks": ticks,
        "engine": int(os.environ.get("NF_PALLAS", "1")) if engine is None else int(engine),
        "traced_wall_s": round(elapsed, 3),
        "files": n_files,
        "archive": os.path.abspath(out),
        "bytes": os.path.getsize(out),
        "kernels_named": named,
        "device": str(k.device),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--entities", type=int, default=1_000_000)
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--engine", type=int, default=None,
                    help="NF_PALLAS for the traced ticks (default: the environment's, else 1)")
    ap.add_argument("--device", default=None, help="the world's device (default cuda)")
    ap.add_argument("--out", default=None,
                    help="archive path (default chiprun_out/torch_trace_1m.tar.gz)")
    args = ap.parse_args()
    print(json.dumps(run(args.entities, args.ticks, args.out, args.engine, args.device)))


if __name__ == "__main__":
    main()
