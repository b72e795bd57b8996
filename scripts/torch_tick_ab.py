#!/usr/bin/env python3
"""Time the PyTorch port's 1M-entity graph tick in two checkouts, in
turns, on one CUDA card.

    python3 scripts/torch_tick_ab.py --base DIR [--rounds 3] [--ticks 90]

Runs ``python -m noahgameframe_tpu_torch.bench`` from ``--base`` (for
example a parent commit unpacked with ``git archive``) and from this
checkout in the order base, this, this, base, ``--rounds`` times, so a
drift of the card's clocks across the call falls on both alike.  Each run
is a fresh process that builds its own kernels; its ``tick_ms`` is the
wall time of ``--ticks`` replayed graph ticks over their count.  Prints
every run, the mean and spread of each side, the mean of the differences
of adjacent base/this runs, the card's name and power limit, and one JSON
line last.  Exits non-zero if a run fails or there is no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def bench_once(checkout: Path, args) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout))
    cmd = [sys.executable, "-m", "noahgameframe_tpu_torch.bench",
           "--entities", str(args.entities), "--ticks", str(args.ticks),
           "--lat-budget-s", "1"]
    out = subprocess.run(cmd, cwd=checkout, env=env, capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:])
        raise SystemExit(f"bench failed in {checkout} (exit {out.returncode})")
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("{")][-1]
    d = json.loads(line)["detail"]
    return {"tick_ms": d["tick_ms"], "tick_ms_p50_device": d["tick_ms_p50_device"],
            "launches_per_tick": d["launches_per_tick"], "graph": d["graph"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--entities", type=int, default=1_000_000)
    ap.add_argument("--ticks", type=int, default=90)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_tick_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    sides = {"base": args.base.resolve(), "this": ROOT}
    runs = []
    for _ in range(args.rounds):
        for side in ("base", "this", "this", "base"):
            r = dict(bench_once(sides[side], args), side=side)
            runs.append(r)
            print(json.dumps(r), flush=True)
    ms = {s: [r["tick_ms"] for r in runs if r["side"] == s] for s in sides}
    # adjacent pairs: (base, this) then (this, base) in each round
    diffs = []
    for i in range(0, len(runs), 2):
        a, b = runs[i], runs[i + 1]
        this, base = (b, a) if a["side"] == "base" else (a, b)
        diffs.append(this["tick_ms"] - base["tick_ms"])
    summary = {
        "card": card, "entities": args.entities, "ticks": args.ticks,
        "runs": runs,
        **{f"{s}_mean_ms": statistics.mean(v) for s, v in ms.items()},
        **{f"{s}_spread_ms": max(v) - min(v) for s, v in ms.items()},
        "diff_this_minus_base_ms": diffs,
        "diff_mean_ms": statistics.mean(diffs),
        "launches_per_tick": {s: sorted({r["launches_per_tick"] for r in runs
                                         if r["side"] == s}) for s in sides},
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
