"""The control of the correctness check: the plain reference, in the
precision below the one the configuration states, put in the program's
place, must come out not correct.

    python -m nfbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed it builds the cell's deployment (set-up only: the start
state and the column layout), frees the program, draws the reference's
inputs, and hands them to the kind's check (``nfbench/checks/<kind>.py``):
its ``control`` runs the reference in its ``CONTROL`` precision from the
program's start and judges those states exactly as the program's are
judged.  Each seed's numbers are printed beside their limits, one JSON
line a seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Dict, List

import torch

from . import program
from .run import check_frame, derived_seed, find_cell, load_benchmark, parts, pin_caches


def control_run(found: dict, seed: int, device, **kw) -> Dict[str, int]:
    """The check's numbers for the control on ``seed``.  The check's
    ``control`` gets the tick of the early frame that a run on ``seed``
    checks (the warm-up frames and the window's drawn frame); ``kw`` goes
    to it too (the world's takes ``fdt``, its precision)."""
    kind, _ent, chk = parts(found)
    cfg, traffic = found["config"], found["traffic"]
    wseed = derived_seed(seed)
    dep = kind.deploy(cfg, wseed, device)
    start = program.Snapshot(dep.leaves())
    start.take(dep.leaves())
    lay = dep.layout()
    dep.close()
    del dep
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    inputs = chk.reference_inputs(cfg, wseed, device)
    target = int(traffic["warmup_frames"]) + check_frame(seed, 1, int(traffic["early_frames"]))
    return chk.control(found, seed, lay, inputs, start.as_rooms(), target, **kw)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m nfbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    pin_caches()
    found = find_cell(load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("nfbench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    chk = parts(found)[2]
    failed: List[bool] = []
    for seed in args.seeds:
        numbers = control_run(found, seed, device)
        failed.append(not chk.passed(numbers))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": chk.CONTROL,
                          "correct": chk.passed(numbers),
                          "checks": {n: {"value": numbers[n], "limit": lim}
                                     for n, lim in chk.LIMITS.items()},
                          "cells": numbers["cells"]}), flush=True)
    return 0 if all(failed) else 1


if __name__ == "__main__":
    raise SystemExit(main())
