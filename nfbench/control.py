"""The control of the correctness check: the reference in bfloat16, put
in the program's place, must come out not correct.

    python -m nfbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed it builds the cell's deployment (set-up only: the start
state, the inputs and the column layout), frees the program, and runs the
plain reference in bfloat16 (float32 is what the configuration states)
from the same start: the trajectory to the cell's early checked frame,
that frame, and one more frame as the late one.  Those states are then
judged by :func:`nfbench.check.run_check` exactly as
the program's are, and each seed's numbers are printed beside their
limits, one JSON line a seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Dict, List

import torch

from .check import LIMITS, passed, reference_inputs, run_check
from .reference.build import initial_rooms
from .reference.tick import Geometry, step
from .run import check_frame, derived_seed, find_cell, load_benchmark, pin_caches


def control_run(found: dict, seed: int, device, fdt=torch.bfloat16) -> Dict[str, int]:
    from . import program

    cfg, traffic = found["config"], found["traffic"]
    wseed = derived_seed(seed)
    dep = program.deploy(cfg, wseed, device)
    start = program.Snapshot(dep.leaves())
    start.take(dep.leaves())
    lay = dep.layout()
    inputs = reference_inputs(cfg, wseed, device)
    dep.close()
    del dep
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    base = start.as_rooms()
    geo = Geometry.from_config(cfg["geometry"])
    target = int(traffic["warmup_frames"]) + check_frame(seed, 1, int(traffic["early_frames"]))
    st = initial_rooms(base, lay, geo, cfg["recipe"], inputs)
    while int(st["tick"][0]) < target:
        st, _ = step(st, lay, geo, fdt)
    e0 = st
    e1, _ = step(e0, lay, geo, fdt)
    l1, _ = step(e1, lay, geo, fdt)
    return run_check(cfg, lay, inputs, base, [e0, e1], [e1, l1])


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
    failed: List[bool] = []
    for seed in args.seeds:
        numbers = control_run(found, seed, device)
        failed.append(not passed(numbers))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "bfloat16",
                          "correct": passed(numbers),
                          "checks": {n: {"value": numbers[n], "limit": LIMITS[n]}
                                     for n in LIMITS},
                          "cells": numbers["cells"]}), flush=True)
    return 0 if all(failed) else 1


if __name__ == "__main__":
    raise SystemExit(main())
