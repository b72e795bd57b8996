"""The correctness check of a ``world`` deployment: the program's states
against the plain reference's trajectory.

The reference builds each room's start state from the inputs the
benchmark drew (:mod:`nfbench.reference.build`), then ticks on its own.
The program's copies are compared with it cell by cell, exactly:

- the start state, right after the deployment was built;
- the states before and after an early window frame (drawn from the
  seed), on the reference's own trajectory from the start through the
  set-up's warm-up frames and the window's first frames;
- the state after a late window frame (drawn from the seed, late enough
  that rows have died and respawn), from one reference tick of the
  program's state before it: the reference follows the program there,
  since its own trajectory would take too long to reach it.

One number comes out, ``cells_off``: the state cells that differ.  Its
limit is 0.

:func:`control` is the check's control: the reference in bfloat16 in the
program's place (``python -m nfbench.control``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

from ..reference.build import initial_rooms, world_inputs
from ..reference.tick import Geometry, Layout, step

LIMITS = {"cells_off": 0}
CONTROL = "bfloat16"


def cells_off(ref: Mapping[str, torch.Tensor], got: Mapping[str, torch.Tensor]) -> int:
    """Cells that differ over every leaf of ``got``; a leaf the reference
    lacks, or of another shape, counts whole."""
    off = 0
    for path, x in got.items():
        y = ref.get(path)
        if y is None or tuple(y.shape) != tuple(x.shape):
            off += x.numel()
        else:
            off += int((y != x).sum())
    return off


def reference_inputs(cfg: dict, seed: int, device) -> dict:
    """The inputs the program was given: the world recipe's own draws from
    the seed, drawn again."""
    geo = cfg["geometry"]
    return world_inputs(seed, int(cfg["entities"]), float(geo["extent"]),
                        int(cfg["recipe"]["camps"]), device)


def run_check(cfg: dict, lay: Layout, inputs: dict, start: Mapping[str, torch.Tensor],
              early: Sequence[Mapping[str, torch.Tensor]],
              late: Sequence[Mapping[str, torch.Tensor]],
              fdt: torch.dtype = torch.float32, stats: Optional[dict] = None,
              max_ticks: int = 4096) -> Dict[str, int]:
    """Compare the program's copies (every leaf with a leading room axis)
    with the reference: ``start`` and ``early`` (the states before and
    after one early frame) on the reference's own trajectory from the
    inputs; ``late[1]`` with one reference tick from ``late[0]``, the
    program's state before a late frame.  ``stats`` receives the late
    tick's fold pairs and its deaths and respawns.  An early state whose
    tick lies beyond ``max_ticks`` counts whole as off."""
    geo = Geometry.from_config(cfg["geometry"])
    target = int(early[0]["tick"].reshape(-1)[0])
    off = {"cells_off": 0, "cells": 0}

    def compare(ref, got):
        off["cells_off"] += cells_off(ref, got)
        off["cells"] += sum(x.numel() for x in got.values())

    st = initial_rooms(start, lay, geo, cfg["recipe"], inputs)
    compare(st, start)
    if 0 <= target <= max_ticks:
        while int(st["tick"][0]) < target:
            st, _ = step(st, lay, geo, fdt)
        compare(st, early[0])
        st, _ = step(st, lay, geo, fdt)
        compare(st, early[1])
    else:
        for snap in early:
            compare({}, snap)
    del st
    st, _ = step(late[0], lay, geo, fdt, stats)
    compare(st, late[1])
    return off


def passed(numbers: Mapping[str, int]) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())


def describe(stats: Mapping[str, int]) -> str:
    """The late tick's combat, for the run's log."""
    return (f"the late frame: {stats.get('combat_hits', 0)} hits, {stats.get('deaths', 0)} "
            f"deaths, {stats.get('respawns', 0)} respawns")


def readings(stats: Mapping[str, int]) -> Dict[str, int]:
    """What the metric readers take from the check: the late tick's
    occupied fold pairs (``pairs_per_frame``)."""
    return {"pairs_per_frame": stats.get("pairs", 0)}


def control(found: dict, seed: int, lay: Layout, inputs: dict,
            start: Mapping[str, torch.Tensor], target: int,
            fdt: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """The reference in ``fdt`` (bfloat16; float32 is what the
    configuration states) in the program's place, from the program's
    ``start``: the trajectory to ``target``, the tick of the cell's early
    checked frame, that frame, and one more frame as the late one, judged
    by :func:`run_check` as the program's states are."""
    cfg = found["config"]
    geo = Geometry.from_config(cfg["geometry"])
    st = initial_rooms(start, lay, geo, cfg["recipe"], inputs)
    while int(st["tick"][0]) < target:
        st, _ = step(st, lay, geo, fdt)
    e0 = st
    e1, _ = step(e0, lay, geo, fdt)
    l1, _ = step(e1, lay, geo, fdt)
    return run_check(cfg, lay, inputs, start, [e0, e1], [e1, l1])
