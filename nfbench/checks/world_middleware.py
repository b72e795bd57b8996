"""The correctness check of a ``world_middleware`` deployment: the
program's states against the plain reference of the game role's stack,
the world's tick after the buff fold (:mod:`nfbench.reference.buffs`).

It judges as the ``world`` kind's check does (:mod:`nfbench.checks.world`:
the start state, the states around an early frame on the reference's own
trajectory, a late frame one reference tick from the program's state;
every leaf but the Verlet caches, ``cells_off`` with limit 0), with the
start state's buff lists drawn again from the recipe and every tick the
buff fold's.  :func:`control` is the reference in bfloat16 in the
program's place."""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

from ..reference.buffs import buff_inputs, initial_buffs
from ..reference.buffs import step as buff_step
from ..reference.build import initial_rooms
from ..reference.tick import Geometry
from . import world
from .world import CONTROL, LIMITS, cells_off, passed

__all__ = ["LIMITS", "CONTROL", "reference_inputs", "run_check", "passed", "describe",
           "readings", "control"]


def reference_inputs(cfg: dict, seed: int, device) -> dict:
    """The world recipe's draws and the buff recipe's, drawn again from
    the seed."""
    slots = int(cfg["buffs"]["slots"])
    return {**world.reference_inputs(cfg, seed, device),
            **buff_inputs(seed, int(cfg["entities"]), slots, cfg["buffs"], device)}


def start_state(cfg: dict, lay, inputs: dict, start: Mapping[str, torch.Tensor]):
    geo = Geometry.from_config(cfg["geometry"])
    st = initial_rooms(start, lay, geo, cfg["recipe"], inputs)
    return initial_buffs(st, lay, geo, cfg["recipe"], inputs), geo


def run_check(cfg: dict, lay, inputs: dict, start: Mapping[str, torch.Tensor],
              early: Sequence[Mapping[str, torch.Tensor]],
              late: Sequence[Mapping[str, torch.Tensor]],
              fdt: torch.dtype = torch.float32, stats: Optional[dict] = None,
              max_ticks: int = 4096) -> Dict[str, int]:
    """As :func:`nfbench.checks.world.run_check`, with the stack's tick;
    ``stats`` receives the late tick's buff counts too."""
    recipe = cfg["buffs"]
    target = int(early[0]["tick"].reshape(-1)[0])
    off = {"cells_off": 0, "cells": 0}

    def compare(ref, got):
        off["cells_off"] += cells_off(ref, got)
        off["cells"] += sum(x.numel() for x in got.values())

    st, geo = start_state(cfg, lay, inputs, start)
    compare(st, start)
    if 0 <= target <= max_ticks:
        while int(st["tick"][0]) < target:
            st, _ = buff_step(st, lay, geo, recipe, fdt)
        compare(st, early[0])
        st, _ = buff_step(st, lay, geo, recipe, fdt)
        compare(st, early[1])
    else:
        for snap in early:
            compare({}, snap)
    del st
    st, _ = buff_step(late[0], lay, geo, recipe, fdt, stats)
    compare(st, late[1])
    return off


def describe(stats: Mapping[str, int]) -> str:
    """The late tick's combat and buffs, for the run's log."""
    return (f"{world.describe(stats)}, {stats.get('buffs_active', 0)} buffs active, "
            f"{stats.get('buffs_expired', 0)} expired")


def readings(stats: Mapping[str, int]) -> Dict[str, int]:
    return world.readings(stats)


def control(found: dict, seed: int, lay, inputs: dict, start: Mapping[str, torch.Tensor],
            target: int, fdt: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """The reference of the stack in ``fdt`` in the program's place, as
    :func:`nfbench.checks.world.control`."""
    cfg = found["config"]
    recipe = cfg["buffs"]
    st, geo = start_state(cfg, lay, inputs, start)
    while int(st["tick"][0]) < target:
        st, _ = buff_step(st, lay, geo, recipe, fdt)
    e0 = st
    e1, _ = buff_step(e0, lay, geo, recipe, fdt)
    l1, _ = buff_step(e1, lay, geo, recipe, fdt)
    return run_check(cfg, lay, inputs, start, [e0, e1], [e1, l1])
