"""The buff fold of the game role's default stack, in plain PyTorch, and
the start state of an NPC's buffs from a recipe's draws.

The semantics are NoahGameFrame's NFCBuffModule as the game role runs it
(its device phase at order 55, between the tick's level phase and the
stat recompute): a row of an entity's ``BuffList`` record (``ConfigIdx``,
``ExpireTick``, a used flag) is active while it is used and its expiry
lies beyond the tick; the sum of every active row's stat deltas (the
recipe's kind ``ConfigIdx``, clamped into the table) is written into the
``RUNTIME_BUFF`` group row of the stat record; rows that are no longer
active are freed.  The phase reads nothing the tick's earlier phases
write, and the recompute reads the record, so one tick of the stack is
:func:`fold` and then :func:`~.tick.step` on the folded state
(:func:`step`).

A buff applied to an entity that holds one of the same kind refreshes
that row's expiry; any other takes the first unused row.  The recipe's
draws give each NPC's record slots, in slot order, as applications.

Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .tick import STAT_RECORD, F32, Geometry, Layout, _key
from .tick import step as world_step

BUFF_RECORD = "BuffList"
RUNTIME_BUFF = 6  # the stat record's group row the buffs own
BUFF_STREAM = 1  # the recipe's stream beside the world's draws


@dataclasses.dataclass(frozen=True)
class BuffLayout(Layout):
    """The world's :class:`~.tick.Layout` plus, per class with a buff
    list, its ``ConfigIdx`` and ``ExpireTick`` columns."""

    buff_cols: Mapping[str, Tuple[int, int]] = dataclasses.field(default_factory=dict)


def buff_inputs(seed: int, n: int, slots: int, recipe: Mapping, device) -> Dict[str, torch.Tensor]:
    """The recipe's draws from ``numpy.random.default_rng([seed, 1])``:
    which slots are used (probability ``slots_used``), then each slot's
    kind, uniform over ``kinds``, then its duration in ticks, uniform in
    ``expire_ticks`` (both ends in), as ``[1, n, slots]`` tensors."""
    lo, hi = (int(t) for t in recipe["expire_ticks"])
    r = np.random.default_rng([int(seed), BUFF_STREAM])
    used = r.random((n, slots)) < float(recipe["slots_used"])
    kind = r.integers(0, len(recipe["kinds"]), (n, slots))
    ticks = r.integers(lo, hi + 1, (n, slots))
    return {"buff_used": torch.from_numpy(used)[None].to(device),
            "buff_kind": torch.from_numpy(kind.astype(np.int32))[None].to(device),
            "buff_ticks": torch.from_numpy(ticks.astype(np.int32))[None].to(device)}


def table(recipe: Mapping, cols: Mapping[str, int]) -> torch.Tensor:
    """The kinds' deltas as ``[K, len(cols)]`` int32, column ``i`` the
    stat of the record column ``list(cols.values())[i]``."""
    names = list(cols)
    t = torch.zeros((len(recipe["kinds"]), len(names)), dtype=torch.int32)
    for k, deltas in enumerate(recipe["kinds"]):
        for stat, v in deltas.items():
            t[k, names.index(stat)] += int(v)
    return t


def seeded_lists(inputs: Mapping[str, torch.Tensor], width: int, cfg_col: int,
                 exp_col: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The buff lists the drawn applications leave on a fresh world at
    tick 0: ``(i32 [R, n, slots, width], used [R, n, slots])``.  Of the
    used slots of one NPC, the first of each kind takes the next free row;
    a later one of the same kind only refreshes that row's expiry, so a
    row's expiry is the last of its kind's."""
    used = inputs["buff_used"]
    kind = inputs["buff_kind"]
    ticks = inputs["buff_ticks"].clamp(min=1)
    slots = used.shape[-1]
    j = torch.arange(slots, device=used.device)
    same = used[..., :, None] & used[..., None, :] & (kind[..., :, None] == kind[..., None, :])
    earlier = same & (j[None, :] < j[:, None])
    lead = used & ~earlier.any(dim=-1)
    place = torch.cumsum(lead.int(), dim=-1) - lead.int()
    last = torch.where(same, j, -1).amax(dim=-1).clamp(min=0)
    expire = torch.gather(ticks, -1, last)
    i32 = torch.zeros((*used.shape, width), dtype=torch.int32, device=used.device)
    out_used = torch.zeros_like(used)
    r, n, s = torch.nonzero(lead, as_tuple=True)
    p = place[r, n, s].long()
    i32[r, n, p, cfg_col] = kind[r, n, s]
    i32[r, n, p, exp_col] = expire[r, n, s]
    out_used[r, n, p] = True
    return i32, out_used


def initial_buffs(st: Mapping[str, torch.Tensor], lay: BuffLayout, geo: Geometry,
                  recipe: Mapping, inputs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The buff lists of a start state (the world's, :func:`~.build.
    initial_rooms`): the fighter's first ``seeded`` rows from the draws,
    every other list empty."""
    out = dict(st)
    n_seed = int(recipe["seeded"])
    for cname, (ci, ei) in lay.buff_cols.items():
        i32 = torch.zeros_like(st[_key(cname, f"records.{BUFF_RECORD}.i32")])
        used = torch.zeros_like(st[_key(cname, f"records.{BUFF_RECORD}.used")])
        if cname == geo.fighter:
            seeded, seeded_used = seeded_lists(inputs, i32.shape[-1], ci, ei)
            i32[:, :n_seed] = seeded
            used[:, :n_seed] = seeded_used
        out[_key(cname, f"records.{BUFF_RECORD}.i32")] = i32
        out[_key(cname, f"records.{BUFF_RECORD}.used")] = used
    return out


def fold(st: Mapping[str, torch.Tensor], lay: BuffLayout, recipe: Mapping,
         stats: dict = None) -> Dict[str, torch.Tensor]:
    """The buff phase on every room: each class's active rows, their
    summed deltas in the ``RUNTIME_BUFF`` row, expired rows freed.
    ``stats`` accumulates ``buffs_active`` and ``buffs_expired``."""
    new = dict(st)
    now = st["tick"]
    for cname, (ci, ei) in lay.buff_cols.items():
        cols = lay.stat_cols[cname]
        tab = table(recipe, cols).to(now.device)
        buf = st[_key(cname, f"records.{BUFF_RECORD}.i32")]
        used = st[_key(cname, f"records.{BUFF_RECORD}.used")]
        active = used & (buf[..., ei] > now[:, None, None])
        kind = buf[..., ci].clamp(0, tab.shape[0] - 1).long()
        contrib = torch.sum(tab[kind] * active[..., None], dim=-2, dtype=torch.int32)
        rec = st[_key(cname, f"records.{STAT_RECORD}.i32")].clone()
        rec[:, :, RUNTIME_BUFF, list(cols.values())] = contrib
        new[_key(cname, f"records.{STAT_RECORD}.i32")] = rec
        new[_key(cname, f"records.{BUFF_RECORD}.used")] = active
        if stats is not None:
            stats["buffs_active"] = stats.get("buffs_active", 0) + int(active.sum())
            stats["buffs_expired"] = stats.get("buffs_expired", 0) + int((used & ~active).sum())
    return new


def step(st: Mapping[str, torch.Tensor], lay: BuffLayout, geo: Geometry, recipe: Mapping,
         fdt: torch.dtype = F32, stats: dict = None):
    """One tick of the stack: :func:`fold`, then the world's tick."""
    return world_step(fold(st, lay, recipe, stats), lay, geo, fdt, stats)
