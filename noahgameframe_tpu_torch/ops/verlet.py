"""Verlet-cached cell tables: the displacement-gated rebuild of the binning.

Counterpart of ``noahgameframe_tpu/ops/verlet.py``.  The grid is laid out
with ``cell_size >= r + skin`` (the combat module inflates its cells once).
A build anchors every entity at its current position and keeps the slot
assignment the binning engine produced.  While every entity live at the
anchor and now has moved less than ``skin / 2`` from its anchor, the 3x3
stencil over the anchor binning still covers every pair within the true
radius, so the binning is skipped and only the payload scatter is
replayed with fresh features.  Queries always mask by true distance on
current positions, so results are bit-identical to rebuilding every tick
on the same inflated grid.

Arrivals (rows active now that the anchor never binned) force a rebuild;
departures do not, because the payload replay dumps now-inactive rows.

The JAX package takes the branch with ``lax.cond``.  Here the decision is
a 0-dim device tensor, and on every device both branches are computed and
the result is selected with ``torch.where``, so the tick needs no host
sync and can be captured in a CUDA graph (and the CPU runs the very path
the card runs).  The binning therefore runs every tick even when the
cache is reused: the cache changes which slots are used, not the work.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.rounding import fma32
from .stencil import (
    CellTable,
    _cell_keys,
    _counting_slots,
    _slots_from_ranks,
    _sorted_segments,
    _subset_ranks,
    binning_mode,
    table_from_slots,
)

ENV_SKIN = "NF_VERLET_SKIN"


class VerletCache(NamedTuple):
    """Carried tick state for one grid (rides ``WorldState.aux``).

    anchor_pos:    [N, 2] f32 — positions at the last rebuild.
    anchor_active: [N] bool   — active mask at the last rebuild.
    order:         [N] i32    — the stable sort by anchor cell id (sort
                                engine); ``arange`` under the count engine.
    skey:          [N] i32    — the sorted cell keys (sort engine) or the
                                per-row anchor keys (count engine); a cache
                                built under one engine means nothing to
                                the other.
    slot_of:       [N] i32    — full-table slot per row for the bucket the
                                cache was built with.
    rebuilds, reuses: i32 0-dim — lifetime counters.
    age:           i32 0-dim  — ticks since the last rebuild.
    """

    anchor_pos: torch.Tensor
    anchor_active: torch.Tensor
    order: torch.Tensor
    skey: torch.Tensor
    slot_of: torch.Tensor
    rebuilds: torch.Tensor
    reuses: torch.Tensor
    age: torch.Tensor


def skin_from_env(default: float = 0.0) -> float:
    """The ``NF_VERLET_SKIN`` knob; <= 0 (or unset, or not a number) means
    off: the binning is rebuilt every tick."""
    raw = os.environ.get(ENV_SKIN, "").strip()
    if not raw:
        return float(default)
    try:
        return float(raw)
    except ValueError:
        return float(default)


def init_cache(n: int, device=None) -> VerletCache:
    """A never-built cache on ``device`` (``None`` = ``"cuda"``): its
    all-False anchor mask disagrees with any live world, so the first
    refresh rebuilds."""
    device = resolve_device(device)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    i32 = torch.int32
    return VerletCache(
        anchor_pos=z((n, 2), torch.float32), anchor_active=z((n,), torch.bool),
        order=z((n,), i32), skey=z((n,), i32), slot_of=z((n,), i32),
        rebuilds=z((), i32), reuses=z((), i32), age=z((), i32),
    )


def need_rebuild(cache: VerletCache, pos: torch.Tensor, active: torch.Tensor,
                 skin: float) -> torch.Tensor:
    """0-dim bool: must the binning be rebuilt this tick?  On an arrival,
    or when ``2 * max displacement >= skin`` over rows active both at the
    anchor and now (the boundary itself rebuilds: reuse is proven only for
    strictly less)."""
    d = pos[:, :2] - cache.anchor_pos
    both = active & cache.anchor_active
    # the reference sums the two squares as fma(d1, d1, d0*d0), as in
    # the movement phase (core/rounding.py)
    d2 = torch.where(both, fma32(d[:, 1], d[:, 1], d[:, 0] * d[:, 0]), 0.0)
    s2 = float(np.float32(skin) * np.float32(skin))
    arrival = torch.any(active & ~cache.anchor_active)
    far = 4.0 * torch.amax(d2).clamp(min=0.0) >= s2
    return arrival | far


def refresh(cache: VerletCache, pos: torch.Tensor, active: torch.Tensor,
            cell_size: float, width: int, bucket: int,
            skin: float, *, cell=None, n_cells: Optional[int] = None,
            axis_name=None) -> Tuple[VerletCache, torch.Tensor]:
    """The gated build: ``(cache valid this tick, rebuilt as int32 0-dim)``.
    The rebuild re-bins under ``NF_BINNING`` and re-anchors at today's
    positions; the reuse keeps the cached arrays and bumps the age.

    ``cell``/``n_cells``: precomputed cell ids over a rectangular grid
    (the spatial preset's slab-local ids), derived from the same
    positions.  ``axis_name``: on a mesh the shards must rebuild
    together, or their carried caches drift apart, so the trigger is
    ``pmax``'d over the mesh.  The JAX package names the ``shard_map``
    axis and reduces inside the body; a port shard body runs between
    collectives, so it passes the reduced vote itself (a 0-dim bool, the
    shards' triggers ``pmax``'d: :func:`mesh_refresh` does both)."""
    if n_cells is None:
        if cell is not None:
            raise ValueError("precomputed cell ids need n_cells")
        n_cells = width * width
    n = pos.shape[0]
    trig = need_rebuild(cache, pos, active, skin) if axis_name is None else axis_name
    mode = binning_mode()

    def rebuild() -> VerletCache:
        if mode == "count":
            _nc, key = _cell_keys(pos, active, cell_size, width, cell, n_cells)
            order = torch.arange(n, dtype=torch.int32, device=pos.device)
            skey = key
            slot_of = _counting_slots(key, n_cells, bucket)
        else:
            _nc, order, skey, _head, rank = _sorted_segments(pos, active, cell_size, width,
                                                             cell, n_cells)
            slot_of = _slots_from_ranks(n_cells, order, skey, rank, bucket)
        return VerletCache(
            # copies: a cache leaf never aliases a bank of the state
            anchor_pos=pos[:, :2].to(torch.float32, copy=True),
            anchor_active=active.clone(),
            order=order.to(torch.int32), skey=skey.to(torch.int32), slot_of=slot_of,
            rebuilds=cache.rebuilds + 1, reuses=cache.reuses.clone(),
            age=torch.zeros_like(cache.age),
        )

    def reuse() -> VerletCache:
        return cache._replace(reuses=cache.reuses + 1, age=cache.age + 1)

    new = VerletCache(*(torch.where(trig, a, b) for a, b in zip(rebuild(), reuse())))
    return new, trig.to(torch.int32)


def mesh_refresh(mesh, caches, poss, actives, cell_size: float, width: int, bucket: int,
                 skin: float, *, cells, n_cells: int):
    """:func:`refresh` on every local shard of ``mesh`` with the rebuild
    vote ``pmax``'d over all shards (parallel/collectives.py): lists in,
    a list of ``(cache, rebuilt)`` out."""
    from ..parallel import collectives as coll

    votes = [need_rebuild(c, p, a, skin).to(torch.int32)
             for c, p, a in zip(caches, poss, actives)]
    votes = coll.pmax(mesh, votes)
    return [refresh(c, p, a, cell_size, width, bucket, skin, cell=cl, n_cells=n_cells,
                    axis_name=v > 0)
            for c, p, a, cl, v in zip(caches, poss, actives, cells, votes)]


def full_table(cache: VerletCache, features, active, n_cells: int, cell_size: float,
               width: int, bucket: int, height: int = -1) -> CellTable:
    """The full-population table through the cached slot assignment."""
    return table_from_slots(features, active, cache.slot_of, n_cells, cell_size, width,
                            bucket, height)


def sub_slots(cache: VerletCache, sub_mask, n_cells: int, sub_bucket: int) -> torch.Tensor:
    """The subset's flat slots through the cached binning: its ranks are
    recomputed every tick (the subset changes), over the cached sorted
    order (sort engine) or the cached per-row keys (count engine)."""
    if binning_mode() == "count":
        return _counting_slots(torch.where(sub_mask, cache.skey, n_cells), n_cells,
                               sub_bucket)
    order, skey = cache.order.long(), cache.skey
    head = torch.searchsorted(skey, skey, side="left")
    sub_rank = _subset_ranks(sub_mask, order, head, n_cells, sub_bucket)
    return _slots_from_ranks(n_cells, order, skey, sub_rank, sub_bucket)


def sub_table(cache: VerletCache, sub_mask, sub_features, n_cells: int, cell_size: float,
              width: int, sub_bucket: int, height: int = -1) -> CellTable:
    """A subset table (this tick's attackers) through the cached binning."""
    return table_from_slots(sub_features, sub_mask,
                            sub_slots(cache, sub_mask, n_cells, sub_bucket),
                            n_cells, cell_size, width, sub_bucket, height)
