"""Spatial AOI ops: uniform-grid neighbour queries with static shapes.

Counterpart of ``noahgameframe_tpu/ops/aoi.py``.  The reference's "AOI" is
group-granular broadcast (kernel/scene.py); its spatial layer, the 2D-grid
neighbour scan of BASELINE config 3, is a bucketed uniform grid with
static shapes — ``[n_cells, K]`` entity slots — built by one stable sort,
a rank and a scatter, and queried through the 3x3 stencil.  Entities
beyond a cell's K slots miss the grid for the build (``grid_overflow``
counts them).

Rounding follows the reference's compiled callers (core/rounding.py):
``pos / cell_size`` is ``pos * float32(1/cell_size)``, and a squared
distance ``dx*dx + dy*dy`` is ``fma(dx, dx, dy*dy)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.rounding import fma32, recip32

# 3x3 neighbourhood stencil (dy, dx)
_STENCIL = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0), (1, 1)]


class Grid(NamedTuple):
    """Bucketed uniform grid: slots[c, k] = entity row or -1."""

    slots: torch.Tensor  # int32 [n_cells + 1, K]; last cell = overflow/dead
    counts: torch.Tensor  # int32 [n_cells + 1] true occupancy (may exceed K)
    width: int  # cells per row
    cell_size: float  # world units per cell


def cell_of(pos: torch.Tensor, cell_size: float, width: int) -> torch.Tensor:
    """[N, 2+] positions -> [N] int32 row-major cell ids, clipped to the
    grid.  ``pos / cell_size`` is taken as the reference takes it, times
    the float32 reciprocal."""
    inv = recip32(cell_size)
    cx = torch.floor(pos[:, 0] * inv).to(torch.int32).clamp(0, width - 1)
    cy = torch.floor(pos[:, 1] * inv).to(torch.int32).clamp(0, width - 1)
    return cy * width + cx


def _r2(radius: float) -> float:
    """``radius * radius`` as the float32 the reference compares against."""
    return float(np.float32(float(radius) * float(radius)))


def sq_dist(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``dx*dx + dy*dy`` as the reference's compiled code rounds it."""
    return fma32(dx, dx, dy * dy)


def build_grid(pos: torch.Tensor, active: torch.Tensor, cell_size: float, width: int,
               bucket: int) -> Grid:
    """Build the grid over ``active`` entities.  [N, 2+] pos, [N] bool."""
    n = pos.shape[0]
    n_cells = width * width
    cell = cell_of(pos, cell_size, width)
    key = torch.where(active, cell, n_cells)  # inactive -> overflow cell
    sorted_key, order = torch.sort(key, stable=True)
    # rank of each sorted element within its cell run
    start = torch.searchsorted(sorted_key, sorted_key, side="left")
    rank = torch.arange(n, dtype=torch.int64, device=pos.device) - start
    placed = (rank < bucket) & (sorted_key < n_cells)
    flat_slot = sorted_key.long() * bucket + torch.clamp(rank, max=bucket - 1)
    size = (n_cells + 1) * bucket
    # overflow (rank >= bucket) and dead entities land in a dropped slot
    flat_slot = torch.where(placed, flat_slot, size)
    slots = torch.full((size + 1,), -1, dtype=torch.int32, device=pos.device)
    slots = slots.scatter(0, flat_slot, order.to(torch.int32))[:size].reshape(n_cells + 1, bucket)
    counts = torch.bincount(key.long(), minlength=n_cells + 1).to(torch.int32)
    return Grid(slots=slots, counts=counts, width=width, cell_size=cell_size)


def grid_overflow(grid: Grid) -> torch.Tensor:
    """Total entities dropped by bucket overflow in this build."""
    bucket = grid.slots.shape[1]
    return torch.sum(torch.clamp(grid.counts[:-1] - bucket, min=0), dtype=torch.int32)


def neighbor_candidates(query_cell: torch.Tensor, grid: Grid) -> torch.Tensor:
    """[Q] query cell ids -> [Q, 9*K] candidate entity rows (-1 padded),
    gathered from the 3x3 stencil around each query cell."""
    w = grid.width
    n_cells = w * w
    cx = query_cell % w
    cy = query_cell // w
    cand = []
    for dy, dx in _STENCIL:
        nx, ny = cx + dx, cy + dy
        valid = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < w)
        ncell = torch.where(valid, ny * w + nx, n_cells)  # overflow cell is all -1
        cand.append(grid.slots[ncell.long()])  # [Q, K]
    return torch.cat(cand, dim=-1)


def neighbor_mask(pos: torch.Tensor, query_pos: torch.Tensor, cand: torch.Tensor,
                  radius: float, partition: Optional[torch.Tensor] = None,
                  query_partition: Optional[torch.Tensor] = None,
                  exclude_self: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[Q, 9K] bool: candidate within ``radius`` of the query point, in the
    same partition (scene * MAX_GROUPS + group cell key), not self."""
    safe = torch.clamp(cand, min=0).long()
    d = query_pos[:, None, :2] - pos[safe][:, :, :2]
    # the compiled sum(d * d) over the two components: fma(d1, d1, d0*d0)
    within = sq_dist(d[..., 1], d[..., 0]) <= _r2(radius)
    m = within & (cand >= 0)
    if partition is not None and query_partition is not None:
        m = m & (partition[safe] == query_partition[:, None])
    if exclude_self is not None:
        m = m & (cand != exclude_self[:, None])
    return m


def neighbor_counts(pos: torch.Tensor, active: torch.Tensor, radius: float,
                    cell_size: float, width: int, bucket: int,
                    partition: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N] int32 number of active neighbours within ``radius`` of each
    entity, in the same partition: the 500k-entity AOI scan of BASELINE
    config 3.

    Runs on the cell-table engine (ops/stencil.py): one binning, then nine
    dense shifted-window reductions.  Inactive entities count 0, as do
    active entities beyond a cell's ``bucket`` slots (they drop out of the
    query entirely; size the bucket for peak density, cf. auto_bucket)."""
    from .stencil import build_cell_table, pull, stencil_fold

    n = pos.shape[0]
    f32 = torch.float32
    part = (partition.to(torch.int32) if partition is not None
            else torch.zeros(n, dtype=torch.int32, device=pos.device))
    # the partition key in two float32-exact halves (each < 2^24), so any
    # int32 key compares exactly in the float32 payload
    feats = torch.stack([pos[:, 0], pos[:, 1], (part >> 12).to(f32), (part & 0xFFF).to(f32),
                         torch.arange(n, dtype=f32, device=pos.device)], dim=-1)
    table = build_cell_table(pos, active, feats, cell_size, width, bucket)
    v = table.grid_view()
    vx, vy, vph, vpl, vr = (v[..., i, None] for i in range(5))
    r2 = _r2(radius)

    def fold(cnt, cand):
        c = cand[:, :, None, :, :]
        dx = vx - c[..., 0]
        dy = vy - c[..., 1]
        ok = ((sq_dist(dx, dy) <= r2) & (c[..., 5] > 0) & (c[..., 2] == vph)
              & (c[..., 3] == vpl) & (c[..., 4] != vr))
        return cnt + torch.sum(ok, dim=-1, dtype=torch.int32)

    counts = stencil_fold(v, fold, torch.zeros(v.shape[:3], dtype=torch.int32,
                                               device=pos.device))
    return pull(table, counts, fill=0)


def gather_reduce(values: torch.Tensor, cand: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum ``values[cand]`` over masked candidates: the scatter-free damage
    accumulation (victims pull from an attacker grid instead of attackers
    scattering: no collisions)."""
    safe = torch.clamp(cand, min=0).long()
    picked = torch.where(mask, values[safe], torch.zeros((), dtype=values.dtype,
                                                         device=values.device))
    # integer sums stay int32, as in the reference
    dtype = None if values.is_floating_point() else torch.int32
    return torch.sum(picked, dim=-1, dtype=dtype)
