"""Cell-table binning for the combat stencil.

Counterpart of ``noahgameframe_tpu/ops/stencil.py``.  ``NF_BINNING``
(:func:`binning_mode`) picks the slot-assignment engine:

- ``sort`` (the default): ``_sorted_segments`` sorts entities by cell id
  with one stable argsort and ranks each entity within its cell run;
- ``count``: no sort at all.  ``_counting_ranks`` runs K rounds of
  scatter-min selection (``scatter_reduce_(..., "amin")``, which is
  order-independent on integers, so deterministic): round r gives each
  cell's smallest not-yet-ranked row id rank r.

Both place the K smallest row ids of each cell and dump the rest, so
their tables are bit-identical, overflow drops included.  Then:

1. ``build_cell_table_pair`` packs features of the full population (the
   victims) and of a subset (the attackers) into dense
   ``[n_cells*K + 1, F+1]`` payload tables; entities beyond a cell's K
   slots land in the dump slot (the last row) and are counted in
   ``dropped``.  ``build_cell_slots_pair`` returns the same slot
   assignments without the payloads (the fused engine's input).
2. ``stencil_fold`` walks the 3x3 neighborhood as nine shifted views of
   the padded ``[H, W, K, F]`` grid; ``pull_slots`` (``pull`` through a
   table) maps per-slot results back to rows.

Placement is bit-identical to the JAX package's: the rank fixes which
entities overflow, and the dump slot is re-pinned to zero after the
payload scatter (duplicate writes land there in no fixed order).  The
counting engine has no hand kernel: the JAX package computes it outside
Pallas, and so does the port.
"""

from __future__ import annotations

import math
import os
from typing import Callable, NamedTuple, Tuple, TypeVar

import torch
import torch.nn.functional as F

from .aoi import cell_of

A = TypeVar("A")

ENV_BINNING = "NF_BINNING"
BINNING_MODES = ("sort", "count")


def binning_mode() -> str:
    """The validated ``NF_BINNING`` mode; unset or empty means "sort".
    Unknown values raise: a typo'd mode silently running the default
    would mislabel any A/B it ran under."""
    raw = os.environ.get(ENV_BINNING, "").strip()
    if not raw:
        return "sort"
    if raw not in BINNING_MODES:
        raise ValueError(f"{ENV_BINNING}={raw!r}: expected one of {BINNING_MODES}")
    return raw

# 3x3 stencil in (dy, dx) order: candidate iteration order, and therefore
# tie-breaking, is identical in every engine
STENCIL = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


class CellSlots(NamedTuple):
    """A slot assignment without the payload materialization.

    slot_of: [N] int32 flat slot per row; dump slot (n_cells*K) for rows
             not placed.
    dropped: int32 0-dim — active entities that overflowed their cell.
    """

    slot_of: torch.Tensor
    dropped: torch.Tensor
    width: int
    cell_size: float
    bucket: int


class CellTable(NamedTuple):
    """Sorted cell-dense payload table.

    payload: [n_cells*K + 1, F+1] — caller features + occupancy column
             (last col, 1.0 = slot holds a live entity).  The final row is
             the dump slot; ``grid_view`` excludes it.
    slot_of, dropped, width, cell_size, bucket: as in CellSlots.
    """

    payload: torch.Tensor
    slot_of: torch.Tensor
    dropped: torch.Tensor
    width: int
    cell_size: float
    bucket: int

    def grid_view(self) -> torch.Tensor:
        """[H, W, K, F+1] dense view (dump slot excluded)."""
        w, k = self.width, self.bucket
        return self.payload[:-1].reshape(w, w, k, self.payload.shape[-1])


def auto_bucket(
    capacity: int, width: int, lo: int = 8, hi: int = 256, align: int = 4
) -> int:
    """Pick K so uniform occupancy ~Poisson(capacity/cells) stays under
    the overflow budget: mean + 2.5*sqrt(mean) + 2, rounded up to a
    multiple of ``align`` within [lo, hi]."""
    lam = capacity / float(max(width * width, 1))
    k = int(math.ceil(lam + 2.5 * math.sqrt(max(lam, 1.0)) + 2.0))
    k = max(lo, min(hi, k))
    return -(-k // align) * align


def _cell_keys(pos, active, cell_size: float, width: int):
    """Per-row sort key: cell id, or n_cells for inactive rows."""
    n = pos.shape[0]
    if n >= 1 << 24:
        # row ids ride in f32 payload columns, exact only below 2^24
        raise ValueError(f"cell table capacity {n} >= 2^24 breaks f32 row ids")
    n_cells = width * width
    key = torch.where(active, cell_of(pos, cell_size, width), n_cells)
    return n_cells, key


def _sorted_segments(pos, active, cell_size: float, width: int):
    """The one stable argsort by cell id plus per-element segment ranks.
    Returns (n_cells, order, skey, head, rank): ``head`` is the sorted
    index of each element's segment head."""
    n = pos.shape[0]
    n_cells, key = _cell_keys(pos, active, cell_size, width)
    order = torch.argsort(key, stable=True)  # row order kept within a cell
    skey = key[order]
    # the segment head is the first occurrence of the element's key: a
    # binary search of the sorted keys (the JAX package takes a running
    # max over head indices; same values, and PyTorch's CUDA cummax is
    # a slow scan)
    head = torch.searchsorted(skey, skey, side="left")
    rank = torch.arange(n, dtype=torch.int32, device=pos.device) - head.to(torch.int32)
    return n_cells, order, skey, head, rank


def _slots_from_ranks(n_cells: int, order, skey, rank, bucket: int):
    """Un-sort ``skey * bucket + rank`` back to row order (one scatter into
    a ``full_like`` of the sorted slots: under ``torch.func.vmap`` it
    carries their room axis, so the scatter batches)."""
    dump = n_cells * bucket
    placed = (rank < bucket) & (skey < n_cells)
    flat_sorted = torch.where(placed, skey * bucket + rank, dump).to(torch.int32)
    slot_of = torch.full_like(flat_sorted, dump)
    slot_of[order] = flat_sorted
    return slot_of


def _subset_ranks(sub_mask, order, head, n_cells: int, sub_bucket: int):
    """Subset ranks via a segmented exclusive cumsum over the shared sorted
    order: a member's rank is its ordinal among subset members of its
    cell; non-members get an out-of-range rank (the dump slot)."""
    sub_sorted = sub_mask[order].to(torch.int32)
    ex = torch.cumsum(sub_sorted, dim=0, dtype=torch.int32) - sub_sorted
    return torch.where(sub_sorted.bool(), ex - ex[head], n_cells * sub_bucket + 1)


def _dropped(active, slot_of, dump: int) -> torch.Tensor:
    return torch.sum(active & (slot_of == dump), dtype=torch.int32)


def slots_from_assignment(active, slot_of, n_cells: int, cell_size: float,
                          width: int, bucket: int) -> CellSlots:
    """CellSlots from a per-row slot array: inactive rows go to the dump
    slot, active overflow is counted."""
    dump = n_cells * bucket
    slot_of = torch.where(active, slot_of, dump).to(torch.int32)
    return CellSlots(slot_of, _dropped(active, slot_of, dump), width, cell_size, bucket)


def table_from_slots(features, active, slot_of, n_cells: int, cell_size: float,
                     width: int, bucket: int) -> CellTable:
    """Materialize a CellTable from a slot assignment: one payload scatter
    (unique slots for placed rows), dump-slot zeroing, drop count."""
    n = features.shape[0]
    dump = n_cells * bucket
    slot_of = torch.where(active, slot_of, dump).to(torch.int32)
    feats = torch.cat([features, torch.ones((n, 1), dtype=features.dtype,
                                            device=features.device)], dim=-1)
    # new_zeros of the features: under torch.func.vmap it carries their
    # room axis, so the in-place scatter below batches
    payload = feats.new_zeros((dump + 1, feats.shape[-1]))
    payload[slot_of.long()] = feats
    # the dump slot may have been written by any loser; force it empty
    payload[dump] = 0.0
    return CellTable(payload, slot_of, _dropped(active, slot_of, dump),
                     width, cell_size, bucket)


def _cell_counts(key: torch.Tensor, n_cells: int) -> torch.Tensor:
    """[n_cells + 1] int32 occupancy per cell; the last bin counts the
    inactive rows (key == n_cells)."""
    counts = torch.zeros((n_cells + 1,), dtype=torch.int32, device=key.device)
    return counts.scatter_add(0, key.long(), torch.ones_like(key, dtype=torch.int32))


def _counting_ranks(key: torch.Tensor, n_cells: int, kmax: int) -> torch.Tensor:
    """Within-cell rank in row-id order without a sort: ``kmax`` rounds of
    scatter-min selection.  Round r finds each cell's smallest
    not-yet-ranked row id, gives it rank r and retires it; rows never
    selected (rank >= kmax, or inactive, key == n_cells) keep ``kmax``.
    Equal to the stable-argsort rank wherever it decides placement."""
    n = key.shape[0]
    dev = key.device
    idx = key.long()
    sentinel = n  # above every live row id; also the "retired" mark
    remaining = torch.where(key < n_cells, torch.arange(n, dtype=torch.int32, device=dev),
                            sentinel)
    rank = torch.full((n,), kmax, dtype=torch.int32, device=dev)
    for r in range(kmax):
        win = torch.full((n_cells + 1,), sentinel, dtype=torch.int32,
                         device=dev).scatter_reduce(0, idx, remaining, "amin")
        # the `< sentinel` guard keeps the retired rows of an exhausted
        # cell (win == sentinel) from matching
        is_win = (remaining < sentinel) & (remaining == win[idx])
        rank = torch.where(is_win, r, rank)
        remaining = torch.where(is_win, sentinel, remaining)
    return rank


def _counting_slots(key: torch.Tensor, n_cells: int, bucket: int) -> torch.Tensor:
    """Per-row flat slot from the counting ranks: ``cell * bucket + rank``
    for placed rows, the dump slot for the rest."""
    rank = _counting_ranks(key, n_cells, bucket)
    return torch.where(rank < bucket, key * bucket + rank, n_cells * bucket).to(torch.int32)


def _pair_slots(pos, active, sub_mask, cell_size: float, width: int, bucket: int,
                sub_bucket: int):
    """The two slot assignments (full population, subset) under the
    ``NF_BINNING`` engine: ``(n_cells, slot_of, sub_slot_of)``."""
    if binning_mode() == "count":
        n_cells, key = _cell_keys(pos, active, cell_size, width)
        sub_key = torch.where(sub_mask, key, n_cells)
        return (n_cells, _counting_slots(key, n_cells, bucket),
                _counting_slots(sub_key, n_cells, sub_bucket))
    n_cells, order, skey, head, rank = _sorted_segments(pos, active, cell_size, width)
    sub_rank = _subset_ranks(sub_mask, order, head, n_cells, sub_bucket)
    return (n_cells, _slots_from_ranks(n_cells, order, skey, rank, bucket),
            _slots_from_ranks(n_cells, order, skey, sub_rank, sub_bucket))


def build_cell_table(pos, active, features, cell_size: float, width: int,
                     bucket: int) -> CellTable:
    """Bin ``active`` entities into the grid, carrying ``features``, under
    the ``NF_BINNING`` engine."""
    if binning_mode() == "count":
        n_cells, key = _cell_keys(pos, active, cell_size, width)
        slot_of = _counting_slots(key, n_cells, bucket)
    else:
        n_cells, order, skey, _head, rank = _sorted_segments(pos, active, cell_size, width)
        slot_of = _slots_from_ranks(n_cells, order, skey, rank, bucket)
    return table_from_slots(features, active, slot_of, n_cells, cell_size, width, bucket)


def build_cell_table_pair(
    pos, active, features, sub_mask, sub_features,
    cell_size: float, width: int, bucket: int, sub_bucket: int,
) -> Tuple[CellTable, CellTable]:
    """The full table AND a subset table from one key pass.  Under
    ``sort`` both come from one stable argsort (the subset ranks by a
    segmented cumsum over the shared order); under ``count`` each table
    runs its own scatter-min rounds, the subset over its own keys.
    ``sub_mask`` must be a subset of ``active`` (combat: attackers among
    all alive entities)."""
    n_cells, slot_of, sub_slot_of = _pair_slots(
        pos, active, sub_mask, cell_size, width, bucket, sub_bucket)
    return (table_from_slots(features, active, slot_of, n_cells, cell_size, width, bucket),
            table_from_slots(sub_features, sub_mask, sub_slot_of, n_cells, cell_size,
                             width, sub_bucket))


def build_cell_slots_pair(
    pos, active, sub_mask, cell_size: float, width: int, bucket: int, sub_bucket: int,
) -> Tuple[CellSlots, CellSlots]:
    """``build_cell_table_pair`` minus the payloads: the same engine, ranks
    and dump-slot rules, returning only the two slot assignments."""
    n_cells, slot_of, sub_slot_of = _pair_slots(
        pos, active, sub_mask, cell_size, width, bucket, sub_bucket)
    return (slots_from_assignment(active, slot_of, n_cells, cell_size, width, bucket),
            slots_from_assignment(sub_mask, sub_slot_of, n_cells, cell_size, width,
                                  sub_bucket))


def stencil_fold(grid: torch.Tensor, fold: Callable[[A, torch.Tensor], A], init: A) -> A:
    """Fold ``fold(acc, cand)`` over the nine shifted candidate blocks of
    ``grid`` [H, W, K, F]: each cand is the neighbor cell's block aligned
    onto every cell (edge neighbors read zeros), in STENCIL order."""
    h, w = grid.shape[:2]
    gp = F.pad(grid, (0, 0, 0, 0, 1, 1, 1, 1))
    acc = init
    for dy, dx in STENCIL:
        acc = fold(acc, gp[dy + 1:dy + 1 + h, dx + 1:dx + 1 + w])
    return acc


def pull_slots(slot_of: torch.Tensor, values: torch.Tensor, fill=0) -> torch.Tensor:
    """Map per-slot results [H, W, K] or [H, W, K, V] back to rows [N] /
    [N, V] through ``slot_of``; unplaced rows (dump slot) read ``fill``."""
    squeeze = values.dim() == 3
    if squeeze:
        values = values[..., None]
    nv = values.shape[-1]
    fills = fill if isinstance(fill, (tuple, list)) else (fill,) * nv
    # built from fills, not copied from the host: no device sync
    fill_row = torch.stack([values.new_full((), f) for f in fills])
    flat = torch.cat([values.reshape(-1, nv), fill_row[None, :]])
    out = flat[slot_of.long()]
    return out[..., 0] if squeeze else out


def pull(table: CellTable, values: torch.Tensor, fill=0) -> torch.Tensor:
    """:func:`pull_slots` through a CellTable's slot assignment."""
    return pull_slots(table.slot_of, values, fill)
