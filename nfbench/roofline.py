"""The yardstick of the per-layer shares: the card's peaks and the least
work of a frame.

Peaks: NVIDIA's data sheet for the H100 SXM (dense rates): 3.35 TB/s of
HBM, 67 TFLOP/s of float32 outside the tensor cores.

``fold_bound_s``: the least time of one combat fold launch over the whole
grid.  Its inputs are read once (the victim table's five float32 features
of ``kv`` slots a cell, the attacker table's seven of ``ka``) and its
int32 outputs written once (damage and best row per victim slot); each
occupied victim-attacker pair costs five float32 operations (two
differences, a product, a fused multiply-add and the compare).

``step_bytes``: every state column that the tick's phases read or write,
read once and written once, for each occupied row of each class, and for
each empty row only what the tick must read to skip it (its alive byte);
the counts per row are frozen in the configuration file.
"""

from __future__ import annotations

from typing import Mapping

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
FOLD_VICTIM_FEATURES = 5
FOLD_ATTACKER_FEATURES = 7
FOLD_OUTPUTS = 2
FOLD_FLOPS_PER_PAIR = 5


def fold_bytes(n_cells: int, kv: int, ka: int) -> int:
    return 4 * n_cells * (kv * FOLD_VICTIM_FEATURES + ka * FOLD_ATTACKER_FEATURES
                          + kv * FOLD_OUTPUTS)


def fold_bound_s(n_cells: int, kv: int, ka: int, pairs: float = 0.0) -> float:
    return max(fold_bytes(n_cells, kv, ka) / HBM_BYTES_PER_S,
               FOLD_FLOPS_PER_PAIR * pairs / F32_FLOP_PER_S)


def step_bytes(rows: Mapping[str, int], occupied: Mapping[str, int],
               per_row: Mapping[str, Mapping[str, int]],
               empty_row: Mapping[str, int]) -> int:
    """Bytes one frame must move: per class, its occupied rows times the
    bytes an occupied row's read and written columns hold, and its empty
    rows (capacity beyond the occupied) times an empty row's bytes."""
    empty = int(empty_row["read"]) + int(empty_row["written"])
    total = 0
    for c, b in per_row.items():
        full, used = int(rows[c]), int(occupied[c])
        if not 0 <= used <= full:
            raise ValueError(f"{c}: {used} occupied rows of {full}")
        total += used * (int(b["read"]) + int(b["written"])) + (full - used) * empty
    return total
