"""The yardstick of the buff fold: its least bytes a frame.

``buff_fold_bytes``: each class's rows with a buff list (the
configuration's ``rows``), each reading its record rows' ``ConfigIdx``,
``ExpireTick`` and used flags once and writing its stat contributions and
used flags once; the bytes a row are frozen in the configuration file
(``buff_fold_bytes_per_row``: 8 rows x (4 + 4 + 1) B read, 29 x 4 + 8 B
written).  At 2^20 + 64 rows that is 205.5 MB, 0.0613 ms at the card's
3.35 TB/s (:data:`nfbench.roofline.HBM_BYTES_PER_S`)."""

from __future__ import annotations

from typing import Mapping

from nfbench.roofline import HBM_BYTES_PER_S


def buff_fold_bytes(rows: Mapping[str, int], per_row: Mapping[str, int]) -> int:
    return sum(int(n) for n in rows.values()) * (int(per_row["read"]) + int(per_row["written"]))


def buff_fold_bound_s(rows: Mapping[str, int], per_row: Mapping[str, int]) -> float:
    return buff_fold_bytes(rows, per_row) / HBM_BYTES_PER_S
