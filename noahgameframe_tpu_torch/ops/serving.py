"""Batched serving edge: interest deltas for every session at once.

Counterpart of ``noahgameframe_tpu/ops/serving.py``, where the delta
algebra is ``jax.vmap``-ed over the session axis.  Here it is written as
batched tensor ops over an explicit session axis ``S``:

1. :func:`bump_qver`: a version counter per entity row that increments
   exactly when the u16-quantized position changes.  With the host's
   allocation generation (core/store.py ``_ClassHost.row_gen``, +1 per
   row free) it replaces the legacy per-session ``(rows, guid_head,
   guid_data, qpos)`` seen tuples: a session has seen the current
   identity and position of row r iff its stored ``(gen, qver)`` for r
   equals the live ``(gen[r], qver[r])``.
2. :func:`interest_delta`: per-session set algebra over the candidate
   slots of ops/interest.py: a per-row sort of the visible rows with the
   int32-max :data:`SENTINEL` as padding (the legacy wire order), a
   batched ``torch.searchsorted`` against each session's sorted
   seen-table, and the ``send`` (enter or changed) and ``gone``
   (previously seen, no longer visible or recycled) masks plus the next
   seen-table.
3. :func:`slot_compact`: stable compaction of candidate slots in slot
   order (the interest-scoped BatchPropertySync lane's wire order).

The outputs are bit-equal to the JAX functions', ties and padding
included.  Nothing here uses int64 on the device beyond the index tensors
``searchsorted``/``gather`` take: rows, generations and versions are
int32, and guids stay on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# "empty slot" in sorted row vectors: sorts after every real row id and
# never equals one (capacities are << 2^31)
SENTINEL = 2**31 - 1


class SeenTable(NamedTuple):
    """Per-session device seen-state for one class: which entity rows the
    session's client mirrors, and at which (allocation generation,
    position version) it last received them.  ``rows`` is sorted ascending
    per session with SENTINEL padding."""

    rows: torch.Tensor  # [S, M] int32, sorted asc, SENTINEL = empty
    gen: torch.Tensor  # [S, M] int32 allocation generation at last send
    qver: torch.Tensor  # [S, M] int32 position version at last send


class ServeDelta(NamedTuple):
    """One frame's serve output for all sessions of one class."""

    vis: torch.Tensor  # [S, M] int32 visible rows, sorted asc, SENTINEL pad
    send: torch.Tensor  # [S, M] bool: enter-view or changed since seen
    gone: torch.Tensor  # [S, M] bool over the OLD seen slots
    gone_rows: torch.Tensor  # [S, M] int32 old seen rows (garbage where ~gone)
    seen: SeenTable  # next frame's seen-state


def init_seen(sessions: int, slots: int, device=None) -> SeenTable:
    """All-empty seen state ``[S, M]`` on ``device`` (``None`` = cuda)."""
    from ..core.device import resolve_device

    dev = resolve_device(device)
    return SeenTable(
        rows=torch.full((sessions, slots), SENTINEL, dtype=torch.int32, device=dev),
        gen=torch.zeros((sessions, slots), dtype=torch.int32, device=dev),
        qver=torch.zeros((sessions, slots), dtype=torch.int32, device=dev),
    )


def bump_qver(q: torch.Tensor, prev_q: torch.Tensor,
              qver: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(qver', prev_q')``: bump a row's version when its quantum moved
    (``q``, ``prev_q``: ``[C, 3]`` int32; ``qver``: ``[C]`` int32)."""
    changed = torch.any(q != prev_q, dim=-1)
    return qver + changed.to(torch.int32), q


def interest_delta(cand_rows: torch.Tensor, cand_ok: torch.Tensor, gen: torch.Tensor,
                   qver: torch.Tensor, seen: SeenTable) -> ServeDelta:
    """The per-session delta set algebra over ``[S, M]`` candidates.

    ``send[s, j]`` iff ``vis[s, j]`` is visible and the session has not
    seen it at the current ``(gen, qver)``; ``gone[s, j]`` iff seen row j
    is no longer visible under the same generation (left the radius,
    died, or its row was recycled to a new guid)."""
    n_rows = gen.shape[0]
    sentinel = torch.full_like(cand_rows, SENTINEL)
    # stencil cells are disjoint, so a row appears in at most one slot
    vis = torch.sort(torch.where(cand_ok, cand_rows, sentinel), dim=1).values
    vis_ok = vis < SENTINEL
    vr = vis.clamp(0, n_rows - 1).long()
    zero = torch.zeros_like(vis)
    vis_gen = torch.where(vis_ok, gen[vr], zero)
    vis_qver = torch.where(vis_ok, qver[vr], zero)

    m = seen.rows.shape[1]
    seen_rows = seen.rows.contiguous()
    idx = torch.searchsorted(seen_rows, vis.contiguous()).clamp(0, m - 1)
    same = (
        vis_ok
        & (torch.gather(seen_rows, 1, idx) == vis)
        & (torch.gather(seen.gen, 1, idx) == vis_gen)
        & (torch.gather(seen.qver, 1, idx) == vis_qver)
    )
    send = vis_ok & ~same

    seen_ok = seen_rows < SENTINEL
    sr = seen_rows.clamp(0, n_rows - 1).long()
    j = torch.searchsorted(vis.contiguous(), seen_rows).clamp(0, m - 1)
    still = (
        seen_ok
        & (torch.gather(vis, 1, j) == seen_rows)
        & (gen[sr] == seen.gen)  # same row and same allocation = same guid
    )
    gone = seen_ok & ~still
    return ServeDelta(vis=vis, send=send, gone=gone, gone_rows=seen_rows,
                      seen=SeenTable(rows=vis, gen=vis_gen, qver=vis_qver))


def slot_compact(cand_rows: torch.Tensor,
                 cand_ok: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rows [S, M], count [S])``: the ok slots moved to the front of
    each session's lane in their original slot order (stable)."""
    perm = torch.argsort((~cand_ok).to(torch.uint8), dim=1, stable=True)
    rows = torch.gather(cand_rows, 1, perm)
    return rows, cand_ok.sum(dim=1, dtype=torch.int32)
