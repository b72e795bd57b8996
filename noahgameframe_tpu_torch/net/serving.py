"""SessionTable: SoA session store + host assembly for the batched serve
edge (NF_SERVE_BATCH=1, net/roles/game.py).

Counterpart of ``noahgameframe_tpu/net/serving.py``: the same slots and
host columns; the device seen-tables are tensors on the role's device
(``SessionTable(device=...)``), and a slot wipe is an in-place fill.

The legacy serve path keeps per-session Python state — a `Session`
dataclass per client plus an `_interest_seen` dict of numpy tuples — and
walks them one by one every flush.  The batched engine replaces that
with one Struct-of-Arrays table:

- host columns: ``conn_id`` (int64), ``avatar_row`` (int32, the Player
  row whose position anchors the view) and ``valid`` (bool) per session
  SLOT.  Slots are stable across frames (freed on session release,
  recycled LIFO), so the device seen-state never needs reindexing when
  an unrelated session joins or leaves.
- device columns: one :class:`~noahgameframe_tpu_torch.ops.serving.SeenTable`
  per synced class — the per-session seen-version vectors ([S, M] rows/
  gen/qver) that ops/serving.interest_delta diffs against.

The table is the session axis of the serve step: every dispatch covers
all slots (or fixed-size chunks of them, NF_SERVE_CHUNK), valid or not;
invalid slots compute an empty visible set and send nothing.  Capacity
grows by powers of two so the per-(class, capacity) step cache stays
small, exactly like the legacy `_interest_fns` policy.

`segments` is the zero-sync frame assembler: given the fetched dense
``[S, M]`` buffers it byte-slices ONE flat payload per field into
per-session packets — no per-session numpy ops, no per-session device
round trips (the tentpole's "batched frame assembly").
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from ..core.datatypes import next_pow2
from ..core.device import resolve_device
from ..ops.serving import SENTINEL, SeenTable, init_seen


class SessionTable:
    """SoA mirror of the serve-side session set; the session axis of the
    batched interest kernel."""

    def __init__(self, lo: int = 8, device=None):
        self._lo = int(lo)
        self.device = resolve_device(device)
        self.capacity = 0
        self.slot_of: Dict[Hashable, int] = {}
        self._key_of: List[Optional[Hashable]] = []
        self._free: List[int] = []
        # slots whose seen-state may be non-empty from a past occupant;
        # wiped lazily on realloc (fresh-grown slots are born empty, so
        # a mass join costs zero device scatters)
        self._stale: set = set()
        self.conn_id = np.zeros(0, np.int64)
        self.avatar_row = np.zeros(0, np.int32)
        self.valid = np.zeros(0, bool)
        # room this session is routed to under the many-worlds engine
        # (parallel/rooms.py); -1 = the host's single world.  Routing is
        # a host column only — the serve edge filters lanes per room, it
        # never crosses the device room axis.
        self.room = np.full(0, -1, np.int32)
        # per-class device seen-state, lazily sized [capacity, M]
        self.seen: Dict[str, SeenTable] = {}
        self._seen_m: Dict[str, int] = {}

    # ------------------------------------------------------------- slots
    def _grow(self, need: int) -> None:
        new_cap = next_pow2(max(need, 1), lo=self._lo)
        if new_cap <= self.capacity:
            return
        pad = new_cap - self.capacity
        self.conn_id = np.concatenate([self.conn_id, np.zeros(pad, np.int64)])
        self.avatar_row = np.concatenate(
            [self.avatar_row, np.zeros(pad, np.int32)]
        )
        self.valid = np.concatenate([self.valid, np.zeros(pad, bool)])
        self.room = np.concatenate([self.room, np.full(pad, -1, np.int32)])
        self._key_of.extend([None] * pad)
        self._free.extend(range(new_cap - 1, self.capacity - 1, -1))
        for cname, tbl in list(self.seen.items()):
            ext = init_seen(pad, self._seen_m[cname], self.device)
            self.seen[cname] = SeenTable(*(torch.cat([a, b]) for a, b in zip(tbl, ext)))
        self.capacity = new_cap

    def ensure(self, key: Hashable, conn_id: int, avatar_row: int) -> int:
        """Slot for `key`, allocating (and wiping any previous occupant's
        seen-state) on first sight.  Updates the host columns in place."""
        slot = self.slot_of.get(key)
        if slot is None:
            if not self._free:
                self._grow(self.capacity + 1)
            slot = self._free.pop()
            self.slot_of[key] = slot
            self._key_of[slot] = key
            if slot in self._stale:
                self._stale.discard(slot)
                self._wipe_seen(slot)
            # a recycled slot must not inherit the previous occupant's
            # room routing (same lazy-wipe discipline as seen-state,
            # except the column is host-side so the wipe is free)
            self.room[slot] = -1
        self.conn_id[slot] = conn_id
        self.avatar_row[slot] = avatar_row
        self.valid[slot] = True
        return slot

    def release(self, key: Hashable) -> None:
        """Free a session's slot (session closed / switched away).  The
        seen-state is wiped on the NEXT alloc, not here — releases come
        in bursts (proxy link death) and the wipe is a device scatter."""
        slot = self.slot_of.pop(key, None)
        if slot is None:
            return
        self._key_of[slot] = None
        self.valid[slot] = False
        self._stale.add(slot)
        self._free.append(slot)

    def invalidate(self, key: Hashable) -> None:
        """Mark a still-allocated session as not currently observing
        (avatar despawned); its slot and seen reset stay pending."""
        slot = self.slot_of.get(key)
        if slot is not None:
            self.valid[slot] = False

    # ------------------------------------------------------------- rooms
    def bind_room(self, key: Hashable, room_id: int) -> None:
        """Route a session to a room of the many-worlds engine; -1
        returns it to the host's single world."""
        self.room[self.slot_of[key]] = int(room_id)

    def room_of(self, key: Hashable) -> int:
        slot = self.slot_of.get(key)
        return -1 if slot is None else int(self.room[slot])

    def sessions_in_room(self, room_id: int) -> List[Hashable]:
        """Keys of every live session routed to `room_id` — the set a
        room destroy/re-home must release or reset."""
        rid = int(room_id)
        return [self._key_of[s] for s in np.flatnonzero(
            (self.room == rid) & self.valid)
            if self._key_of[s] is not None]

    def reset_view(self, key: Hashable) -> None:
        """Wipe the session's device seen-state NOW (the batched half of
        game.py reset_view: avatar despawn/switch/destroy must resend
        the world on the next sight, legacy `_interest_seen = {}`)."""
        slot = self.slot_of.get(key)
        if slot is not None:
            self._stale.discard(slot)
            self._wipe_seen(slot)
            self.valid[slot] = False

    def _wipe_seen(self, slot: int) -> None:
        # rows-only wipe: both match passes in interest_delta test row
        # equality first, and SENTINEL never equals a real row — stale
        # gen/qver behind a SENTINEL row can never resurrect a match.
        # In place: the table owns its tensors (a serve pass stores new
        # ones), and a fill needs no host sync
        for tbl in self.seen.values():
            tbl.rows[slot] = SENTINEL

    # ------------------------------------------------------- device state
    def seen_for(self, cname: str, m: int) -> SeenTable:
        """[capacity, m] seen-state for a class, created empty on first
        use.  `m` is static per class (9 * stencil bucket, possibly
        capped by NF_SERVE_SLOTS) — a changed m means a changed kernel
        geometry, so the table resets (full resend, same as a fresh
        compile of the legacy path after capacity growth)."""
        tbl = self.seen.get(cname)
        if tbl is None or self._seen_m.get(cname) != m or (
            tbl.rows.shape[0] != self.capacity
        ):
            tbl = init_seen(self.capacity, m, self.device)
            self.seen[cname] = tbl
            self._seen_m[cname] = m
        return tbl

    def store_seen(self, cname: str, tbl: SeenTable) -> None:
        self.seen[cname] = tbl


def sessions_seeing_rows(
    table: SessionTable, cname: str, rows
) -> List[Hashable]:
    """Session keys whose device seen-state for ``cname`` references any
    of ``rows`` — the exact force-``reset_view`` set after an elastic
    reshard moved those entity rows (parallel/elastic.py): a seen-row
    now describing a different entity would silently diff against the
    wrong baseline, while every other session's mirror is still valid
    and must NOT pay a full resend."""
    tbl = table.seen.get(cname)
    moved = np.asarray(rows)
    # empty seen slots are SENTINEL-padded — a SENTINEL in `rows` would
    # otherwise mark every session as affected
    moved = moved[moved != SENTINEL]
    if tbl is None or moved.size == 0:
        return []
    hit = np.isin(tbl.rows.cpu().numpy(), moved).any(axis=1)
    return [
        key for key, slot in table.slot_of.items()
        if slot < hit.shape[0] and bool(hit[slot])
    ]


def segments(
    counts: np.ndarray, item_bytes: int, payload: bytes
) -> Tuple[np.ndarray, bytes]:
    """(byte offsets [S+1], payload) for per-slot packet slicing: slot
    s's bytes are ``payload[offs[s]:offs[s + 1]]``.  The payload is ONE
    tobytes() of the flat (already session-major) value array — the
    whole frame's wire bytes materialize with a single copy and each
    packet is a cheap bytes slice."""
    offs = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    offs *= item_bytes
    return offs, payload
