"""Many-worlds room engine: thousands of independent rooms on one card.

Counterpart of ``noahgameframe_tpu/parallel/rooms.py``.  The reference's
genre scales by INSTANCES, not by one giant world: the scene/group AOI
layer (NFCSceneAOIModule) splits players into rooms of about 100 entities,
and "millions of users" means tens of thousands of small rooms.  Here:

    batched = stack(room_0, room_1, ..., room_{R-1})      # [R, ...]
    step_R  = torch.func.vmap(kernel._step)               # one step

Every WorldState leaf gains a leading room axis (tick and rng included:
rooms tick independently), and the template kernel's step runs under
``torch.func.vmap`` unchanged.  Rooms never interact by construction, so
per-room results are bit-identical to R independent single-room worlds.
The two fold kernels carry the room axis themselves: their vmap rules
(``ops/stencil_cuda.py``) launch once for all R rooms.  The vmap slow-path
fallback is switched off in every rooms entry, so no operator can run as
a per-room Python loop: an operator without a batching rule raises.

On a CUDA device the step, the run loop and the K-tick train are each
captured once as a CUDA graph of the vmapped step (cost-book entries
``rooms.step``, ``rooms.run``, ``rooms.train``); ``run(n)`` replays n
times.  Only the ``[R, L]`` summary leaves the graph, as in the JAX
package.  Admission writes a room into the bound batched tensors in place
through a device slot index, so create/destroy/re-home churn re-captures
nothing; ``grow`` is the one sanctioned re-capture.

Host side, as in the JAX package: ``RoomBinPacker`` assigns slots,
create/destroy recycle slots with a lazy wipe (admit overwrites every
byte), and re-home moves a room between slots as a CRC-framed blob
carrying the room's positional digest.  ``ROOM_PACK_SPEC`` is the
explicit enumeration of what "a room" is; ``WorldState.aux`` (the Verlet
caches) is excluded and rebuilt by the next tick.

On a mesh (``RoomBatch(mesh=...)``, parallel/mesh.py) the room axis is
block-partitioned: shard d holds slots ``[d*R/D, (d+1)*R/D)`` as a batch
of its own on its device, and every step runs the vmapped step once per
shard (one captured graph per shard on a card); rooms never interact, so
no collective is needed, and the per-room summaries concatenate in slot
order.  ``room_digest(ident_cols=...)`` is placement-invariant through
``parallel.rowmigrate.canonical_digest``, for rooms whose rows a mesh
migration permuted.
"""

from __future__ import annotations

import contextlib
import fnmatch
import os
import struct as _struct
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.datatypes import next_pow2
from ..core.store import WorldState
from ..core.tree import flatten, unflatten
from ..kernel.kernel import Kernel, _as_int32, state_digest
from ..ops.stencil_cuda import KERNELS
from .mesh import ROOMS_AXIS, Mesh
from ..persist.rowblob import (
    RowBlobError,
    class_row_leaf_items,
    frame_blob,
    rebuild_class_state,
    unframe_blob,
)

__all__ = [
    "ROOMS_AXIS",
    "ROOM_EXCLUDED",
    "ROOM_PACK_SPEC",
    "RoomBatch",
    "RoomBinPacker",
    "RoomDirectory",
    "RoomSlotsFull",
    "no_vmap_fallback",
    "pack_room_blob",
    "room_digest",
    "unpack_room_blob",
    "world_room_leaf_items",
]

#: default slot-bank capacity when RoomDirectory isn't told one
ENV_ROOM_SLOTS = "NF_ROOM_SLOTS"

# Every WorldState leaf path must match one of these patterns (or appear
# in ROOM_EXCLUDED with a reason); world_room_leaf_items enforces it.
ROOM_PACK_SPEC = (
    "tick",
    "rng",
    "classes.*.i32",
    "classes.*.f32",
    "classes.*.vec",
    "classes.*.alive",
    "classes.*.timers.next_fire",
    "classes.*.timers.interval",
    "classes.*.timers.remain",
    "classes.*.timers.active",
    "classes.*.records.*.i32",
    "classes.*.records.*.f32",
    "classes.*.records.*.vec",
    "classes.*.records.*.used",
)

# Leaves waived from the room pack, with a reason each.  aux holds module
# caches (Verlet tables) that are dropped on admit and rebuilt by the next
# tick: results stay bit-identical under true-radius masking.
ROOM_EXCLUDED = (
    "aux.*",
)


class RoomSlotsFull(RuntimeError):
    """Every room slot is occupied: grow() the batch (a sanctioned
    re-capture) or shed rooms before creating more."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        super().__init__(
            f"all {capacity} room slots occupied: grow the RoomBatch "
            "(sanctioned re-capture) or destroy rooms first")


@contextlib.contextmanager
def no_vmap_fallback():
    """Switch off ``torch.func.vmap``'s slow-path fallback: an operator
    without a batching rule then raises instead of running once per room
    in a Python loop."""
    prev = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(prev)


# -- the room leaf walk --------------------------------------------------------


def world_room_leaf_items(state: WorldState,
                          class_order: Optional[Sequence[str]] = None) -> List[Tuple[str, Any]]:
    """Ordered ``(path, tensor)`` pairs for every PACKED leaf of one room's
    WorldState (no leading room axis): tick, rng, then every ClassState row
    leaf per class.  aux is skipped (ROOM_EXCLUDED), but its keys are still
    checked against the exclusion patterns."""

    def covered(path: str, pats) -> bool:
        return any(fnmatch.fnmatch(path, p) for p in pats)

    items: List[Tuple[str, Any]] = [("tick", state.tick), ("rng", state.rng)]
    names = list(class_order) if class_order is not None else sorted(state.classes)
    for cname in names:
        for path, arr in class_row_leaf_items(state.classes[cname]):
            items.append((f"classes.{cname}.{path}", arr))
    for path, _arr in items:
        if not covered(path, ROOM_PACK_SPEC):
            raise RowBlobError(
                f"WorldState leaf {path!r} not covered by ROOM_PACK_SPEC: "
                "re-homing would silently leave this bank behind")
    for key in state.aux or {}:
        if not covered(f"aux.{key}", ROOM_EXCLUDED):
            raise RowBlobError(
                f"aux entry {key!r} matches neither ROOM_PACK_SPEC nor "
                "ROOM_EXCLUDED: waive it explicitly or pack it")
    return items


def _leaf_numpy(path: str, x) -> np.ndarray:
    """A packed leaf as numpy in the JAX package's dtype: the PRNG key as
    its uint32 words (the port holds them in int64)."""
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.uint32) if path == "rng" else a


# -- placement-invariant per-room digest ------------------------------------------


def room_digest(state: WorldState, class_order: Sequence[str],
                ident_cols: Optional[Dict[str, int]] = None) -> int:
    """Host-side uint32 digest of ONE room, equal to the device
    ``kernel.state_digest`` of it and to the JAX package's ``room_digest``
    (same seed, weights, rolling multiply; aux excluded).  Admission copies
    leaves verbatim, so the positional fold is slot-invariant.
    ``ident_cols`` switches to the placement-invariant twin
    (``rowmigrate.canonical_digest``) for a room whose rows a mesh
    migration permuted."""
    if ident_cols is not None:
        from .rowmigrate import canonical_digest

        return canonical_digest(state, class_order, ident_cols)
    mult = np.uint64(1000003)
    mask = np.uint64(0xFFFFFFFF)

    def fold(acc: np.uint64, path: str, arr) -> np.uint64:
        a = np.ascontiguousarray(_leaf_numpy(path, arr))
        if a.dtype == np.bool_:
            u = a.astype(np.uint32)
        elif a.dtype.itemsize == 4:
            u = a.view(np.uint32)
        else:
            u = a.astype(np.uint32)
        u = u.ravel().astype(np.uint64)
        w = np.arange(u.size, dtype=np.uint64) * 2 + 1
        s = np.uint64(int((u * w).sum(dtype=np.uint64)) & 0xFFFFFFFF)
        return (acc * mult + s) & mask

    acc = np.uint64(0x9E3779B9)
    acc = fold(acc, "tick", state.tick)
    acc = fold(acc, "rng", state.rng)
    for cname in class_order:
        cs = state.classes[cname]
        for arr in (cs.i32, cs.f32, cs.vec, cs.alive, cs.timers.next_fire,
                    cs.timers.interval, cs.timers.remain, cs.timers.active):
            acc = fold(acc, "", arr)
        for rname in sorted(cs.records):
            rec = cs.records[rname]
            for arr in (rec.i32, rec.f32, rec.vec, rec.used):
                acc = fold(acc, "", arr)
    return int(acc)


# -- room blob (re-home / cross-engine snapshot framing) ---------------------------

_ROOM_MAGIC = b"NFRM"
_ROOM_VERSION = 1
_ROOM_HEADER = _struct.Struct("<4sBHI")  # magic, version, n_leaves, digest
_LEAF_HEADER = _struct.Struct("<HHB")  # path_len, dtype_len, ndim


def pack_room_blob(state: WorldState, class_order: Sequence[str]) -> bytes:
    """One room's packed leaves (ROOM_PACK_SPEC order) in a CRC frame
    carrying the room's positional digest; byte for byte the JAX package's
    format (leaf dtypes included), so either package admits the other's."""
    items = world_room_leaf_items(state, class_order)
    digest = room_digest(state, class_order)
    parts = [_ROOM_HEADER.pack(_ROOM_MAGIC, _ROOM_VERSION, len(items), digest)]
    for path, arr in items:
        a = _leaf_numpy(path, arr)
        p = path.encode()
        d = a.dtype.str.encode()
        parts.append(_LEAF_HEADER.pack(len(p), len(d), a.ndim))
        parts.append(p)
        parts.append(d)
        parts.append(_struct.pack(f"<{a.ndim}I", *a.shape))
        parts.append(a.tobytes())
    return frame_blob(b"".join(parts))


def unpack_room_blob(blob: bytes, template: WorldState,
                     class_order: Sequence[str]) -> WorldState:
    """Validate and decode a room blob against ``template``'s structure,
    onto the template's device.  Fails closed on every mismatch: frame CRC,
    magic and version, leaf order, dtype, shape, and finally the embedded
    digest recomputed over the rebuilt room.  Returns a room WorldState
    with ``aux={}`` (admit supplies fresh caches)."""
    payload = unframe_blob(blob, allow_legacy=False)
    if len(payload) < _ROOM_HEADER.size:
        raise RowBlobError("room blob truncated before header")
    magic, version, n_leaves, digest = _ROOM_HEADER.unpack_from(payload)
    if magic != _ROOM_MAGIC:
        raise RowBlobError("missing room blob magic")
    if version != _ROOM_VERSION:
        raise RowBlobError(f"unknown room blob version {version}")
    expect = world_room_leaf_items(template, class_order)
    if n_leaves != len(expect):
        raise RowBlobError(
            f"room blob carries {n_leaves} leaves, template has {len(expect)}: "
            "cross-build re-home rejected")
    off = _ROOM_HEADER.size
    leaves: List[torch.Tensor] = []
    for path, tarr in expect:
        if off + _LEAF_HEADER.size > len(payload):
            raise RowBlobError("room blob truncated inside a leaf header")
        plen, dlen, ndim = _LEAF_HEADER.unpack_from(payload, off)
        off += _LEAF_HEADER.size
        got_path = payload[off:off + plen].decode(errors="replace")
        off += plen
        try:
            dtype = np.dtype(payload[off:off + dlen].decode())
        except (TypeError, ValueError, UnicodeDecodeError) as e:
            raise RowBlobError(f"room blob leaf {got_path!r} has no dtype") from e
        off += dlen
        shape = _struct.unpack_from(f"<{ndim}I", payload, off)
        off += 4 * ndim
        t = _leaf_numpy(path, tarr)
        if got_path != path or dtype != t.dtype or shape != t.shape:
            raise RowBlobError(
                f"room blob leaf {got_path!r} ({dtype}{list(shape)}) does not match "
                f"template {path!r} ({t.dtype}{list(t.shape)})")
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if off + nbytes > len(payload):
            raise RowBlobError(f"room blob truncated inside leaf {path!r}")
        a = np.frombuffer(payload[off:off + nbytes], dtype=dtype).reshape(shape)
        off += nbytes
        # the key's uint32 words go back into the port's int64 words
        a = a.astype(np.int64) if path == "rng" else a.copy()
        leaves.append(torch.from_numpy(a).to(tarr.device))
    if off != len(payload):
        raise RowBlobError("room blob has trailing bytes")
    it = iter(leaves)
    tick, rng = next(it), next(it)
    classes = {}
    for cname in class_order:
        cs = template.classes[cname]
        n = len(class_row_leaf_items(cs))
        classes[cname] = rebuild_class_state(cs, [next(it) for _ in range(n)])
    out = template.replace(classes={**template.classes, **classes}, tick=tick, rng=rng,
                           aux={})
    got = room_digest(out, class_order)
    if got != digest:
        raise RowBlobError(
            f"room blob digest mismatch: header {digest:#x}, rebuilt {got:#x}: "
            "refusing to admit a corrupted room")
    return out


# -- host-side slot allocation -------------------------------------------------


class RoomBinPacker:
    """Assigns rooms to slots by load.

    Slots group into ``n_blocks`` contiguous blocks (one per shard of a
    mesh).  Policy ``least-loaded``
    (default) admits into the block with the smallest total load that
    still has a free slot; ``first-fit`` takes the lowest free slot."""

    def __init__(self, capacity: int, n_blocks: int = 1, policy: str = "least-loaded"):
        capacity, n_blocks = int(capacity), max(1, int(n_blocks))
        if capacity % n_blocks:
            raise ValueError(f"{capacity} slots do not divide into {n_blocks} blocks")
        if policy not in ("least-loaded", "first-fit"):
            raise ValueError(f"unknown packer policy {policy!r}")
        self.capacity = capacity
        self.n_blocks = n_blocks
        self.policy = policy
        self.load = np.zeros(capacity, np.float64)
        self.used = np.zeros(capacity, bool)

    @property
    def block_size(self) -> int:
        return self.capacity // self.n_blocks

    def block_of(self, slot: int) -> int:
        return int(slot) // self.block_size

    @property
    def free_count(self) -> int:
        return int(self.capacity - self.used.sum())

    def block_loads(self) -> np.ndarray:
        return self.load.reshape(self.n_blocks, self.block_size).sum(axis=1)

    def alloc(self, load: float = 1.0) -> int:
        free = ~self.used
        if not free.any():
            raise RoomSlotsFull(self.capacity)
        if self.policy == "first-fit":
            slot = int(np.flatnonzero(free)[0])
        else:
            bs = self.block_size
            has_free = free.reshape(self.n_blocks, bs).any(axis=1)
            b = int(np.argmin(np.where(has_free, self.block_loads(), np.inf)))
            slot = b * bs + int(np.flatnonzero(free[b * bs:(b + 1) * bs])[0])
        self.used[slot] = True
        self.load[slot] = float(load)
        return slot

    def free(self, slot: int) -> None:
        # lazy wipe: the slot's device bytes stay as they are (a dead room
        # is never read; admit overwrites every leaf)
        self.used[int(slot)] = False
        self.load[int(slot)] = 0.0

    def set_load(self, slot: int, load: float) -> None:
        self.load[int(slot)] = float(load)

    def grow(self, new_capacity: int, n_blocks: Optional[int] = None) -> None:
        new_capacity = int(new_capacity)
        if new_capacity < self.capacity:
            raise ValueError("packer cannot shrink")
        n_blocks = self.n_blocks if n_blocks is None else int(n_blocks)
        if new_capacity % n_blocks:
            raise ValueError(f"{new_capacity} slots do not divide into {n_blocks} blocks")
        pad = new_capacity - self.capacity
        self.load = np.concatenate([self.load, np.zeros(pad)])
        self.used = np.concatenate([self.used, np.zeros(pad, bool)])
        self.capacity = new_capacity
        self.n_blocks = n_blocks


# -- the batched device engine -------------------------------------------------


def _broadcast(tree, n: int):
    """Every leaf of ``tree`` stacked ``n`` times (real copies)."""
    leaves, spec, _ = flatten(tree)
    return unflatten(spec, [x.unsqueeze(0).expand(n, *x.shape).clone() for x in leaves])


class RoomBatch:
    """R independent rooms ticking as ONE vmapped step.

    Wraps a built template :class:`Kernel` (any recipe world's kernel); its
    ``_step`` runs under ``torch.func.vmap`` over a leading ``[R]`` axis
    and the template's own state and captures go unused.  The entries ride
    the template's CostBook (``rooms.step``, ``rooms.run``,
    ``rooms.train``); capacity is a power of two.  With a ``mesh`` the
    slots split into one block per shard, each a batch on its shard's
    device stepped by its own dispatchers (``rooms.step/<shard>``...)."""

    def __init__(self, template: Kernel, capacity: int, mesh: Optional[Mesh] = None, *,
                 seed: int = 0):
        if template.state is None:
            raise RuntimeError("template kernel must be built before RoomBatch wraps it")
        self.kernel = template
        self.device = template.device
        self.capacity = next_pow2(max(1, int(capacity)))
        self.mesh = mesh
        if mesh is not None and self.capacity % mesh.size:
            raise ValueError(f"{self.capacity} room slots not divisible by "
                             f"{mesh.size} devices")
        self.costbook = template.costbook
        self.tick_count = 0
        self.last_counters: Dict[str, np.ndarray] = {}
        # the [R, L] summary the counters were decoded from
        self.last_summary: Optional[np.ndarray] = None
        self._seed = int(seed)
        self._drop_captures()
        self._train_k = 0
        # train accounting (as Kernel.train_*), on the batch
        self.train_dispatches = 0
        self.train_ticks = 0
        self.train_fetch_bytes = 0
        self._seen_trace_gen = template._trace_gen
        template._ensure_aux()
        self._blank = self._blank_room()
        self.state = _broadcast(self._blank, self.capacity)

    # ------------------------------------------------------------ blocks
    @property
    def _devices(self) -> List[torch.device]:
        if self.mesh is None:
            return [self.device]
        return [self.mesh.devices[i] for i in self.mesh.local]

    @property
    def _per(self) -> int:
        """Slots per block."""
        return self.capacity // (1 if self.mesh is None else self.mesh.size)

    @property
    def state(self) -> WorldState:
        """Every room's state (leading ``[R]`` axis).  On a mesh this is a
        copy joined from the shards' blocks; assigning splits it."""
        if self.mesh is None:
            return self._parts[0]
        from .shard import join_state

        rows = {p for p in flatten(self._parts[0])[2]}
        return join_state(self._parts, rows, self.mesh, self.device)

    @state.setter
    def state(self, st: WorldState) -> None:
        if self.mesh is None:
            self._parts = [st]
        else:
            from .shard import room_shardings, split_state

            room_shardings(st, self.mesh)
            self._parts = split_state(st, self.mesh, all_rows=True)
        self._slots = [torch.arange(self._per, dtype=torch.int64, device=d)
                       for d in self._devices]

    def _locate(self, slot: int) -> Tuple[int, int]:
        """(local block, slot within it) of a global slot."""
        block, local = divmod(slot, self._per)
        if self.mesh is not None:
            block = self.mesh.local.index(block)
        return block, local

    # ------------------------------------------------------------ state
    def _blank_room(self) -> WorldState:
        """A pristine single-room state: zeroed store plus freshly primed
        aux caches, what a just-built recipe world starts from."""
        st = self.kernel.store.init_state(self._seed)
        return st.replace(aux={k: fn() for k, fn in self.kernel._aux_init.items()})

    def _drop_captures(self) -> None:
        self._step_fns: Dict[int, Any] = {}
        self._run_fns: Dict[int, Any] = {}
        self._train_fns: Dict[int, Any] = {}

    def _sync_generation(self) -> None:
        """Drop the captured steps when the template invalidated, and
        re-blank every aux cache: invalidate() means aux layouts changed
        (bucket resize, grid width), and the next step rebuilds caches from
        zeros as a fresh single world would."""
        gen = self.kernel._trace_gen
        if gen == self._seen_trace_gen:
            return
        self._seen_trace_gen = gen
        self._drop_captures()
        self._blank = self._blank_room()
        for cname in self.kernel.store.class_order:
            want = self._blank.classes[cname].alive.shape[0]
            got = self._parts[0].classes[cname].alive.shape[1]
            if want != got:
                raise RuntimeError(
                    f"store capacity of {cname!r} changed {got}->{want} under a live "
                    "RoomBatch: size recipe capacities so auto-resize never fires "
                    "in batched worlds")
        parts = []
        for part, dev in zip(self._parts, self._devices):
            aux = {k: v for k, v in part.aux.items() if k not in self.kernel._aux_init}
            blank, spec, _ = flatten(_broadcast(self._blank.aux, self._per))
            aux.update(unflatten(spec, [x.to(dev) for x in blank]))
            parts.append(part.replace(aux=aux))
        self._parts = parts

    def load_state(self, state: WorldState) -> None:
        """Replace every room with ``state`` (leading ``[R]`` axis, e.g.
        ``core.store.rooms_from_numpy`` of the JAX package's batch); aux
        caches start blank."""
        want = flatten(self._parts[0].replace(aux={}))[0]
        got = flatten(state.replace(aux={}))
        if len(got[0]) != len(want) or any(
                tuple(a.shape[1:]) != tuple(b.shape[1:]) or a.dtype != b.dtype
                or a.shape[0] != self.capacity for a, b in zip(got[0], want)):
            raise ValueError("state does not match the batch's rooms")
        self.state = state.replace(aux=_broadcast(self._blank.aux, self.capacity))

    # ------------------------------------------------------------ ticks
    def _room_step(self, state: WorldState) -> Tuple[WorldState, torch.Tensor]:
        """One frame for every room: ``(state', [R, L] summary)``.  Only the
        summary leaves the vmapped step; the masks and events it computes
        die inside it (and inside a captured graph).  The digest lane is
        filled after the step, over all rooms at once (``state_digest``
        with its room axis written out)."""
        k = self.kernel
        leaves, spec, _ = flatten(state)

        def one(*room_leaves):
            new, raw = k._step(unflatten(spec, room_leaves), observe=True,
                               digest_in_step=False)
            new_leaves, new_spec, _ = flatten(new)
            if new_spec != spec:
                raise RuntimeError("a room step must return the state's own structure")
            return tuple(new_leaves), raw["summary"]

        with no_vmap_fallback():
            new_leaves, summary = torch.func.vmap(one)(*leaves)
        new = unflatten(spec, list(new_leaves))
        if k.digest_enabled:
            lane = k.summary_lane("state_digest")
            summary[:, lane] = _as_int32(state_digest(new, k.store.class_order, rooms=True))
        return new, summary

    def _wrap(self, name: str, fn, statics):
        return self.costbook.wrap(name, fn, stage="tick", statics=statics, graph=True,
                                  launch_counters=KERNELS)

    def _entry(self, cache: Dict[int, Any], name: str, fn, statics, block: int):
        """The block's dispatcher (one per shard: a captured graph binds
        its block's tensors)."""
        if block not in cache:
            tag = name if self.mesh is None else f"{name}/{self.mesh.local[block]}"
            cache[block] = self._wrap(tag, fn, statics)
        return cache[block]

    def _each(self, cache, name, fn, statics, **kw):
        """Dispatch every block; the per-block outputs in slot order."""
        outs = []
        for i, part in enumerate(self._parts):
            new, out = self._entry(cache, name, fn, statics, i)(part, **kw)
            self._parts[i] = new
            outs.append(out)
        return outs

    def _cat(self, outs, dim: int = 0) -> torch.Tensor:
        if len(outs) == 1:
            return outs[0]
        return torch.cat([o.to(self.device) for o in outs], dim=dim)

    def _step_all(self) -> torch.Tensor:
        return self._cat(self._each(self._step_fns, "rooms.step", self._room_step,
                                    self.kernel._statics))

    def _decode(self, summary) -> Dict[str, np.ndarray]:
        self.last_summary = np.asarray(summary.cpu() if isinstance(summary, torch.Tensor)
                                       else summary)
        self.last_counters = self.kernel.decode_counters(self.last_summary)
        return self.last_counters

    def tick(self) -> Dict[str, np.ndarray]:
        """One frame for EVERY room; returns the per-room counter bank
        (name -> [R] int column) decoded off the one summary fetch."""
        self._sync_generation()
        summary = self._step_all()
        self.tick_count += 1
        return self._decode(summary)

    def run(self, n: int) -> Dict[str, np.ndarray]:
        """n frames for every room with no host sync inside (n replays of
        one captured step on a card).  ``last_counters`` is the final
        frame's row; ``run(0)`` is a no-op."""
        self._sync_generation()
        n = int(n)
        if n <= 0:
            return self.last_counters
        summary = self._cat(self._each(self._run_fns, "rooms.run", self._room_step,
                                       self.kernel._statics, times=n))
        self.tick_count += n
        return self._decode(summary)

    # ---------------------------------------------------------- trains
    def configure_train(self, k: int) -> None:
        """Pin the train length (see Kernel.configure_train)."""
        self.kernel.configure_train(k)
        if int(k) != self._train_k:
            # nf-lint: disable=recapture-hazard -- the kernel's own train
            # length, pinned just above: the rooms train keys its capture
            # on kernel._train_statics(), whose train_k is this value
            self._train_k = int(k)
            if self._train_fns:
                self._train_fns = {}
                self.costbook.generation_bump(f"rooms_train_k:{k}")

    def _room_train(self, state: WorldState) -> Tuple[WorldState, torch.Tensor]:
        """K frames for every room; the summaries stack into ``[K, R, L]``."""
        summaries = []
        for _ in range(self._train_k):
            state, summary = self._room_step(state)
            summaries.append(summary)
        return state, torch.stack(summaries)

    def train(self, n: int) -> np.ndarray:
        """n frames for every room in n // K train dispatches plus a ragged
        tail of single steps; returns the ``[n, R, L]`` summaries (decode a
        row with ``kernel.decode_counters``).  ``last_counters`` lands on
        the final frame."""
        self._sync_generation()
        n, kk = int(n), self._train_k
        if kk < 1:
            raise RuntimeError("configure_train(k) before train()")
        lanes: List[np.ndarray] = []
        for _ in range(n // kk):
            stacked = self._cat(self._each(self._train_fns, "rooms.train", self._room_train,
                                           self.kernel._train_statics), dim=1)
            self.tick_count += kk
            self.train_dispatches += 1
            self.train_ticks += kk
            arr = stacked.cpu().numpy()  # ONE [K, R, L] fetch per train
            self.train_fetch_bytes += arr.nbytes
            lanes.append(arr)
        for _ in range(n % kk):
            summary = self._step_all()
            self.tick_count += 1
            lanes.append(summary.cpu().numpy()[None])
        out = (np.concatenate(lanes, axis=0) if lanes
               else np.zeros((0, self.capacity, 0), np.int32))
        if len(out):
            self._decode(out[-1])
        return out

    # ---------------------------------------------------- slot plumbing
    def _room_payload(self, room: WorldState) -> WorldState:
        """A full room tree structurally matching one batched lane: the
        room's packed leaves plus FRESH aux caches (blank for registered
        entries, zeros for others)."""
        aux = {}
        for key, cur in self._parts[0].aux.items():
            if key in self._blank.aux:
                aux[key] = self._blank.aux[key]
            else:
                leaves, spec, _ = flatten(cur)
                aux[key] = unflatten(spec, [x.new_zeros(x.shape[1:]) for x in leaves])
        for cname in self.kernel.store.class_order:
            want = self._blank.classes[cname].alive.shape[0]
            got = room.classes[cname].alive.shape[0]
            if want != got:
                raise ValueError(
                    f"admitted room's {cname!r} capacity {got} != batch template "
                    f"{want}: recipes must share StoreConfig")
        return room.replace(aux=aux)

    def _check_slot(self, slot: int) -> int:
        slot = int(slot)
        if not 0 <= slot < self.capacity:
            raise IndexError(f"room slot {slot} outside [0, {self.capacity})")
        return slot

    def admit(self, slot: int, room: WorldState) -> int:
        """Write one room's state into ``slot`` of the batch, in place.
        Full-leaf overwrite: whatever the slot held before (a destroyed
        room's remains, lazy wipe) is unreadable afterwards.  The slot is a
        device index, and the batch's tensors stay the ones its captured
        graphs are bound to, so admitting re-captures nothing."""
        self._sync_generation()
        slot = self._check_slot(slot)
        block, local = self._locate(slot)
        dst, spec, paths = flatten(self._parts[block])
        src, room_spec, _ = flatten(self._room_payload(room))
        if room_spec != spec:
            raise ValueError("admitted room's structure differs from the batch's rooms")
        idx = self._slots[block][local:local + 1]
        for path, d, s in zip(paths, dst, src):
            if tuple(s.shape) != tuple(d.shape[1:]) or s.dtype != d.dtype:
                raise ValueError(f"admitted room's {path} is {s.dtype}{tuple(s.shape)}, "
                                 f"the batch's rooms {d.dtype}{tuple(d.shape[1:])}")
            d.index_copy_(0, idx, s.to(d.device).unsqueeze(0))
        return slot

    def extract(self, slot: int) -> WorldState:
        """One room's full state (aux included), copied off the batch."""
        self._sync_generation()
        slot = self._check_slot(slot)
        block, local = self._locate(slot)
        leaves, spec, _ = flatten(self._parts[block])
        return unflatten(spec, [x[local].clone() for x in leaves])

    def digest(self, slot: int, ident_cols: Optional[Dict[str, int]] = None) -> int:
        return room_digest(self.extract(slot), self.kernel.store.class_order, ident_cols)

    def pack_blob(self, slot: int) -> bytes:
        return pack_room_blob(self.extract(slot), self.kernel.store.class_order)

    def admit_blob(self, slot: int, blob: bytes) -> int:
        """Admit a framed room blob: the re-home landing path, and the
        cross-engine door (a single-world snapshot packed by
        ``pack_room_blob(world.kernel.state, ...)``, from either package,
        loads into a slot)."""
        room = unpack_room_blob(blob, self._blank, self.kernel.store.class_order)
        return self.admit(slot, room)

    def rehome(self, src: int, dst: int) -> int:
        """Move a room between slots as a framed, digest-carrying blob; the
        source slot is NOT wiped (lazy): the caller frees it."""
        if int(src) == int(dst):
            raise ValueError(f"re-home src == dst slot {src}")
        return self.admit_blob(dst, self.pack_blob(src))

    # ------------------------------------------------------------- grow
    def grow(self, new_capacity: int) -> int:
        """Double (at least) the slot bank: the ONE sanctioned re-capture
        of room churn, announced with ``generation_bump`` like the combat
        bucket resize, so the soak gate stays clean."""
        self._sync_generation()
        new_cap = next_pow2(max(int(new_capacity), self.capacity + 1))
        if self.mesh is not None and new_cap % self.mesh.size:
            raise ValueError(f"{new_cap} slots not divisible by mesh width")
        self.costbook.generation_bump(f"rooms_grow:{self.capacity}->{new_cap}")
        pad = new_cap - self.capacity
        leaves, spec, _ = flatten(self.state)
        blank = flatten(self._payload_blank())[0]
        grown = unflatten(spec, [
            torch.cat([cur, b.unsqueeze(0).expand(pad, *b.shape).to(cur.device)])
            for cur, b in zip(leaves, blank)])
        self.capacity = new_cap
        self.state = grown
        self._drop_captures()
        return new_cap

    def _payload_blank(self) -> WorldState:
        return self._room_payload(self._blank)


# -- host directory: room ids, packing, controls, metrics ----------------------


class RoomDirectory:
    """The host face of the many-worlds engine: room ids -> slots.

    ``recipe(seed)`` builds one fresh single-room world (a GameWorld or a
    built Kernel); the template seed's build becomes the vmap TEMPLATE.
    create/destroy/re-home recycle slots through the bin packer;
    ``control=True`` keeps a room's recipe world alive and ticks it in
    LOCKSTEP with the batch, the parity oracle."""

    def __init__(self, recipe: Callable[[int], Any], capacity: Optional[int] = None,
                 mesh: Optional[Mesh] = None, *, template_seed: int = 0,
                 policy: str = "least-loaded",
                 registry: Optional[Any] = None):
        if capacity is None:
            capacity = int(os.environ.get(ENV_ROOM_SLOTS, "16"))
        self._recipe = recipe
        template = self._kernel_of(recipe(template_seed))
        self.batch = RoomBatch(template, capacity, mesh=mesh, seed=template_seed)
        n_blocks = mesh.size if mesh is not None else 1
        self.packer = RoomBinPacker(self.batch.capacity, n_blocks, policy=policy)
        self.rooms: Dict[int, int] = {}  # room_id -> slot
        self.seeds: Dict[int, int] = {}  # room_id -> recipe seed
        self.controls: Dict[int, Any] = {}  # room_id -> lockstep world
        self._next_room_id = 1
        self.created = 0
        self.destroyed = 0
        self.rehomed = 0
        self._metrics = None
        if registry is not None:
            self._metrics = {
                "active": registry.gauge("nf_rooms_active", "rooms currently admitted"),
                "slots_free": registry.gauge("nf_rooms_slots_free", "free room slots"),
                "created": registry.counter("nf_rooms_created_total", "rooms created"),
                "destroyed": registry.counter("nf_rooms_destroyed_total", "rooms destroyed"),
                "rehomed": registry.counter("nf_rooms_rehomed_total", "room re-homes"),
            }
            self._publish()

    @staticmethod
    def _kernel_of(world: Any) -> Kernel:
        return world if isinstance(world, Kernel) else world.kernel

    @staticmethod
    def _load_of(state: WorldState) -> float:
        return float(sum(int(cs.alive.sum()) for cs in state.classes.values()))

    def _publish(self) -> None:
        if self._metrics is None:
            return
        self._metrics["active"].set(len(self.rooms))
        self._metrics["slots_free"].set(self.packer.free_count)

    def _count(self, name: str) -> None:
        if self._metrics is not None:
            self._metrics[name].inc()
        self._publish()

    # ----------------------------------------------------------- churn
    def create_room(self, seed: Optional[int] = None, room_id: Optional[int] = None,
                    control: bool = False) -> int:
        """Build a fresh room from the recipe and admit it into the
        least-loaded free slot; ``control=True`` keeps the recipe world as
        the lockstep oracle."""
        if room_id is None:
            room_id = self._next_room_id
            self._next_room_id += 1
        room_id = int(room_id)
        if room_id in self.rooms:
            raise ValueError(f"room {room_id} already exists")
        seed = int(seed) if seed is not None else room_id
        world = self._recipe(seed)
        k = self._kernel_of(world)
        k._ensure_aux()
        slot = self.packer.alloc(load=self._load_of(k.state))
        self.batch.admit(slot, k.state)
        self.rooms[room_id] = slot
        self.seeds[room_id] = seed
        if control:
            self.controls[room_id] = world
        self.created += 1
        self._count("created")
        return room_id

    def destroy_room(self, room_id: int) -> int:
        """Free the room's slot (lazy wipe: admit's full overwrite is the
        only writer a recycled slot needs)."""
        slot = self.rooms.pop(int(room_id))
        self.seeds.pop(int(room_id), None)
        self.controls.pop(int(room_id), None)
        self.packer.free(slot)
        self.destroyed += 1
        self._count("destroyed")
        return slot

    def rehome_room(self, room_id: int) -> Tuple[int, int]:
        """Move a room to the least-loaded block's free slot through the
        framed blob path; returns (old_slot, new_slot)."""
        room_id = int(room_id)
        src = self.rooms[room_id]
        dst = self.packer.alloc(load=float(self.packer.load[src]))
        try:
            self.batch.rehome(src, dst)
        except Exception:
            self.packer.free(dst)
            raise
        self.packer.free(src)
        self.rooms[room_id] = dst
        self.rehomed += 1
        self._count("rehomed")
        return src, dst

    def grow(self, new_capacity: Optional[int] = None) -> int:
        cap = self.batch.grow(new_capacity or self.batch.capacity * 2)
        self.packer.grow(cap)
        self._publish()
        return cap

    # ----------------------------------------------------------- ticks
    def tick(self) -> Dict[str, np.ndarray]:
        """One frame for every room and every lockstep control."""
        counters = self.batch.tick()
        for world in self.controls.values():
            self._kernel_of(world).run_device(1, reconcile=False)
        return counters

    def run(self, n: int) -> None:
        self.batch.run(n)
        for world in self.controls.values():
            self._kernel_of(world).run_device(int(n), reconcile=False)

    # ---------------------------------------------------------- oracle
    def slot_of(self, room_id: int) -> int:
        return self.rooms[int(room_id)]

    def digest(self, room_id: int) -> int:
        return self.batch.digest(self.rooms[int(room_id)])

    def control_digest(self, room_id: int) -> int:
        k = self._kernel_of(self.controls[int(room_id)])
        return room_digest(k.state, k.store.class_order)

    def status(self) -> Dict[str, Any]:
        """Totals plus per-room occupancy."""
        return {
            "capacity": self.batch.capacity,
            "active": len(self.rooms),
            "slots_free": self.packer.free_count,
            "created": self.created,
            "destroyed": self.destroyed,
            "rehomed": self.rehomed,
            "tick": self.batch.tick_count,
            "policy": self.packer.policy,
            "blocks": self.packer.n_blocks,
            "occupancy": {
                str(rid): {"slot": slot, "block": self.packer.block_of(slot),
                           "load": float(self.packer.load[slot])}
                for rid, slot in sorted(self.rooms.items())
            },
        }
