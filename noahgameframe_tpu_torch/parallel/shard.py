"""Sharded world: the entity store spread over a device mesh.

Counterpart of ``noahgameframe_tpu/parallel/shard.py``.  The JAX package
jits ``Kernel._trace_step`` with in/out shardings and lets GSPMD insert
the collectives.  PyTorch has no GSPMD, so the sharded tick is written
out here (:meth:`ShardedKernel._mesh_step`):

- **State.** Every ``WorldState`` leaf follows the JAX package's leaf rule
  (:func:`world_shardings`): a leaf whose leading axis is positive and
  divisible by the mesh width D is held as D row blocks, one per shard;
  any other leaf, and ``tick`` and ``rng``, is replicated on every shard.
  Each shard's blocks form a ``WorldState`` of their own.
- **Row-local phases** (timers, ``wander``, ``regen``, ``level``, stat
  ``recompute``, buffs, death, diff extraction) run once per shard on that
  shard's blocks.  A draw from the tick's threefry stream takes the
  shard's slice of the whole draw (``ctx.row_offset``), never the bank.
- **Phases that need the global view** carry a ``mesh_fn``
  (kernel/module.py): combat gathers the columns its fold reads, and every
  shard builds the cell tables and launches the fold kernel itself,
  keeping its own rows' results; the row migration and the spatial preset
  run their ``shard_map`` bodies through parallel/collectives.py.
- **Digest.** ``state_digest`` folds each bank as ``sum(u32(x_i) *
  (2i + 1))`` with a rolling multiply between banks: each shard folds its
  blocks at their global flat offset, the partials are ``psum``'d mod 2^32
  bank by bank before the bank's multiply, and a replicated bank counts
  once.  Counter banks are ``psum``'d (a 0-dim counter, the same on every
  shard, is kept once); masks (``fired``, ``diff``, ``died``, ``rec_diff``)
  are concatenated in row order.  ``tick()`` returns the JAX package's
  host surface.

The sharded tick runs eagerly: it is not captured as a CUDA graph.

While a world is placed, the blocks hold its rows and ``kernel.state``
reads them back as one state on demand (``Kernel.state``); a host write
to ``kernel.state`` supersedes the blocks, which are split again before
the next sharded step.  On a virtual mesh a split is free (row blocks are
views of the bank).

Entities don't migrate between shards here: a row's shard is fixed by its
index, and visibility crosses shards through the collectives.  For
locality-tuned placement, ``shard_rows_by_cell`` orders rows so a cell
lands on one shard; row migration itself is parallel/rowmigrate.py.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.prng import MASK32
from ..core.store import WorldState
from ..core.tree import flatten, unflatten
from ..kernel.kernel import (
    _DIGEST_CHUNK,
    _DIGEST_MULT,
    _DIGEST_SEED,
    Kernel,
    ObjectEvent,
    _as_int32,
    _assert_train_lanes,
    _digest_u32,
)
from ..telemetry.tracing import device_annotation as _annotate
from . import collectives as coll
from .mesh import ROOMS_AXIS, SHARD_AXIS, Mesh, Sharding, make_mesh

_REPLICATED_PATHS = (".tick", ".rng")


def _row_leaf(leaf, n_dev: int) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.dim() >= 1 and leaf.shape[0] > 0
            and leaf.shape[0] % n_dev == 0)


def world_shardings(state: WorldState, mesh: Mesh, axis: str = SHARD_AXIS):
    """The tree of :class:`~.mesh.Sharding` matching ``state``: row blocks
    for per-entity leaves, replication for scalars, keys and leaves whose
    leading axis does not divide the mesh (aux included)."""
    row, rep = Sharding(mesh, (axis,)), Sharding(mesh, ())
    _leaves, spec, _paths, flags = row_flags(state, mesh)
    return unflatten(spec, [row if f else rep for f in flags])


def room_shardings(state, mesh: Mesh, axis: str = ROOMS_AXIS):
    """The shardings of a ROOM-BATCHED state: every leaf carries a leading
    ``[R]`` room axis (tick and rng included), so the whole tree shards
    room-major; a leaf without a divisible ``[R]`` axis raises."""
    row = Sharding(mesh, (axis,))
    leaves, spec, _ = flatten(state)
    for x in leaves:
        if not (isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] > 0
                and x.shape[0] % mesh.size == 0):
            raise ValueError(
                f"room-batched leaf shape {tuple(getattr(x, 'shape', ()))} has no [R] "
                f"axis divisible by {mesh.size} devices: RoomBatch pads capacity to "
                "pow2; is this state batched?")
    return unflatten(spec, [row] * len(leaves))


def row_flags(state, mesh: Mesh) -> Tuple[List[torch.Tensor], object, List[str], List[bool]]:
    """``flatten(state)`` plus, per leaf, whether it is row-blocked."""
    leaves, spec, paths = flatten(state)
    flags = [p not in _REPLICATED_PATHS and _row_leaf(x, mesh.size)
             for x, p in zip(leaves, paths)]
    return leaves, spec, paths, flags


def split_state(state, mesh: Mesh, all_rows: bool = False) -> list:
    """One tree per local shard: row leaves cut into their blocks (views
    when the shard's device is the leaf's), replicated leaves copied to
    the shard's device (shared by the shards of one device).
    ``all_rows``: every leaf is row-blocked (a room-batched state)."""
    leaves, spec, _paths, flags = row_flags(state, mesh)
    if all_rows:
        flags = [True] * len(leaves)
    d = mesh.size
    out = []
    for idx in mesh.local:
        dev = mesh.devices[idx]
        blk = []
        for x, row in zip(leaves, flags):
            if row:
                b = x.shape[0] // d
                x = x[idx * b:(idx + 1) * b]
            blk.append(x.to(dev))
        out.append(unflatten(spec, blk))
    return out


def join_state(blocks: Sequence, row_paths, mesh: Mesh, device: torch.device):
    """The inverse of :func:`split_state` onto ``device``: row leaves (by
    path) concatenated in shard order, others taken from the first
    block."""
    per = [flatten(b) for b in blocks]
    spec, paths = per[0][1], per[0][2]
    leaves = []
    for j, p in enumerate(paths):
        if p in row_paths:
            leaves.append(coll.gather_blocks(mesh, [f[0][j] for f in per], device))
        else:
            leaves.append(per[0][0][j].to(device))
    return unflatten(spec, leaves)


def _partial_fold(arr: torch.Tensor, offset: int) -> torch.Tensor:
    """``sum(u32(x_i) * (2 (offset + i) + 1)) mod 2^32`` (int64 0-dim)."""
    x = _digest_u32(arr).reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=arr.device)
    for start in range(0, x.shape[0], _DIGEST_CHUNK):
        part = x[start:start + _DIGEST_CHUNK]
        w = torch.arange(offset + start, offset + start + part.shape[0],
                         dtype=torch.int64, device=arr.device) * 2 + 1
        total = (total + ((part * w) & MASK32).sum()) & MASK32
    return total


class ShardInfo:
    """One shard of a sharded tick, as a TickCtx sees it (``ctx.shard``)."""

    def __init__(self, sharded: "ShardedKernel", index: int):
        self.sharded = sharded
        self.mesh = sharded.mesh
        self.index = int(index)

    def rows(self, class_name: str) -> int:
        """The class's global capacity."""
        return self.sharded.kernel.store.capacity(class_name)

    def is_rows(self, class_name: str) -> bool:
        return class_name not in self.sharded.replicated_classes

    def row_offset(self, class_name: str) -> int:
        if not self.is_rows(class_name):
            return 0
        return self.index * (self.rows(class_name) // self.mesh.size)


class ShardedKernel:
    """Wraps a built Kernel to run its tick sharded over a mesh.

    Usage::

        k.build(...); sk = ShardedKernel(k, mesh=make_mesh(4))
        sk.place()          # split the state onto the mesh
        sk.tick()           # sharded observed step (host surface intact)
        sk.run_device(n)    # n sharded headless steps
    """

    def __init__(self, kernel: Kernel, n_devices: Optional[int] = None,
                 mesh: Optional[Mesh] = None):
        self.kernel = kernel
        self.mesh = mesh if mesh is not None else make_mesh(n_devices)
        self.replicated_classes = self._scan_classes(self.mesh)
        # per local shard: that shard's block WorldState; None while the
        # host's kernel state is newer
        self.blocks: Optional[List[WorldState]] = None
        self._blocks_newer = False
        self._row_paths: set = set()
        self._train_k = 0
        self._seen_trace_gen = kernel._trace_gen
        self._step_fn = None
        self._run_fn = None
        self._train_fn = None
        self.splits = 0
        # collective bytes of the last sharded step (mesh.bytes_moved delta)
        self.last_step_bytes = 0

    # -- policy ----------------------------------------------------------------

    def _scan_classes(self, mesh: Mesh) -> List[str]:
        """Capacity/divisibility policy for one mesh width: a small
        control-plane class (<= max(64, 2D) rows) whose capacity does not
        divide the mesh is replicated, with a warning; a bigger one raises
        (replicating a real entity bank is a perf trap).  Re-run on every
        reshard."""
        n_dev = mesh.size
        replicate_limit = max(64, 2 * n_dev)
        replicated = []
        for cname in self.kernel.store.class_order:
            cap = self.kernel.store.capacity(cname)
            if cap % n_dev != 0:
                if cap <= replicate_limit:
                    replicated.append(cname)
                    continue
                raise ValueError(
                    f"class {cname!r} capacity {cap} not divisible by "
                    f"{n_dev} devices — pad StoreConfig.capacities")
        if replicated:
            warnings.warn(
                f"ShardedKernel: classes {replicated} have capacities not divisible "
                f"by {n_dev} devices and will be REPLICATED on every device",
                stacklevel=3)
        return replicated

    def _sync_generation(self) -> None:
        """Drop the sharded dispatchers when the kernel invalidated
        (overflow resize, set_phases, digest enable); the kernel's
        invalidate already dropped the aux caches from its state, and so
        the blocks."""
        gen = self.kernel._trace_gen
        if gen != self._seen_trace_gen:
            self._step_fn = self._run_fn = self._train_fn = None
            self._seen_trace_gen = gen

    # -- placement ---------------------------------------------------------------

    def place(self) -> None:
        """Split the kernel's state onto the mesh (aux primed first)."""
        k = self.kernel
        k.sharded = None
        k._ensure_aux()
        k.sharded = self
        self._split()

    def _split(self) -> None:
        k = self.kernel
        _leaves, _spec, paths, flags = row_flags(k._state, self.mesh)
        self._row_paths = {p for p, f in zip(paths, flags) if f}
        self.blocks = split_state(k._state, self.mesh)
        self._blocks_newer = False
        self.splits += 1

    def reshard(self, new_mesh: Optional[Mesh] = None, cause: str = "reshard") -> Mesh:
        """Re-place the live world onto ``new_mesh`` (or the current mesh:
        the snapshot-load path).  No row is dropped: the leading axis is
        block-partitioned, so a row's shard is a function of its global
        index, which does not change here.  The CostBook generation bump
        comes first, so the re-signatures the new topology forces are
        sanctioned, and the Verlet/binning aux caches are dropped
        (``kernel.invalidate``) as on row arrival."""
        k = self.kernel
        old_n = self.mesh.size
        mesh = self.mesh if new_mesh is None else new_mesh
        self.replicated_classes = self._scan_classes(mesh)
        k.costbook.generation_bump(f"{cause}:{old_n}->{mesh.size}")
        state = k.state  # the blocks' rows, assembled
        k.sharded = None
        k._state = state
        k.invalidate()
        k._ensure_aux()
        self.mesh = mesh
        self._step_fn = self._run_fn = self._train_fn = None
        self._seen_trace_gen = k._trace_gen
        k.sharded = self
        self._split()
        return mesh

    def sync_host(self) -> None:
        """Assemble the blocks into the kernel's state when they are newer."""
        if self._blocks_newer:
            self.kernel._state = join_state(self.blocks, self._row_paths, self.mesh,
                                            self.kernel.device)
            self._blocks_newer = False

    def host_wrote(self) -> None:
        """The kernel's state was replaced on the host: the blocks are stale."""
        self.blocks = None
        self._blocks_newer = False

    def _current_blocks(self) -> List[WorldState]:
        k = self.kernel
        self._sync_generation()
        missing = self.blocks is not None and any(
            key not in self.blocks[0].aux for key in k._aux_init)
        if missing:
            self.sync_host()
            self.blocks = None
        if self.blocks is None:
            k.sharded = None
            k._ensure_aux()
            k.sharded = self
            self._split()
        return self.blocks

    def rows_of(self, fn) -> torch.Tensor:
        """``fn`` of the world's state for a row-blocked leaf, read off the
        blocks without assembling the rest (``fn(block)`` per shard,
        concatenated in row order)."""
        if self.blocks is None:
            return fn(self.kernel._state)
        return coll.gather_blocks(self.mesh, [fn(b) for b in self.blocks],
                                  self.mesh.devices[self.mesh.local[0]])

    def _set_blocks(self, blocks: List[WorldState]) -> None:
        self.blocks = blocks
        self._blocks_newer = True

    # -- the sharded step ----------------------------------------------------------

    def _mesh_step(self, blocks: List[WorldState], observe: bool):
        k = self.kernel
        mesh = self.mesh
        bytes0 = mesh.bytes_moved
        olds = blocks
        states, ctxs = coll.per_shard(
            mesh, lambda idx, blk: k._begin_step(blk, ShardInfo(self, idx)), blocks)
        for phase in k._composed:
            with _annotate(f"nf.phase.{phase.name}"):
                if phase.mesh_fn is not None:
                    states = list(phase.mesh_fn(states, ctxs))
                else:
                    states = coll.per_shard(mesh, lambda _i, st, c, fn=phase.fn: fn(st, c),
                                            states, ctxs)
        states = [st.replace(tick=st.tick + 1) for st in states]
        if not observe:
            self.last_step_bytes = mesh.bytes_moved - bytes0
            return states, None
        with _annotate("nf.diff"):
            raw = self._observe(olds, states, ctxs)
        self.last_step_bytes = mesh.bytes_moved - bytes0
        return states, raw

    def _observe(self, olds, states, ctxs) -> Dict[str, object]:
        """The observed lanes of one sharded step, as one device's step
        would give them."""
        k = self.kernel
        mesh = self.mesh
        home = mesh.devices[mesh.local[0]]
        lanes = [k._class_lanes(o, n) for o, n in zip(olds, states)]
        order = k.store.class_order
        rep = set(self.replicated_classes)

        def cat(blocks, cname):
            if cname in rep:
                return blocks[0].to(home)
            return coll.gather_blocks(mesh, list(blocks), home)

        # every per-shard count that sums over rows, in one psum
        sum_keys: List[Tuple[str, ...]] = []
        for cname in order:
            if cname not in rep:
                sum_keys.append(("died", cname))
        for cname in sorted(lanes[0][1]):
            if cname not in rep:
                sum_keys.append(("diff", cname))
        for cname in sorted(lanes[0][3]):
            if cname not in rep:
                sum_keys.append(("rec", cname))
        events = [list(c.emitted) for c in ctxs]
        for e, ev in enumerate(events[0]):
            if ev.class_name not in rep:
                sum_keys.append(("event", e))
        scalar = ctxs[0]._counter_scalar
        for name in sorted(ctxs[0]._counters):
            if name not in scalar:
                sum_keys.append(("counter", name))

        def per_shard_count(i, key):
            kind, name = key
            if kind == "died":
                return lanes[i][5][name]
            if kind == "diff":
                return lanes[i][1][name]
            if kind == "rec":
                return lanes[i][3][name]
            if kind == "event":
                return torch.sum(events[i][name].mask, dtype=torch.int32)
            return ctxs[i]._counters[name]

        totals = {}
        if sum_keys:
            parts = [torch.stack([per_shard_count(i, key).to(torch.int32).reshape(())
                                  for key in sum_keys]) for i in range(len(states))]
            summed = coll.psum(mesh, parts)[0].to(home)
            totals = {key: summed[j] for j, key in enumerate(sum_keys)}

        def total(kind, name, local):
            return totals[(kind, name)] if (kind, name) in totals else local.to(home)

        diff, diff_count, rec_diff, rec_diff_count, died, died_count = {}, {}, {}, {}, {}, {}
        for cname in order:
            died[cname] = cat([ln[4][cname] for ln in lanes], cname)
            died_count[cname] = total("died", cname, lanes[0][5][cname])
        for cname in lanes[0][0]:
            diff[cname] = {b: cat([ln[0][cname][b] for ln in lanes], cname)
                           for b in lanes[0][0][cname]}
            diff_count[cname] = total("diff", cname, lanes[0][1][cname])
        for cname in lanes[0][2]:
            rec_diff[cname] = {r: cat([ln[2][cname][r] for ln in lanes], cname)
                               for r in lanes[0][2][cname]}
            rec_diff_count[cname] = total("rec", cname, lanes[0][3][cname])
        fired = {cname: cat([c._fired[cname] for c in ctxs], cname) for cname in order}
        ev_lanes, ev_counts = [], []
        for e, ev in enumerate(events[0]):
            mask = cat([evs[e].mask for evs in events], ev.class_name)
            params = {p: cat([evs[e].params[p] for evs in events], ev.class_name)
                      for p in ev.params}
            ev_lanes.append((mask, params))
            ev_counts.append(total("event", e, torch.sum(events[0][e].mask,
                                                          dtype=torch.int32)))
        counters = {name: total("counter", name, v)
                    for name, v in ctxs[0]._counters.items()}
        if k.digest_enabled:
            counters["state_digest"] = _as_int32(self._digest(states)).to(home)
        tick = states[0].tick.to(home)
        summary = k._pack_summary(ctxs[0], tick, died_count, diff_count, rec_diff_count,
                                  ev_counts, counters)
        return {
            "fired": fired,
            "diff": diff,
            "diff_count": diff_count,
            "rec_diff": rec_diff,
            "rec_diff_count": rec_diff_count,
            "died": died,
            "died_count": died_count,
            "events": ev_lanes,
            "summary": summary,
        }

    def _digest(self, blocks: List[WorldState]) -> torch.Tensor:
        """``state_digest`` of the world the blocks make up."""
        k = self.kernel
        parts = []
        for blk, idx in zip(blocks, self.mesh.local):
            # a replicated bank is folded once, by shard 0
            vec = [_partial_fold(blk.tick, 0) if idx == 0 else None,
                   _partial_fold(blk.rng, 0) if idx == 0 else None]
            for cname in k.store.class_order:
                rows = cname not in self.replicated_classes
                cs = blk.classes[cname]
                banks = [cs.i32, cs.f32, cs.vec, cs.alive, cs.timers.next_fire,
                         cs.timers.interval, cs.timers.remain, cs.timers.active]
                for rname in sorted(cs.records):
                    rec = cs.records[rname]
                    banks += [rec.i32, rec.f32, rec.vec, rec.used]
                for arr in banks:
                    if rows:
                        vec.append(_partial_fold(arr, idx * arr.numel()))
                    else:
                        vec.append(_partial_fold(arr, 0) if idx == 0 else None)
            dev = blk.tick.device
            z = torch.zeros((), dtype=torch.int64, device=dev)
            parts.append(torch.stack([z if v is None else v for v in vec]))
        total = coll.psum(self.mesh, parts)[0] & MASK32
        acc = torch.full((), _DIGEST_SEED, dtype=torch.int64, device=total.device)
        for j in range(total.shape[0]):
            acc = (acc * _DIGEST_MULT + total[j]) & MASK32
        return acc

    def digest(self) -> int:
        """The current world's ``state_digest`` as a Python int (uint32)."""
        return int(self._digest(self._current_blocks()).item())

    # -- entry points --------------------------------------------------------------

    def _wrap(self, name: str, fn, statics):
        return self.kernel.costbook.wrap(name, fn, stage="tick", statics=statics)

    def tick_begin(self) -> Dict[str, object]:
        """One sharded observed step; its raw lanes, not yet fetched."""
        k = self.kernel
        blocks = self._current_blocks()
        if self._step_fn is None:
            self._step_fn = self._wrap("kernel.sharded_step",
                                       lambda bl: self._mesh_step(bl, True), k._statics)
        with k._span("kernel.dispatch"):
            new, raw = self._step_fn(blocks)
        self._set_blocks(new)
        k.tick_count += 1
        return raw

    def tick(self):
        """One sharded step with full host observation (events, deaths,
        diffs): the same surface as ``Kernel.tick``."""
        return self.kernel.tick_finish(self.tick_begin())

    def run_device(self, n: int, fused: bool = True, reconcile: bool = False) -> int:
        """n sharded headless steps with no host sync.  ``fused`` is the
        JAX package's knob (one program or one dispatch a tick); here both
        run the same eager loop.  ``reconcile`` frees the rows that died
        (``Kernel.run_device`` passes True); returns the rows freed."""
        del fused
        k = self.kernel
        n = int(n)
        blocks = self._current_blocks()
        if n > 0:
            if self._run_fn is None:
                self._run_fn = self._wrap("kernel.sharded_run",
                                          lambda bl: (self._mesh_step(bl, False)[0], None),
                                          k._statics)
            with k._span("kernel.dispatch"):
                blocks, _ = self._run_fn(blocks, times=n)
            self._set_blocks(blocks)
        k.tick_count += n
        if not reconcile:
            return 0
        freed = 0
        for cname in k.store.class_order:
            for g in k.store.reconcile_deaths(k.state, cname):
                k._fire_class_event(g, cname, ObjectEvent.DESTROY)
                freed += 1
        return freed

    # -- K-tick trains -------------------------------------------------------------

    def configure_train(self, k: int) -> None:
        """Pin the sharded train length (see Kernel.configure_train); the
        kernel's K is kept in sync, so its lane fan-out slices the right
        depth."""
        self.kernel.configure_train(k)
        if int(k) != self._train_k:
            self._train_k = int(k)
            self._train_fn = None

    def _mesh_train(self, blocks):
        kk = self._train_k
        bufs = spec = raw = None
        for i in range(kk):
            blocks, raw = self._mesh_step(blocks, True)
            leaves, lane_spec, _ = flatten(raw)
            if bufs is None:
                spec = lane_spec
                bufs = [torch.empty((kk, *x.shape), dtype=x.dtype, device=x.device)
                        for x in leaves]
            for b, x in zip(bufs, leaves):
                b[i].copy_(x)
        _assert_train_lanes(raw)
        return blocks, unflatten(spec, bufs)

    def train_begin(self) -> Dict[str, object]:
        k = self.kernel
        if self._train_k < 1:
            raise RuntimeError("configure_train(k) before train()")
        blocks = self._current_blocks()
        if self._train_fn is None:
            self._train_fn = self._wrap("kernel.sharded_train", self._mesh_train,
                                        k._train_statics)
        with k._span("kernel.dispatch"):
            new, raw = self._train_fn(blocks)
        self._set_blocks(new)
        k.tick_count += self._train_k
        k.train_dispatches += 1
        k.train_ticks += self._train_k
        return raw

    def train(self, n: int):
        """n sharded frames in n // K train dispatches plus a per-tick
        ragged tail, with full host observation per frame."""
        if self._train_k < 1:
            raise RuntimeError("configure_train(k) before train()")
        return self.kernel.train(n)


def shard_rows_by_cell(n: int, n_devices: int, cell: np.ndarray) -> np.ndarray:
    """Allocation helper: order n new rows so entities of one (scene,group)
    cell land contiguously, i.e. on as few shards as possible.  Returns a
    permutation of arange(n); pass positions/cells through it before
    create_many so row index ~ locality."""
    return np.argsort(cell, kind="stable")
