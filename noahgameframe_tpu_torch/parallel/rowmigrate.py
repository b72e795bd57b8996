"""Full-row cross-shard migration: the slab protocol over ClassState.

Counterpart of ``noahgameframe_tpu/parallel/rowmigrate.py``.  A migrating
entity moves its ENTIRE ``ClassState`` row (every property bank, every
record page, the timer banks and the alive bit) toward the shard that owns
its position, in a budgeted round per direction:

1. each shard advertises its free-slot count BEFORE clearing its own
   outbound rows (the advertised number only understates reality); a
   sender clamps to ``min(budget, advertised)``, so a row that would find
   no destination slot stays home and retries next tick;
2. the selected rows pack into fixed ``[budget]`` buffers, one
   ``ppermute`` per leaf per direction;
3. arrivals scatter into free-slot ranks; a drop here is a protocol bug
   (counted, never expected).

The JAX package writes the round under ``shard_map``; here it runs over
the list of every local shard's blocks with the collectives of
parallel/collectives.py (:func:`migrate_rows`).  In a one-device tick the
migrate phase splits the class over the module's mesh, runs the round and
joins the blocks again, as the JAX package's ``shard_map`` reshards an
unsharded input; in a sharded tick (``mesh_fn``) it runs on the shards'
own blocks.  Every scatter is a sync-free index write into a padded
buffer, so the round needs no host sync.

The pack list is derived from the store by
``persist.rowblob.class_row_leaf_items``, so a new bank cannot be left
behind.  Verlet/binning caches live in ``WorldState.aux`` and are not
migrated: they are dropped and rebuilt on arrival.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.prng import MASK32
from ..core.rounding import recip32
from ..core.store import ClassState, WorldState, with_class
from ..kernel.kernel import _DIGEST_CHUNK, _digest_u32
from ..kernel.module import Module
from ..persist.rowblob import class_row_leaf_items, rebuild_class_state, row_nbytes
from . import collectives as coll
from .mesh import SHARD_AXIS, Mesh, make_mesh


def _pack_rows(sel, rank, budget: int, *arrays):
    """Gather up to ``budget`` selected rows into fixed ``[budget]``
    buffers.  ``sel``: [n] bool, ``rank``: [n] exclusive rank among the
    selected.  Returns (valid [budget] bool, packed arrays); generic over
    trailing dims."""
    idx = torch.where(sel & (rank < budget), rank, budget).long()
    valid = torch.zeros((budget + 1,), dtype=torch.bool, device=sel.device)
    valid[idx] = sel
    out = []
    for a in arrays:
        buf = a.new_zeros((budget + 1,) + tuple(a.shape[1:]))
        buf[idx] = a
        out.append(buf[:budget])
    return valid[:budget], out


def _scatter_rows(cur: torch.Tensor, dest: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``cur.at[dest].set(rows, mode="drop")``: a dest of ``len(cur)`` (or
    more) writes into a discarded pad row."""
    n = cur.shape[0]
    pad = torch.cat([cur, cur.new_zeros((1,) + tuple(cur.shape[1:]))])
    pad[dest.clamp(max=n).long()] = rows
    return pad[:n]


def migrate_rows(mesh: Mesh, leaves: List[List[torch.Tensor]], alive: List[torch.Tensor],
                 owner_fn: Callable, budget: int):
    """One budgeted ``ppermute`` migration round over arbitrary row leaves.

    ``leaves[i]`` are local shard i's blocks (leading axis = the shard's
    bank rows) and ``alive[i]`` its occupancy mask; ``owner_fn(index,
    leaves, alive) -> [rows] int32`` gives each row's owning shard, and is
    evaluated again after each direction so arrivals never hop twice.
    A row stranded two or more shards from home hops one shard toward it
    per tick.  Returns (leaves, alive, (migrated, overflow, dropped)), the
    stats a list of int32 0-dim tensors per local shard."""
    n = mesh.size
    me = list(mesh.local)
    fwd, bwd = coll.ring(n, 1), coll.ring(n, -1)
    leaves = [list(ls) for ls in leaves]
    alive = list(alive)
    cap_rows = alive[0].shape[0]
    zero = [torch.zeros((), dtype=torch.int32, device=a.device) for a in alive]
    migrated, overflow, dropped = list(zero), list(zero), list(zero)
    owner = [owner_fn(idx, ls, al) for idx, ls, al in zip(me, leaves, alive)]
    for d, perm in ((1, fwd), (-1, bwd)):
        m = [al & ((ow > idx) if d == 1 else (ow < idx))
             for al, ow, idx in zip(alive, owner, me)]
        free_cnt = [torch.sum(~al, dtype=torch.int32) for al in alive]
        remote_free = coll.ppermute(mesh, free_cnt, bwd if d == 1 else fwd)
        sel, packed, valid = [], [], []
        for i in range(len(me)):
            cap_d = torch.clamp(remote_free[i], max=int(budget))
            csum = torch.cumsum(m[i].to(torch.int32), dim=0, dtype=torch.int32)
            s = m[i] & (csum <= cap_d)
            n_sel = torch.sum(s, dtype=torch.int32)
            migrated[i] = migrated[i] + n_sel
            overflow[i] = overflow[i] + torch.sum(m[i], dtype=torch.int32) - n_sel
            v, p = _pack_rows(s, csum - 1, budget, *leaves[i])
            sel.append(s)
            valid.append(v)
            packed.append(p)
        rvalid = coll.ppermute(mesh, valid, perm)
        rpacked = [coll.ppermute(mesh, [p[j] for p in packed], perm)
                   for j in range(len(leaves[0]))]
        for i, idx in enumerate(me):
            # wrap-around sends are impossible (owners are clipped into
            # range), but mask the circular receive for the edge shards
            sender_ok = 0 <= idx - d < n
            rv = rvalid[i] & sender_ok
            al = alive[i] & ~sel[i]
            # insert into free slots: dest[j] = row index of the j-th free slot
            free = ~al
            fi = free.to(torch.int32)
            frank = torch.cumsum(fi, dim=0, dtype=torch.int32) - fi
            slots = torch.where(free & (frank < budget), frank, budget).long()
            dest = torch.full((budget + 1,), cap_rows, dtype=torch.int32, device=al.device)
            dest[slots] = torch.arange(cap_rows, dtype=torch.int32, device=al.device)
            dest_j = torch.where(rv, dest[:budget], cap_rows)
            dropped[i] = dropped[i] + torch.sum(rv & (dest_j >= cap_rows), dtype=torch.int32)
            leaves[i] = [_scatter_rows(cur, dest_j, rpacked[j][i])
                         for j, cur in enumerate(leaves[i])]
            alive[i] = _scatter_rows(al, dest_j, torch.ones_like(rv))
            owner[i] = owner_fn(idx, leaves[i], alive[i])
    return leaves, alive, list(zip(migrated, overflow, dropped))


def migrate_class_blocks(mesh: Mesh, blocks: Sequence[ClassState], owner_fn: Callable,
                         budget: int, extra_leaves: Optional[Sequence[Sequence]] = None):
    """:func:`migrate_rows` over full ClassState row blocks, one per local
    shard.  ``owner_fn(index, {path: leaf}) -> [rows] int32`` reads the
    shard's leaves by ``persist.rowblob`` path (``alive`` included).
    ``extra_leaves[i]`` are further per-row arrays of shard i that move
    with the rows (the tick's fired mask).  Returns (new blocks, per shard
    a ``[1, 3]`` int32 stats row: migrated / budget overflow / dropped,
    new extras)."""
    items = [class_row_leaf_items(cs) for cs in blocks]
    paths = [p for p, _ in items[0]]
    ai = paths.index("alive")
    n_extra = len(extra_leaves[0]) if extra_leaves else 0
    others, alive = [], []
    for i, it in enumerate(items):
        arrs = [a for _, a in it]
        alive.append(arrs[ai])
        others.append(arrs[:ai] + arrs[ai + 1:] + (list(extra_leaves[i]) if n_extra else []))

    def owner_of(index, ls, alv):
        full: Dict[str, torch.Tensor] = {}
        j = 0
        for p in paths:
            if p == "alive":
                full[p] = alv
            else:
                full[p] = ls[j]
                j += 1
        return owner_fn(index, full)

    new_others, new_alive, stats = migrate_rows(mesh, others, alive, owner_of, budget)
    out, out_stats, out_extras = [], [], []
    n_row = len(paths) - 1
    for i, cs in enumerate(blocks):
        merged = new_others[i][:ai] + [new_alive[i]] + new_others[i][ai:n_row]
        out.append(rebuild_class_state(cs, merged))
        out_stats.append(torch.stack(list(stats[i]))[None, :])
        out_extras.append(new_others[i][n_row:])
    return out, out_stats, out_extras


def mesh_migrate_class(cs: ClassState, mesh: Mesh, owner_fn: Callable, budget: int,
                       axis: str = SHARD_AXIS, extra_leaves: Optional[Sequence] = None):
    """Migrate a whole class's rows toward their owning shard over
    ``mesh`` (one process): the rows are cut into the mesh's blocks, the
    round runs, and the blocks are joined again, as the JAX package's
    ``shard_map`` reshards an unsharded class.  ``owner_fn(index, {path:
    leaf})`` as in :func:`migrate_class_blocks`.  Returns (new ClassState,
    ``[n_shards, 3]`` int32 stats), plus the moved extras when given."""
    del axis
    d = mesh.size
    home = cs.alive.device
    cap = cs.alive.shape[0]
    if cap % d:
        raise ValueError(f"capacity {cap} not divisible by {d} shards")
    b = cap // d

    def cut(x, idx):
        return x[idx * b:(idx + 1) * b].to(mesh.devices[idx])

    items = class_row_leaf_items(cs)
    blocks = [rebuild_class_state(cs, [cut(a, idx) for _, a in items]) for idx in mesh.local]
    extras = ([[cut(x, idx) for x in extra_leaves] for idx in mesh.local]
              if extra_leaves else None)
    new_blocks, stats, new_extras = migrate_class_blocks(mesh, blocks, owner_fn, budget, extras)
    per = [class_row_leaf_items(c) for c in new_blocks]
    joined = [torch.cat([p[j][1].to(home) for p in per]) for j in range(len(items))]
    new_cs = rebuild_class_state(cs, joined)
    stats = torch.cat([s.to(home) for s in stats])
    if extra_leaves is None:
        return new_cs, stats
    return new_cs, stats, [torch.cat([e[j].to(home) for e in new_extras])
                           for j in range(len(extra_leaves))]


# -- GameWorld-facing placement config ---------------------------------------


@dataclasses.dataclass(frozen=True)
class SpatialPlacement:
    """Config-selected spatial placement: grid geometry plus migration
    budget as a kernel phase (``WorldConfig.placement``)."""

    class_name: str          # entity class whose rows migrate
    pos_prop: str            # vector property giving world position
    extent: float            # world is [0, extent)^2
    cell_size: float
    width: int               # cells per axis
    n_shards: int            # horizontal slabs
    mig_budget: int          # migrant rows per direction per shard per tick

    @property
    def slab_h(self) -> int:
        # ceil division: with width % n_shards != 0 (a drain to an odd
        # survivor count) the LAST shard owns a narrower slab, and
        # owner_of_pos stays in [0, n_shards) for every cell
        return -(-self.width // self.n_shards)

    def owner_of_pos(self, pos_xy: torch.Tensor) -> torch.Tensor:
        """[rows, 2+] positions -> [rows] int32 owning shard index (``y /
        cell_size`` as the reference's compiled code takes it, times the
        float32 reciprocal)."""
        cy = (pos_xy[:, 1] * recip32(self.cell_size)).to(torch.int32).clamp(0, self.width - 1)
        return cy // self.slab_h


class RowMigrationModule(Module):
    """Kernel module registering the ``migrate`` phase: full-row
    cross-shard migration for one class, keyed on its position property.

    Stats ride ``state.aux["rowmigrate.<class>.stats"]`` ([n_shards, 3]
    int32: migrated / budget overflow / dropped), and ``ctx.count`` mirrors
    the migrated and overflow totals into the tick's counter bank."""

    name = "rowmigrate"

    def __init__(self, placement: SpatialPlacement, mesh: Optional[Mesh] = None,
                 order: int = 20):
        super().__init__()
        self.placement = placement
        self.mesh = mesh if mesh is not None else make_mesh(placement.n_shards)
        if self.mesh.size != placement.n_shards:
            raise ValueError(f"mesh of {self.mesh.size} shards for a placement of "
                             f"{placement.n_shards}")
        self.aux_key = f"rowmigrate.{placement.class_name}.stats"
        # exodus overlay (parallel/elastic.py drain): owners remap through
        # a host table so rows vacate a draining shard; arming or clearing
        # it invalidates the kernel
        self._exodus_map: Optional[np.ndarray] = None
        self._exodus_tables: Dict[torch.device, torch.Tensor] = {}
        self.add_phase("migrate", self._migrate, order=order, mesh_fn=self._migrate_mesh)

    def bind(self, kernel) -> None:
        """Register the stats aux before the first tick."""
        self.kernel = kernel
        n = self.placement.n_shards
        kernel.register_aux(
            self.aux_key, lambda: torch.zeros((n, 3), dtype=torch.int32, device=kernel.device))

    def retarget(self, placement: Optional[SpatialPlacement] = None,
                 mesh: Optional[Mesh] = None) -> None:
        """Re-aim the migrate phase at a new placement and/or mesh (the
        elastic reshard path); the stats aux registers again at the new
        shard count.  The caller invalidates and re-places
        (``ShardedKernel.reshard``)."""
        if placement is not None:
            if placement.class_name != self.placement.class_name:
                raise ValueError("retarget cannot change the migrating "
                                 "class (aux key is class-keyed)")
            self.placement = placement
        if mesh is not None:
            self.mesh = mesh
        if self.kernel is not None:
            self.bind(self.kernel)

    def set_exodus(self, index_map) -> None:
        """Arm the drain overlay: spatial owner ``o`` re-homes to
        ``index_map[o]``, so every row owned by a draining shard moves to
        a surviving one."""
        self._exodus_map = np.asarray(index_map, np.int32)
        # the table on every shard device now, not inside a tick (a
        # host-to-device copy there would break a graph capture)
        # nf-lint: disable=recapture-hazard -- derived from _exodus_map,
        # which capture_key() names; this call invalidates the kernel
        self._exodus_tables = {dev: torch.as_tensor(self._exodus_map).to(dev)
                               for dev in set(self.mesh.devices)}
        if self.kernel is not None:
            self.kernel.invalidate()

    def clear_exodus(self) -> None:
        if self._exodus_map is None:
            return
        self._exodus_map = None
        if self.kernel is not None:
            self.kernel.invalidate()

    def capture_key(self) -> dict:
        return {"rowmigrate": (self.placement, self.mesh.key(),
                               None if self._exodus_map is None
                               else tuple(self._exodus_map.tolist()))}

    def after_init(self) -> None:
        if self.kernel is not None and self.aux_key not in self.kernel._aux_init:
            self.bind(self.kernel)

    def row_bytes(self) -> int:
        """Per-row wire bytes of the migrating class."""
        if self.kernel is None or self.kernel.state is None:
            return 0
        return row_nbytes(self.kernel.state.classes[self.placement.class_name])

    def _owner_fn(self, slot_col: int):
        pl = self.placement
        exodus = self._exodus_map
        tables = self._exodus_tables

        def owner_fn(index: int, leaves: Dict[str, torch.Tensor]) -> torch.Tensor:
            owner = pl.owner_of_pos(leaves["vec"][:, slot_col, :])
            if exodus is not None:
                # while the drain is armed, only evacuation moves rows:
                # rows standing on the draining shard route to their
                # remapped owner, everyone else stays where it stands
                # (through-traffic would keep the draining bank occupied)
                if int(exodus[index]) != index:
                    return tables[owner.device][owner.long()]
                return torch.full_like(owner, index)
            return owner

        return owner_fn

    def _extras(self, ctx, cname: str):
        fired = ctx._fired.get(cname)
        return [fired] if fired is not None and fired.shape[1] else None

    def _finish(self, state: WorldState, ctx, cs2: ClassState, stats, new_fired):
        cname = self.placement.class_name
        if new_fired is not None:
            # vacated source slots keep stale mask bytes; dead rows never fire
            ctx.remap_fired(cname, new_fired & cs2.alive[:, None])
        ctx.count("migrated", stats[:, 0])
        ctx.count("mig_overflow", stats[:, 1])
        state = with_class(state, cname, cs2)
        return state.replace(aux={**state.aux, self.aux_key: stats})

    def _migrate(self, state: WorldState, ctx) -> WorldState:
        pl = self.placement
        cs = state.classes[pl.class_name]
        col = ctx.store.spec(pl.class_name).slot(pl.pos_prop).col
        extras = self._extras(ctx, pl.class_name)
        # nf-lint: disable=mesh-not-captured -- retarget()+invalidate()
        # re-aim it before the re-capture
        out = mesh_migrate_class(cs, self.mesh, self._owner_fn(col), pl.mig_budget,
                                 extra_leaves=extras)
        cs2, stats = out[0], out[1]
        return self._finish(state, ctx, cs2, stats, out[2][0] if extras else None)

    def _migrate_mesh(self, states, ctxs):
        pl = self.placement
        mesh = ctxs[0].shard.mesh
        if mesh.size != pl.n_shards:
            raise ValueError(f"migrate phase aimed at {pl.n_shards} shards on a mesh of "
                             f"{mesh.size}: retarget() it with the reshard")
        col = ctxs[0].store.spec(pl.class_name).slot(pl.pos_prop).col
        extras = [self._extras(c, pl.class_name) for c in ctxs]
        has_extras = extras[0] is not None
        blocks, stats, new_extras = migrate_class_blocks(
            mesh, [st.classes[pl.class_name] for st in states], self._owner_fn(col),
            pl.mig_budget, extras if has_extras else None)
        return [self._finish(st, c, cs2, s, ex[0] if has_extras else None)
                for st, c, cs2, s, ex in zip(states, ctxs, blocks, stats, new_extras)]


# -- placement-invariant digest (parity oracle) ---------------------------------


def _fold_sum(arr: torch.Tensor) -> int:
    """``sum(u32(x_i) * (2i + 1)) mod 2^32`` over ``arr``, on its device."""
    x = _digest_u32(arr).reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=arr.device)
    for start in range(0, x.shape[0], _DIGEST_CHUNK):
        part = x[start:start + _DIGEST_CHUNK]
        w = torch.arange(start, start + part.shape[0], dtype=torch.int64,
                         device=arr.device) * 2 + 1
        total = (total + ((part * w) & MASK32).sum()) & MASK32
    return int(total)


def canonical_digest(state: WorldState, class_order: Sequence[str],
                     ident_cols: Dict[str, int]) -> int:
    """Host-side uint32 digest invariant to row PLACEMENT, equal to the
    JAX package's: per class, live rows are ordered by a stable identity
    column (``ident_cols[cname]``, an i32 column holding unique ids), dead
    rows are dropped (a vacated slot keeps stale bytes by design), and
    ``state_digest``'s fold runs over that canonical view.  The folds run
    on the state's device; only their sums come to the host."""
    mult, mask = 1000003, 0xFFFFFFFF
    acc = 0x9E3779B9
    acc = (acc * mult + _fold_sum(state.tick)) & mask
    for cname in class_order:
        cs = state.classes[cname]
        live = torch.nonzero(cs.alive).reshape(-1)
        ident = cs.i32[:, ident_cols[cname]][live]
        order = live[torch.sort(ident, stable=True).indices]
        acc = (acc * mult + int(live.shape[0]) % (1 << 32)) & mask
        for path, arr in class_row_leaf_items(cs):
            if path == "alive":
                continue  # the canonical view is all-live by construction
            acc = (acc * mult + _fold_sum(arr[order])) & mask
    return int(acc)
