"""Spatially-sharded combat preset over the mesh engine.

Counterpart of ``noahgameframe_tpu/parallel/spatial.py``.  Entities live
in a real ``ClassState`` (the "spatial" class: five int properties and a
vector2 position), the tick is the sharded kernel step
(parallel/shard.py), and cross-shard migration is the full-row protocol
of parallel/rowmigrate.py.  Phase chain:

- ``spatial.walk`` (order 10): a deterministic per-gid random walk, pure
  elementwise, the same on any placement;
- ``rowmigrate.migrate`` (order 20): budgeted migration of full rows
  toward the shard owning their cell row;
- ``spatial.combat`` (order 30): per-slab cell tables, one dense halo
  plane of attackers from each neighbour (``ppermute``), the combat fold
  closure over the halo'd slab, then damage, regen and respawn.

The fold is the plain closure of the JAX package's preset (its XLA fold;
``ops.stencil_cuda.combat_fold_closure``), not a hand kernel: the
preset's slabs with their halos are rectangular grids.  The attacker
``row`` payload column carries the global gid, damage sums are exact
int32 in f32, and ties reduce over gid, so within migration and bucket
budgets the preset gives the HP trajectories of :func:`reference_step`,
the single-device oracle.

Verlet/binning caches ride ``WorldState.aux``: rebuilt, never migrated,
and outside ``state_digest``.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.prng import MASK32
from ..core.rounding import recip32
from ..core.schema import ClassDef, ClassRegistry, prop
from ..core.store import StoreConfig, with_class
from ..kernel.kernel import Kernel
from ..kernel.module import Module
from ..ops.stencil import binning_mode, build_cell_table_pair, pull
from ..ops.stencil_cuda import combat_fold_closure, combat_fold_plain
from ..ops.verlet import VerletCache, full_table, mesh_refresh, sub_table
from . import collectives as coll
from .mesh import Mesh, make_mesh
from .rowmigrate import RowMigrationModule, SpatialPlacement
from .shard import ShardedKernel

# i32 property columns of the "spatial" class, in definition order
_HP, _ATK, _CAMP, _GID, _DIED = range(5)
_POS = 0  # vec column


class SpatialGeom(NamedTuple):
    """Static geometry of the spatially-sharded world."""

    extent: float          # world is [0, extent)^2
    cell_size: float
    width: int             # cells per axis; grid [width, width]
    n_shards: int          # horizontal slabs; width % n_shards == 0
    bucket: int            # victim slots per cell
    att_bucket: int        # attacker slots per cell
    radius: float          # AoE radius (<= cell_size)
    mig_budget: int        # migrant rows per direction per shard per tick
    speed: float = 0.5     # random-walk step per tick (< cell_size)
    attack_period: int = 30  # a gid attacks every `attack_period` ticks
    # the rest of the benchmark phase chain (0 disables either):
    regen_per_tick: int = 0   # hp regained per tick while alive
    hp_max: int = 0           # regen/respawn ceiling (0 = no ceiling)
    respawn_ticks: int = 0    # dead rows revive at hp_max after this many
    # Verlet skin (ops/verlet.py): > 0 gates the per-slab build on
    # accumulated displacement; needs cell_size >= radius + skin.  A tick
    # that migrates a row changes the in-slab mask and forces a rebuild.
    skin: float = 0.0

    @property
    def slab_h(self) -> int:
        return self.width // self.n_shards

    def placement(self, class_name: str = "spatial",
                  pos_prop: str = "pos") -> SpatialPlacement:
        """The rowmigrate config this geometry implies."""
        return SpatialPlacement(
            class_name=class_name, pos_prop=pos_prop, extent=self.extent,
            cell_size=self.cell_size, width=self.width,
            n_shards=self.n_shards, mig_budget=self.mig_budget,
        )


class SpatialState(NamedTuple):
    """Host-facing VIEW of the engine's state: column slices of the
    "spatial" ClassState banks plus the aux-carried Verlet cache.  Leading
    axis = n_shards * bank_size; shard i holds rows [i*bank, (i+1)*bank)."""

    pos: torch.Tensor        # [cap, 2] f32
    hp: torch.Tensor         # [cap] i32
    atk: torch.Tensor        # [cap] i32
    camp: torch.Tensor       # [cap] i32
    gid: torch.Tensor        # [cap] i32, stable global id, rides migration
    died: torch.Tensor       # [cap] i32, tick of death, -1 while alive
    active: torch.Tensor     # [cap] bool
    vc_pos: torch.Tensor     # [cap, 2] f32, anchor positions
    vc_active: torch.Tensor  # [cap] bool, anchor in-slab mask
    vc_order: torch.Tensor   # [cap] i32
    vc_skey: torch.Tensor    # [cap] i32
    vc_slot: torch.Tensor    # [cap] i32
    cstat: torch.Tensor      # [n_shards, 3] i32: rebuilds/reuses/age per shard


def _walk(pos, gid, tick, geom: SpatialGeom):
    """Deterministic per-gid random walk: a pure function of (gid, tick)
    through a murmur3-style finalizer (a linear hash turns every heading
    by a constant and piles walkers into the corners)."""
    t = tick.to(torch.int64) & MASK32 if isinstance(tick, torch.Tensor) else int(tick) & MASK32
    h = ((gid.to(torch.int64) & MASK32) * 2654435761 + t * 40503) & MASK32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK32
    h = h ^ (h >> 16)
    ang = (h >> 8).to(torch.float32) * float(np.float32(2.0 * np.pi / float(1 << 24)))
    # cos/sin in float64, rounded to float32: the card's float32 cos/sin
    # differ from the CPU's in the last bit for ~20 % of these angles, their
    # float64 results round alike (0 of 2,396,746 angles on an H100)
    ang = ang.to(torch.float64)
    step = (torch.stack([torch.cos(ang), torch.sin(ang)], -1).to(torch.float32)
            * float(np.float32(geom.speed)))
    eps = 1e-3
    return torch.clamp(pos + step, float(np.float32(eps)),
                       float(np.float32(geom.extent - eps)))


def _life_phases(geom: SpatialGeom, hp, died, incoming, tick):
    """Damage -> death mark -> regen -> respawn, shared by the spatial
    tick and the single-device oracle (elementwise)."""
    hp_after = torch.clamp(hp - incoming, min=0)
    died = torch.where((hp > 0) & (hp_after == 0), tick, died)
    if geom.regen_per_tick > 0:
        regen = torch.where(hp_after > 0, hp_after + geom.regen_per_tick, hp_after)
        if geom.hp_max > 0:
            regen = torch.clamp(regen, max=geom.hp_max)
        hp_after = regen
    if geom.respawn_ticks > 0:
        revive = (hp_after == 0) & (died >= 0) & (tick - died >= geom.respawn_ticks)
        hp_after = torch.where(revive, geom.hp_max, hp_after)
        died = torch.where(revive, -1, died)
    return hp_after.to(torch.int32), died.to(torch.int32)


def _cells(pos, geom: SpatialGeom):
    """(cx, cy) int32 cell coordinates; ``pos / cell`` as the reference's
    compiled code takes it, times the float32 reciprocal."""
    inv = recip32(geom.cell_size)
    w = geom.width
    cx = (pos[:, 0] * inv).to(torch.int32).clamp(0, w - 1)
    cy = (pos[:, 1] * inv).to(torch.int32).clamp(0, w - 1)
    return cx, cy


def _combat_body(geom: SpatialGeom, mesh: Mesh, cols, vcs, tick):
    """Combat on every local shard: ``cols[i]`` is shard i's (pos, hp,
    atk, camp, gid, died, active) and ``vcs[i]`` its Verlet cache leaves.
    Movement and migration already ran; cells are derived from the
    post-migration positions.  Returns per shard (hp, died, vc, stats)."""
    n = mesh.size
    hs, w = geom.slab_h, geom.width
    f32 = torch.float32
    pre = []
    for (pos, hp, atk, camp, gid, died, active), me in zip(cols, mesh.local):
        cx, cy = _cells(pos, geom)
        owner = cy // hs
        in_slab = active & (owner == me)
        misplaced = torch.sum(active & (owner != me), dtype=torch.int32)
        cell_local = (cy - me * hs) * w + cx
        camp_f = camp.to(f32)
        zeros_f = torch.zeros_like(camp_f)
        vic_feats = torch.stack([pos[:, 0], pos[:, 1], camp_f, zeros_f, zeros_f], -1)
        attacking = in_slab & (hp > 0) & (torch.remainder(gid + tick, geom.attack_period) == 0)
        eff_atk = torch.where(attacking, atk, 0).to(f32)
        att_feats = torch.stack([pos[:, 0], pos[:, 1], eff_atk, camp_f, zeros_f, zeros_f,
                                 gid.to(f32)], -1)
        pre.append((pos, in_slab, misplaced, cell_local, vic_feats, attacking, att_feats))

    tables, new_vcs = [], []
    if geom.skin > 0.0:
        # displacement-gated build: the anchor mask is the in-slab set, so
        # a migration forces a rebuild, and the vote is pmax'd over the
        # mesh so every shard's cache takes the same branch
        caches = [VerletCache(vc["pos"], vc["active"], vc["order"], vc["skey"], vc["slot"],
                              vc["cstat"][0, 0], vc["cstat"][0, 1], vc["cstat"][0, 2])
                  for vc in vcs]
        refreshed = mesh_refresh(mesh, caches, [p[0] for p in pre], [p[1] for p in pre],
                                 geom.cell_size, w, geom.bucket, geom.skin,
                                 cells=[p[3] for p in pre], n_cells=hs * w)
        for (cache, _rebuilt), p in zip(refreshed, pre):
            _pos, in_slab, _m, _c, vic_feats, attacking, att_feats = p
            tables.append((
                full_table(cache, vic_feats, in_slab, hs * w, geom.cell_size, w,
                           geom.bucket, height=hs),
                sub_table(cache, attacking, att_feats, hs * w, geom.cell_size, w,
                          geom.att_bucket, height=hs)))
            new_vcs.append({"pos": cache.anchor_pos, "active": cache.anchor_active,
                            "order": cache.order, "skey": cache.skey, "slot": cache.slot_of,
                            "cstat": torch.stack([cache.rebuilds, cache.reuses,
                                                  cache.age])[None, :]})
    else:
        for p in pre:
            pos, in_slab, _m, cell_local, vic_feats, attacking, att_feats = p
            tables.append(build_cell_table_pair(
                pos, in_slab, vic_feats, attacking, att_feats, geom.cell_size, w,
                geom.bucket, geom.att_bucket, cell=cell_local, height=hs))
        new_vcs = list(vcs)

    # halo exchange: one dense attacker plane per edge
    ags = [att_t.grid_view() for _v, att_t in tables]  # [hs, w, K_att, F+1]
    halo_top = coll.ppermute(mesh, [ag[hs - 1:hs] for ag in ags], coll.ring(n, 1))
    halo_bot = coll.ppermute(mesh, [ag[0:1] for ag in ags], coll.ring(n, -1))
    out = []
    for i, me in enumerate(mesh.local):
        pos, hp, atk, camp, gid, died, active = cols[i]
        vic_t, att_t = tables[i]
        top = halo_top[i] if me > 0 else torch.zeros_like(halo_top[i])
        bot = halo_bot[i] if me < n - 1 else torch.zeros_like(halo_bot[i])
        ag_h = torch.cat([top, ags[i], bot], dim=0)  # [hs+2, ...]
        # the fold: the single-device body over the halo-aware walk
        fold, acc = combat_fold_closure(vic_t.grid_view(), geom.radius)
        agp = F.pad(ag_h, (0, 0, 0, 0, 1, 1))
        for dy in (0, 1, 2):  # (dy, dx) ascending == ops.stencil.STENCIL order
            for dx in (0, 1, 2):
                acc = fold(acc, agp[dy:dy + hs, dx:dx + w])
        inc = acc[0]
        pulled = pull(vic_t, inc, fill=0)
        in_slab = pre[i][1]
        incoming = torch.where(in_slab & (hp > 0), pulled, 0)
        hp2, died2 = _life_phases(geom, hp, died, incoming, tick)
        # misplaced rows (awaiting a migration retry), victim and attacker
        # cell-bucket drops
        stats = torch.stack([pre[i][2], vic_t.dropped, att_t.dropped])[None, :]
        out.append((hp2, died2, new_vcs[i], stats))
    return out


VC_AUX = "spatial.vc"
COMBAT_STATS_AUX = "spatial.stats"


class _SpatialModule(Module):
    """Walk + combat phases of the preset (migration is the generic
    RowMigrationModule between them)."""

    name = "spatial"

    def __init__(self, world: "SpatialWorld"):
        super().__init__()
        self.world = world
        self.add_phase("walk", self._walk_phase, order=10)
        self.add_phase("combat", self._combat_phase, order=30, mesh_fn=self._combat_mesh)

    def _walk_phase(self, state, ctx):
        g = self.world.geom
        cs = state.classes["spatial"]
        new = _walk(cs.vec[:, _POS, :2], cs.i32[:, _GID], ctx.tick, g)
        vec = cs.vec.clone()
        vec[:, _POS, 0] = new[:, 0]
        vec[:, _POS, 1] = new[:, 1]
        return with_class(state, "spatial", cs.replace(vec=vec))

    @staticmethod
    def _cols(cs):
        return (cs.vec[:, _POS, :2], cs.i32[:, _HP], cs.i32[:, _ATK], cs.i32[:, _CAMP],
                cs.i32[:, _GID], cs.i32[:, _DIED], cs.alive)

    def _apply(self, state, ctx, hp, died, vc, stats):
        cs = state.classes["spatial"]
        i32 = cs.i32.clone()
        i32[:, _HP] = hp
        i32[:, _DIED] = died
        state = with_class(state, "spatial", cs.replace(i32=i32))
        ctx.count("misplaced", stats[:, 0])
        ctx.count("grid_drops", stats[:, 1:])
        return state.replace(aux={**state.aux, VC_AUX: vc, COMBAT_STATS_AUX: stats})

    def _combat_mesh(self, states, ctxs):
        w = self.world
        mesh = ctxs[0].shard.mesh
        res = _combat_body(w.geom, mesh, [self._cols(st.classes["spatial"]) for st in states],
                           [st.aux[VC_AUX] for st in states], ctxs[0].tick)
        return [self._apply(st, c, *r) for st, c, r in zip(states, ctxs, res)]

    def _combat_phase(self, state, ctx):
        """The one-device tick: the rows cut over the world's mesh, the
        body run, the blocks joined (the JAX package's ``shard_map`` of an
        unsharded state)."""
        w = self.world
        mesh = w.mesh
        cs = state.classes["spatial"]
        d = mesh.size
        home = cs.alive.device

        def cut(x, idx):
            b = x.shape[0] // d
            return x[idx * b:(idx + 1) * b].to(mesh.devices[idx])

        vc = state.aux[VC_AUX]
        cols = [tuple(cut(x, idx) for x in self._cols(cs)) for idx in mesh.local]
        vcs = [{k: cut(v, idx) for k, v in vc.items()} for idx in mesh.local]
        res = _combat_body(w.geom, mesh, cols, vcs, ctx.tick)
        hp = torch.cat([r[0].to(home) for r in res])
        died = torch.cat([r[1].to(home) for r in res])
        vc2 = {k: torch.cat([r[2][k].to(home) for r in res]) for k in vc}
        stats = torch.cat([r[3].to(home) for r in res])
        return self._apply(state, ctx, hp, died, vc2, stats)


class SpatialWorld:
    """Thin spatial preset over the Kernel/ShardedKernel engine.

    Usage::

        world = SpatialWorld(geom, mesh)      # mesh default: make_mesh(n_shards)
        world.place(pos, hp, atk, camp)       # numpy rows, any order
        world.step()                          # one sharded tick
        world.gather()                        # {gid: (x, y, hp)} on the host
    """

    def __init__(self, geom: SpatialGeom, mesh: Optional[Mesh] = None,
                 bank_size: Optional[int] = None):
        if geom.width % geom.n_shards:
            raise ValueError("width must divide into n_shards slabs")
        if geom.skin > 0.0 and geom.cell_size < geom.radius + geom.skin:
            raise ValueError(
                f"Verlet skin {geom.skin} needs cell_size >= radius + skin "
                f"({geom.radius + geom.skin}), got {geom.cell_size}")
        self.geom = geom
        self.mesh = mesh if mesh is not None else make_mesh(geom.n_shards)
        if self.mesh.size != geom.n_shards:
            raise ValueError(f"mesh of {self.mesh.size} shards for {geom.n_shards} slabs")
        self.device = self.mesh.devices[self.mesh.local[0]]
        self.bank_size = bank_size
        self.stats_last = np.zeros((geom.n_shards, 6), np.int32)
        self.overflow_budget = 1e-4  # alert threshold, as CombatModule
        self.overflow_alerts = 0
        # crowding response (CombatModule._on_overflow): on a budget breach
        # of cell-bucket drops, double both buckets (bounded)
        self.auto_resize = True
        self.max_bucket_boost = 8
        self._bucket_boost = 1
        self._kernel: Optional[Kernel] = None
        self._sharded: Optional[ShardedKernel] = None
        self._mig: Optional[RowMigrationModule] = None
        self._tick0 = 0
        from ..telemetry.costbook import CostBook

        # one cost ledger across rebuilds
        self.costbook = CostBook()

    # -- engine assembly ---------------------------------------------------------
    def _build_kernel(self, cap: int) -> None:
        g = self.geom
        reg = ClassRegistry()
        reg.define(ClassDef(name="spatial", properties=[
            prop("hp", "int"), prop("atk", "int"), prop("camp", "int"),
            prop("gid", "int"), prop("died", "int"), prop("pos", "vector2"),
        ]))
        k = Kernel(reg, store_config=StoreConfig(default_capacity=cap,
                                                 capacities={"spatial": cap}),
                   seed=0, device=self.device)
        k.costbook = self.costbook
        self._mig = RowMigrationModule(g.placement(), mesh=self.mesh, order=20)
        k.build([_SpatialModule(self), self._mig])
        self._mig.bind(k)
        n_sh = g.n_shards
        dev = self.device

        def vc_init():
            return {
                "pos": torch.zeros((cap, 2), dtype=torch.float32, device=dev),
                "active": torch.zeros((cap,), dtype=torch.bool, device=dev),
                "order": torch.zeros((cap,), dtype=torch.int32, device=dev),
                "skey": torch.zeros((cap,), dtype=torch.int32, device=dev),
                "slot": torch.zeros((cap,), dtype=torch.int32, device=dev),
                "cstat": torch.zeros((n_sh, 3), dtype=torch.int32, device=dev),
            }

        k.register_aux(VC_AUX, vc_init)
        k.register_aux(COMBAT_STATS_AUX,
                       lambda: torch.zeros((n_sh, 3), dtype=torch.int32, device=dev))
        self._kernel = k
        self._sharded = ShardedKernel(k, mesh=self.mesh)

    @property
    def kernel(self) -> Optional[Kernel]:
        """The engine underneath (None before place()/load())."""
        return self._kernel

    @property
    def tick_count(self) -> int:
        return self._kernel.tick_count if self._kernel else self._tick0

    @tick_count.setter
    def tick_count(self, v: int) -> None:
        v = int(v)
        if self._kernel is None:
            self._tick0 = v
            return
        self._kernel.tick_count = v
        k = self._kernel
        k.state = k.state.replace(tick=torch.full((), v, dtype=torch.int32, device=self.device))

    # -- state view --------------------------------------------------------------
    @property
    def state(self) -> Optional[SpatialState]:
        if self._kernel is None:
            return None
        k = self._kernel
        if not all(key in k.state.aux for key in k._aux_init):
            k.sharded = None
            k._ensure_aux()
            k.sharded = self._sharded
        cs = k.state.classes["spatial"]
        vc = k.state.aux[VC_AUX]
        return SpatialState(
            pos=cs.vec[:, _POS, :2], hp=cs.i32[:, _HP], atk=cs.i32[:, _ATK],
            camp=cs.i32[:, _CAMP], gid=cs.i32[:, _GID], died=cs.i32[:, _DIED],
            active=cs.alive, vc_pos=vc["pos"], vc_active=vc["active"],
            vc_order=vc["order"], vc_skey=vc["skey"], vc_slot=vc["slot"],
            cstat=vc["cstat"])

    @state.setter
    def state(self, st: Optional[SpatialState]) -> None:
        if st is None:
            return
        k = self._kernel
        if k is None:
            raise RuntimeError("place() or load() before assigning state")
        dev = self.device

        def t(x):
            return torch.as_tensor(x).to(dev)

        base = k.state
        cs = base.classes["spatial"]
        i32 = torch.stack([t(st.hp), t(st.atk), t(st.camp), t(st.gid), t(st.died)],
                          dim=1).to(torch.int32)
        vec = cs.vec.clone()
        pos = t(st.pos)
        vec[:, _POS, 0] = pos[:, 0]
        vec[:, _POS, 1] = pos[:, 1]
        cs = cs.replace(i32=i32, vec=vec, alive=t(st.active).to(torch.bool))
        new_state = with_class(base, "spatial", cs)
        k.state = new_state.replace(aux={
            **new_state.aux,
            VC_AUX: {"pos": t(st.vc_pos), "active": t(st.vc_active).to(torch.bool),
                     "order": t(st.vc_order), "skey": t(st.vc_skey),
                     "slot": t(st.vc_slot), "cstat": t(st.cstat)},
        })
        self._sharded.place()

    # -- placement ---------------------------------------------------------------
    def place(self, pos: np.ndarray, hp: np.ndarray, atk: np.ndarray,
              camp: np.ndarray) -> None:
        """Distribute entities into per-shard bank rows by their slab (one
        stable argsort by owning shard).  Rows seed the ClassState banks
        directly: they never need host identity, so the host alloc mask
        stays empty and migration-vacated slots never reconcile as
        deaths."""
        g = self.geom
        n = pos.shape[0]
        cy = np.clip((pos[:, 1] / g.cell_size).astype(np.int32), 0, g.width - 1)
        owner = cy // g.slab_h
        counts = np.bincount(owner, minlength=g.n_shards)
        bank = self.bank_size or int(1 << int(np.ceil(np.log2(max(counts.max() * 2, 64)))))
        over = np.flatnonzero(counts > bank)
        if over.size:
            raise ValueError(f"bank {int(over[0])} overflow at placement")
        cap = bank * g.n_shards
        self.bank_size = bank
        self._build_kernel(cap)
        i32 = np.zeros((cap, 5), np.int32)
        i32[:, _GID] = -1
        i32[:, _DIED] = -1
        vec = np.zeros((cap, 1, 3), np.float32)
        alive = np.zeros((cap,), bool)
        if n:
            order = np.argsort(owner, kind="stable")
            so = owner[order]
            starts = np.zeros(g.n_shards, np.int64)
            starts[1:] = np.cumsum(counts)[:-1]
            r = so.astype(np.int64) * bank + (np.arange(n) - starts[so])
            vec[r, 0, 0] = pos[order, 0]
            vec[r, 0, 1] = pos[order, 1]
            i32[r, _HP] = hp[order]
            i32[r, _ATK] = atk[order]
            i32[r, _CAMP] = camp[order]
            i32[r, _GID] = order
            alive[r] = True
        k = self._kernel
        dev = self.device
        cs = k.state.classes["spatial"].replace(
            i32=torch.from_numpy(i32).to(dev), vec=torch.from_numpy(vec).to(dev),
            alive=torch.from_numpy(alive).to(dev))
        k.state = with_class(k.state, "spatial", cs)
        self._sharded.place()

    # -- the step ----------------------------------------------------------------
    def step(self, n: int = 1) -> None:
        sk = self._sharded
        for _ in range(n):
            sk.run_device(1, fused=False)
        mig = sk.rows_of(lambda st: st.aux[self._mig.aux_key]).cpu().numpy()
        cmb = sk.rows_of(lambda st: st.aux[COMBAT_STATS_AUX]).cpu().numpy()
        self.stats_last = np.concatenate([mig, cmb], axis=1)
        # runtime alerting, CombatModule's overflow-budget contract:
        # - mig_dropped rows left their bank and found no slot: lost,
        #   always alert (senders clamp to the advertised free slots, so
        #   this should never fire)
        # - rows that missed migration are a subset of `misplaced`, so
        #   `missed` counts misplaced + bucket drops, each row once
        lost_forever = int(self.stats_last[:, 2].sum())
        missed = int(self.stats_last[:, 3].sum()) + int(self.stats_last[:, 4:].sum())
        if lost_forever or missed:
            pop = max(1, int(sk.rows_of(lambda st: st.classes["spatial"].alive).sum()))
            if lost_forever or missed / pop > self.overflow_budget:
                self.overflow_alerts += 1
                logging.getLogger("nf.spatial").warning(
                    "spatial overflow: %d rows lost (bank full), %d missed "
                    "combat/migration this tick (%.4f%% of %d, budget %.4f%%) - stats %s",
                    lost_forever, missed, 100 * missed / pop, pop,
                    100 * self.overflow_budget, self.stats_last.sum(axis=0).tolist())
            # cell-bucket drops (columns 4:6) respond to a bucket resize;
            # migration misses do not
            drops = int(self.stats_last[:, 4:].sum())
            if (self.auto_resize and drops / pop > self.overflow_budget
                    and self._bucket_boost < self.max_bucket_boost):
                self._resize_buckets(drops, pop)

    def _resize_buckets(self, drops: int, pop: int) -> None:
        """Double both cell buckets: ``Kernel.invalidate`` drops the aux
        (the carried Verlet cache bakes the old bucket into its slots);
        the lifetime counters in cstat survive by being written back."""
        self._bucket_boost *= 2
        g = self.geom
        self.geom = g._replace(bucket=g.bucket * 2, att_bucket=g.att_bucket * 2)
        k = self._kernel
        old_cstat = k.state.aux[VC_AUX]["cstat"]
        k.invalidate()
        k.sharded = None
        k._ensure_aux()
        vc = dict(k.state.aux[VC_AUX])
        vc["cstat"] = old_cstat
        k.state = k.state.replace(aux={**k.state.aux, VC_AUX: vc})
        self._sharded.place()
        logging.getLogger("nf.spatial").warning(
            "cell-bucket overflow: %d drops over %d rows breached budget %.4f%%; "
            "buckets doubled to %d/%d (boost x%d of max x%d)",
            drops, pop, 100 * self.overflow_budget, self.geom.bucket,
            self.geom.att_bucket, self._bucket_boost, self.max_bucket_boost)

    # -- Verlet cache visibility -------------------------------------------------
    @property
    def rebuilds_total(self) -> int:
        """Max over shards (the pmax vote makes every shard rebuild together)."""
        if self._kernel is None:
            return 0
        return int(self.state.cstat[:, 0].max())

    @property
    def reuses_total(self) -> int:
        if self._kernel is None:
            return 0
        return int(self.state.cstat[:, 1].max())

    # -- host observation --------------------------------------------------------
    def _host_state(self) -> SpatialState:
        return SpatialState(*[x.cpu().numpy() for x in self.state])

    def gather(self):
        """{gid: (x, y, hp)} for live rows: host-side verification."""
        st = self._host_state()
        out = {}
        for r in np.flatnonzero(st.active):
            out[int(st.gid[r])] = (float(st.pos[r, 0]), float(st.pos[r, 1]), int(st.hp[r]))
        return out

    # -- checkpoint / resume -----------------------------------------------------
    def save(self, path: str) -> None:
        """Snapshot banks + tick counter in the JAX package's npz layout
        (``layout`` marks full-row snapshots); the walk and duty are pure
        functions of (gid, tick), so a resumed world cannot drift."""
        st = self._host_state()
        np.savez_compressed(path, tick=self.tick_count, bank=self.bank_size,
                            binning=binning_mode(), layout="classrow", **st._asdict())

    def load(self, path: str) -> None:
        with np.load(path) as z:
            tick = int(z["tick"])
            self.bank_size = int(z["bank"])
            cap = z["pos"].shape[0]
            # snapshots without a cache carry zeros: the all-False anchor
            # forces a first-tick rebuild, trajectories unchanged
            fresh = {
                "vc_pos": np.zeros((cap, 2), np.float32),
                "vc_active": np.zeros((cap,), bool),
                "vc_order": np.zeros((cap,), np.int32),
                "vc_skey": np.zeros((cap,), np.int32),
                "vc_slot": np.zeros((cap,), np.int32),
                "cstat": np.zeros((self.geom.n_shards, 3), np.int32),
            }
            # vc_order/vc_skey are NF_BINNING-engine-specific, and a slab
            # snapshot (no `layout`) predates the full-row layout: either
            # mismatch drops the cache and only the row banks load
            stored = str(z["binning"]) if "binning" in z.files else "sort"
            layout = str(z["layout"]) if "layout" in z.files else "slab"
            drop_cache = stored != binning_mode() or layout != "classrow"

            def pick(f):
                if f in z.files and not (drop_cache and f.startswith("vc_")):
                    return np.asarray(z[f])
                return fresh[f]

            self._build_kernel(cap)
            self.state = SpatialState(*[torch.from_numpy(np.ascontiguousarray(pick(f)))
                                        for f in SpatialState._fields])
            self.tick_count = tick
            self._sharded.place()


def reference_step(geom: SpatialGeom, pos, hp, atk, camp, gid, died, active, tick):
    """Single-device twin of the spatial tick: the same movement and
    attacker duty, the square-grid plain fold, the same life phases; the
    parity oracle."""
    pos = _walk(pos, gid, tick, geom)
    f32 = torch.float32
    camp_f = camp.to(f32)
    zeros_f = torch.zeros_like(camp_f)
    vic_feats = torch.stack([pos[:, 0], pos[:, 1], camp_f, zeros_f, zeros_f], -1)
    attacking = active & (hp > 0) & (torch.remainder(gid + tick, geom.attack_period) == 0)
    eff_atk = torch.where(attacking, atk, 0).to(f32)
    att_feats = torch.stack([pos[:, 0], pos[:, 1], eff_atk, camp_f, zeros_f, zeros_f,
                             gid.to(f32)], -1)
    vic_t, att_t = build_cell_table_pair(
        pos, active, vic_feats, attacking, att_feats,
        geom.cell_size, geom.width, geom.bucket, geom.att_bucket)
    inc, _bestr = combat_fold_plain(vic_t, att_t, geom.radius)
    pulled = pull(vic_t, inc, fill=0)
    incoming = torch.where(active & (hp > 0), pulled, 0)
    hp, died = _life_phases(geom, hp, died, incoming, tick)
    return pos, hp, died
