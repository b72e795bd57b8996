"""Full-row ClassState migration (noahgameframe_tpu_torch.parallel.
rowmigrate) against the JAX package's, case by case after
tests/test_unified_mesh.py.

A full-store workload (property banks, a record page, the timer banks)
drifts across every slab boundary on an 8-shard virtual CPU mesh; its
per-tick ``canonical_digest`` equals a one-shard control's that never
migrates a row, and the JAX package's 8-device run's, with the same
migration counters.  The six-column combat preset is held to the port's
single-device oracle (its walk goes through ``cos``/``sin``, see
tests/test_torch_spatial.py), and GameWorld's placement wiring and
snapshots across mesh widths follow."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noahgameframe_tpu.core.schema import ClassDef as JClassDef
from noahgameframe_tpu.core.schema import ClassRegistry as JClassRegistry
from noahgameframe_tpu.core.schema import prop as jprop
from noahgameframe_tpu.core.schema import record as jrecord
from noahgameframe_tpu.core.store import StoreConfig as JStoreConfig
from noahgameframe_tpu.core.store import with_class as jwith_class
from noahgameframe_tpu.kernel.kernel import Kernel as JKernel
from noahgameframe_tpu.kernel.module import Module as JModule
from noahgameframe_tpu.parallel.mesh import make_mesh as jax_mesh
from noahgameframe_tpu.parallel.rowmigrate import RowMigrationModule as JMigration
from noahgameframe_tpu.parallel.rowmigrate import SpatialPlacement as JPlacement
from noahgameframe_tpu.parallel.rowmigrate import canonical_digest as jax_canonical
from noahgameframe_tpu.parallel.shard import ShardedKernel as JSharded
from noahgameframe_tpu_torch.core.schema import ClassDef, ClassRegistry, prop, record
from noahgameframe_tpu_torch.core.store import StoreConfig, with_class
from noahgameframe_tpu_torch.kernel.kernel import Kernel
from noahgameframe_tpu_torch.kernel.module import Module
from noahgameframe_tpu_torch.parallel.mesh import make_mesh
from noahgameframe_tpu_torch.parallel.rowmigrate import (
    RowMigrationModule,
    SpatialPlacement,
    canonical_digest,
)
from noahgameframe_tpu_torch.parallel.shard import ShardedKernel
from noahgameframe_tpu_torch.parallel.spatial import SpatialGeom, SpatialWorld, reference_step
from test_torch_parity import one_intra_op_thread  # noqa: F401

EXTENT = 64.0
CAP = 64
N_LIVE = 32
TICKS = 12


def _mesh(n):
    return make_mesh(n, device="cpu", virtual=True)


class _Drift(Module):
    """Deterministic full-store churn: every live row drifts +3 in y each
    tick (wrapping across every slab boundary) and stamps id-derived
    values into its record page and timer banks."""

    name = "drift"

    def __init__(self):
        super().__init__()
        self.add_phase("move", self._move, order=10)
        self.add_phase("mark", self._mark, order=15)

    def _move(self, state, ctx):
        cs = state.classes["Npc"]
        vec = cs.vec.clone()
        vec[:, 0, 1] = torch.remainder(cs.vec[:, 0, 1] + 3.0, EXTENT)
        return with_class(state, "Npc", cs.replace(vec=vec))

    def _mark(self, state, ctx):
        cs = state.classes["Npc"]
        live = cs.alive
        add = torch.where(live, cs.i32[:, 0], 0)
        bag = cs.records["Bag"]
        bag = bag.replace(
            i32=bag.i32 + add[:, None, None],
            f32=bag.f32 + add[:, None, None].to(torch.float32) * 0.5,
            used=bag.used | live[:, None],
        )
        tm = cs.timers
        tm = tm.replace(next_fire=tm.next_fire + torch.where(live, 1, 0)[:, None].to(torch.int32),
                        remain=tm.remain + add[:, None])
        return with_class(state, "Npc",
                          cs.replace(records={**cs.records, "Bag": bag}, timers=tm))


class _JaxDrift(JModule):
    """tests/test_unified_mesh.py's drift module."""

    name = "drift"

    def __init__(self):
        super().__init__()
        self.add_phase("move", self._move, order=10)
        self.add_phase("mark", self._mark, order=15)

    def _move(self, state, ctx):
        cs = state.classes["Npc"]
        y = jnp.mod(cs.vec[:, 0, 1] + 3.0, EXTENT)
        return jwith_class(state, "Npc", cs.replace(vec=cs.vec.at[:, 0, 1].set(y)))

    def _mark(self, state, ctx):
        cs = state.classes["Npc"]
        ident = cs.i32[:, 0]
        live = cs.alive
        add = jnp.where(live, ident, 0)
        bag = cs.records["Bag"]
        bag = bag.replace(
            i32=bag.i32 + add[:, None, None],
            f32=bag.f32 + add[:, None, None].astype(jnp.float32) * 0.5,
            used=bag.used | live[:, None],
        )
        tm = cs.timers
        tm = tm.replace(next_fire=tm.next_fire + jnp.where(live, 1, 0)[:, None],
                        remain=tm.remain + add[:, None])
        return jwith_class(state, "Npc",
                           cs.replace(records={**cs.records, "Bag": bag}, timers=tm))


def _banks():
    rng = np.random.default_rng(7)
    i32 = np.zeros((CAP, 2), np.int32)
    i32[:, 0] = np.arange(CAP)
    i32[:N_LIVE, 1] = 100
    vec = np.zeros((CAP, 1, 3), np.float32)
    vec[:N_LIVE, 0, 0] = rng.uniform(1.0, EXTENT - 1, N_LIVE)
    vec[:N_LIVE, 0, 1] = rng.uniform(1.0, EXTENT - 1, N_LIVE)
    alive = np.zeros(CAP, bool)
    alive[:N_LIVE] = True
    return i32, vec, alive


def _placement(cls, n_shards):
    return cls(class_name="Npc", pos_prop="Position", extent=EXTENT, cell_size=8.0,
               width=8, n_shards=n_shards, mig_budget=4)


def _mk_world(n_shards: int):
    reg = ClassRegistry()
    reg.define(ClassDef(name="Npc", properties=[
        prop("Id", "int"), prop("HP", "int"), prop("Position", "vector2"),
    ], records=[record("Bag", 3, [("item", "int"), ("weight", "float")])]))
    k = Kernel(reg, store_config=StoreConfig(default_capacity=CAP, capacities={"Npc": CAP},
                                             timer_slots={"Npc": 2}), seed=0, device="cpu")
    mesh = _mesh(n_shards)
    mig = RowMigrationModule(_placement(SpatialPlacement, n_shards), mesh=mesh, order=20)
    k.build([_Drift(), mig])
    mig.bind(k)
    i32, vec, alive = _banks()
    cs = k.state.classes["Npc"].replace(i32=torch.from_numpy(i32), vec=torch.from_numpy(vec),
                                        alive=torch.from_numpy(alive))
    k.state = with_class(k.state, "Npc", cs)
    sk = ShardedKernel(k, mesh=mesh)
    sk.place()
    return k, sk, mig


def _mk_jax_world(n_shards: int):
    reg = JClassRegistry()
    reg.define(JClassDef(name="Npc", properties=[
        jprop("Id", "int"), jprop("HP", "int"), jprop("Position", "vector2"),
    ], records=[jrecord("Bag", 3, [("item", "int"), ("weight", "float")])]))
    k = JKernel(reg, store_config=JStoreConfig(default_capacity=CAP, capacities={"Npc": CAP},
                                               timer_slots={"Npc": 2}), seed=0)
    mesh = jax_mesh(n_shards)
    mig = JMigration(_placement(JPlacement, n_shards), mesh=mesh, order=20)
    k.build([_JaxDrift(), mig])
    mig.bind(k)
    i32, vec, alive = _banks()
    cs = k.state.classes["Npc"].replace(i32=jnp.asarray(i32), vec=jnp.asarray(vec),
                                        alive=jnp.asarray(alive))
    k.state = jwith_class(k.state, "Npc", cs)
    sk = JSharded(k, mesh=mesh)
    sk.place()
    return k, sk, mig


def test_full_store_migration_digest_parity():
    """Records + timers + banks cross shards bit-identically: per tick,
    the 8-shard run's canonical digest equals the one-shard control's and
    the JAX package's 8-device run's, with the JAX run's migration
    counters."""
    km, skm, migm = _mk_world(8)
    kc, skc, _ = _mk_world(1)
    kj, skj, migj = _mk_jax_world(8)
    moved_total = 0
    for t in range(TICKS):
        skm.run_device(1, fused=False)
        skc.run_device(1, fused=False)
        skj.run_device(1, fused=False)
        stats = km.state.aux[migm.aux_key].numpy()
        np.testing.assert_array_equal(stats, np.asarray(kj.state.aux[migj.aux_key]))
        moved_total += int(stats[:, 0].sum())
        assert int(stats[:, 2].sum()) == 0, "protocol dropped a row"
        dm = canonical_digest(km.state, ["Npc"], {"Npc": 0})
        assert dm == canonical_digest(kc.state, ["Npc"], {"Npc": 0}), t
        assert dm == jax_canonical(kj.state, ["Npc"], {"Npc": 0}), t
    assert moved_total > 0, "workload never migrated - gate proves nothing"
    assert int(km.state.classes["Npc"].alive.sum()) == N_LIVE
    # same rows in the same slots as the JAX mesh, not only the same content
    np.testing.assert_array_equal(km.state.classes["Npc"].i32.numpy(),
                                  np.asarray(kj.state.classes["Npc"].i32))


def test_migration_preserves_record_content_per_id():
    """After churn, each live row's record page and timers on the mesh
    match the control's row with the same Id."""
    km, skm, _ = _mk_world(8)
    kc, skc, _ = _mk_world(1)
    for _ in range(TICKS):
        skm.run_device(1, fused=False)
        skc.run_device(1, fused=False)

    def by_id(k):
        cs = k.state.classes["Npc"]
        out = {}
        for r in np.flatnonzero(cs.alive.numpy()):
            out[int(cs.i32[r, 0])] = (
                cs.records["Bag"].i32[r], cs.records["Bag"].f32[r],
                cs.timers.next_fire[r], cs.timers.remain[r], cs.vec[r])
        return out

    mesh_rows, ctrl_rows = by_id(km), by_id(kc)
    assert set(mesh_rows) == set(ctrl_rows)
    for ident, banks in ctrl_rows.items():
        for a, b in zip(mesh_rows[ident], banks):
            assert torch.equal(a, b), ident


def _combat_parity(n_shards: int, ticks: int):
    geom = SpatialGeom(extent=128.0, cell_size=4.0, width=32, n_shards=n_shards,
                       bucket=24, att_bucket=24, radius=4.0, mig_budget=256,
                       speed=1.0, attack_period=3)
    rng = np.random.default_rng(11)
    n = 300
    pos = rng.uniform(1.0, 127.0, (n, 2)).astype(np.float32)
    hp = np.full(n, 3000, np.int32)
    atk = rng.integers(5, 20, n).astype(np.int32)
    camp = (np.arange(n) % 2).astype(np.int32)
    world = SpatialWorld(geom, mesh=_mesh(n_shards))
    world.place(pos, hp, atk, camp)
    world.step(ticks)
    assert world.stats_last[:, 2].sum() == 0
    gid = torch.arange(n, dtype=torch.int32)
    active = torch.ones(n, dtype=torch.bool)
    p, h = torch.from_numpy(pos), torch.from_numpy(hp)
    d = torch.full((n,), -1, dtype=torch.int32)
    for t in range(ticks):
        p, h, d = reference_step(geom, p, h, torch.from_numpy(atk), torch.from_numpy(camp),
                                 gid, d, active, torch.tensor(t, dtype=torch.int32))
    got = world.gather()
    assert len(got) == n
    for g, (x, y, hp_) in got.items():
        assert hp_ == int(h[g]), f"gid {g} hp"
        np.testing.assert_array_equal(np.float32([x, y]), p[g].numpy())


def test_unified_combat_short_parity_mesh():
    """The 4-shard preset reproduces the oracle bit-exactly."""
    _combat_parity(4, TICKS)


@pytest.mark.slow
def test_unified_combat_120_tick_gate():
    _combat_parity(1, 120)
    _combat_parity(8, 120)


def test_gameworld_selects_placement_by_config():
    """WorldConfig.placement attaches the full-row migration phase to the
    standard stack; the stats ride kernel aux."""
    from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig

    pl = SpatialPlacement(class_name="NPC", pos_prop="Position", extent=64.0,
                          cell_size=8.0, width=8, n_shards=2, mig_budget=8)
    w = GameWorld(WorldConfig(npc_capacity=64, extent=64.0, combat=False, movement=False,
                              regen=False, middleware=False, placement=pl, mesh=_mesh(2)),
                  device="cpu")
    w.start()
    w.scene.create_scene(1, width=64.0)
    w.seed_npcs(8)
    w.tick()
    w.tick()
    assert w.migration is not None
    assert w.migration.aux_key in w.kernel.state.aux
    assert tuple(w.kernel.state.aux[w.migration.aux_key].shape) == (2, 3)
    w0 = GameWorld(WorldConfig(npc_capacity=64, combat=False, movement=False, regen=False,
                               middleware=False), device="cpu")
    assert w0.migration is None
    # with no mesh given, the placement asks for one card a shard
    with pytest.raises(RuntimeError, match="need 2 devices"):
        GameWorld(WorldConfig(npc_capacity=64, placement=pl, middleware=False), device="cpu")


def test_slab_snapshot_loads_into_unified_engine(tmp_path):
    """A pre-unification slab snapshot (binning recorded, no `layout`)
    loads with its Verlet cache dropped, banks intact, trajectory
    unchanged."""
    geom = SpatialGeom(extent=128.0, cell_size=8.0, width=16, n_shards=2,
                       bucket=48, att_bucket=48, radius=4.0, mig_budget=64,
                       speed=0.1, attack_period=3, skin=4.0)
    rng = np.random.default_rng(5)
    n = 120
    pos = rng.uniform(1.0, 127.0, (n, 2)).astype(np.float32)
    hp = np.full(n, 900, np.int32)
    atk = rng.integers(5, 15, n).astype(np.int32)
    camp = (np.arange(n) % 2).astype(np.int32)
    w1 = SpatialWorld(geom, mesh=_mesh(2))
    w1.place(pos, hp, atk, camp)
    w1.step(6)
    assert bool(w1.state.vc_active.any()), "skin run must carry cache"
    p_new = tmp_path / "unified.npz"
    w1.save(p_new)
    with np.load(p_new) as z:
        legacy = {f: z[f] for f in z.files if f != "layout"}
    p_old = tmp_path / "slab.npz"
    np.savez_compressed(p_old, **legacy)
    w2 = SpatialWorld(geom, mesh=_mesh(2))
    w2.load(p_old)
    assert w2.tick_count == 6
    assert not bool(w2.state.vc_active.any())
    for f in ("pos", "hp", "gid", "active"):
        assert torch.equal(getattr(w1.state, f), getattr(w2.state, f)), f
    w1.step(6)
    w2.step(6)
    assert w1.gather() == w2.gather()


def test_snapshot_loads_across_mesh_widths(tmp_path):
    """A snapshot taken on a 4-shard mesh loads into a 2-shard world (and
    an 8-shard one); GameWorld.load re-places the restored banks on the
    CURRENT mesh, and the canonical digest stays pinned as both tick."""
    from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig

    def mk(n_shards):
        pl = SpatialPlacement(class_name="NPC", pos_prop="Position", extent=64.0,
                              cell_size=8.0, width=8, n_shards=n_shards, mig_budget=8)
        w = GameWorld(WorldConfig(npc_capacity=64, extent=64.0, combat=False,
                                  movement=False, regen=False, middleware=False,
                                  placement=pl, mesh=_mesh(n_shards)), device="cpu")
        w.start()
        w.scene.create_scene(1, width=64.0)
        w.seed_npcs(24, rng=np.random.default_rng(3))
        # unique identity in an inert saved column (Gold)
        col = w.kernel.store.spec("NPC").slot("Gold").col
        cs = w.kernel.state.classes["NPC"]
        i32 = cs.i32.clone()
        i32[:, col] = torch.arange(64, dtype=torch.int32)
        w.kernel.state = with_class(w.kernel.state, "NPC", cs.replace(i32=i32))
        w.shard(n_shards)
        return w, col

    def dig(w, col):
        return canonical_digest(w.kernel.state, ["NPC"], {"NPC": col})

    w4, col = mk(4)
    for _ in range(5):
        w4.tick()
    snap = tmp_path / "wide.ckpt"
    w4.save(snap)
    snap_digest = dig(w4, col)
    w2, _ = mk(2)
    w2.load(snap)
    assert w2.kernel.tick_count == w4.kernel.tick_count
    assert dig(w2, col) == dig(w4, col), "restore must be content-exact"
    for _ in range(5):
        w4.tick()
        w2.tick()
        assert dig(w2, col) == dig(w4, col)
    w8, _ = mk(8)
    w8.load(snap)
    assert dig(w8, col) == snap_digest
    w8.tick()
    assert int(w8.kernel.state.classes["NPC"].alive.sum()) == 24
