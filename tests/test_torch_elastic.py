"""The port's elastic mesh (noahgameframe_tpu_torch.parallel.elastic)
against the JAX package's, case by case after tests/test_elastic.py.

A drifting full-store world grows 2 -> 4 shards and drains back to 2
(through a 3-shard mesh) on a virtual CPU mesh.  Every phase's
``canonical_digest`` equals a one-shard control's (the ``DigestControl``
gate) and the JAX package's run of the same sequence on its CPU mesh,
with zero dropped rows, the population conserved, and every re-signature
of the sharded step explained by a CostBook generation bump.  The
StableUnderReshard drill cases of the JAX tests are in
tests/test_torch_drill.py."""

import dataclasses

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
from noahgameframe_tpu.parallel.elastic import ElasticMesh as JElastic
from noahgameframe_tpu.parallel.mesh import make_mesh as jax_mesh
from noahgameframe_tpu.parallel.rowmigrate import RowMigrationModule as JMigration
from noahgameframe_tpu.parallel.rowmigrate import SpatialPlacement as JPlacement
from noahgameframe_tpu.parallel.rowmigrate import canonical_digest as jax_canonical
from noahgameframe_tpu.parallel.shard import ShardedKernel as JSharded
from noahgameframe_tpu_torch.core.schema import ClassDef, ClassRegistry, prop, record
from noahgameframe_tpu_torch.core.store import StoreConfig, with_class
from noahgameframe_tpu_torch.kernel.kernel import Kernel
from noahgameframe_tpu_torch.kernel.module import Module
from noahgameframe_tpu_torch.parallel.elastic import (
    Autoscaler,
    AutoscalePolicy,
    DigestControl,
    ElasticMesh,
)
from noahgameframe_tpu_torch.parallel.mesh import make_mesh
from noahgameframe_tpu_torch.parallel.rowmigrate import (
    RowMigrationModule,
    SpatialPlacement,
    canonical_digest,
)
from noahgameframe_tpu_torch.parallel.shard import ShardedKernel
from test_torch_parity import one_intra_op_thread  # noqa: F401

EXTENT = 64.0
CAP = 48     # divisible by 1..4, 6, 8: every width this file visits
N_LIVE = 24


def _mesh(n):
    return make_mesh(n, device="cpu", virtual=True)


class _Drift(Module):
    name = "drift"

    def __init__(self):
        super().__init__()
        self.add_phase("move", self._move, order=10)

    def _move(self, state, ctx):
        cs = state.classes["Npc"]
        vec = cs.vec.clone()
        vec[:, 0, 1] = torch.remainder(cs.vec[:, 0, 1] + 3.0, EXTENT)
        return with_class(state, "Npc", cs.replace(vec=vec))


class _JaxDrift(JModule):
    name = "drift"

    def __init__(self):
        super().__init__()
        self.add_phase("move", self._move, order=10)

    def _move(self, state, ctx):
        cs = state.classes["Npc"]
        y = jnp.mod(cs.vec[:, 0, 1] + 3.0, EXTENT)
        return jwith_class(state, "Npc", cs.replace(vec=cs.vec.at[:, 0, 1].set(y)))


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


def _registry(cd, cr, pr, rc):
    reg = cr()
    reg.define(cd(name="Npc", properties=[pr("Id", "int"), pr("HP", "int"),
                                          pr("Position", "vector2")],
                  records=[rc("Bag", 3, [("item", "int"), ("weight", "float")])]))
    return reg


def _mk_world(n_shards: int):
    k = Kernel(_registry(ClassDef, ClassRegistry, prop, record),
               store_config=StoreConfig(default_capacity=CAP, capacities={"Npc": CAP},
                                        timer_slots={"Npc": 2}), seed=0, device="cpu")
    mesh = _mesh(n_shards)
    mig = RowMigrationModule(SpatialPlacement(
        class_name="Npc", pos_prop="Position", extent=EXTENT, cell_size=8.0, width=8,
        n_shards=n_shards, mig_budget=6), mesh=mesh, order=20)
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
    k = JKernel(_registry(JClassDef, JClassRegistry, jprop, jrecord),
                store_config=JStoreConfig(default_capacity=CAP, capacities={"Npc": CAP},
                                          timer_slots={"Npc": 2}), seed=0)
    mesh = jax_mesh(n_shards)
    mig = JMigration(JPlacement(
        class_name="Npc", pos_prop="Position", extent=EXTENT, cell_size=8.0, width=8,
        n_shards=n_shards, mig_budget=6), mesh=mesh, order=20)
    k.build([_JaxDrift(), mig])
    mig.bind(k)
    i32, vec, alive = _banks()
    cs = k.state.classes["Npc"].replace(i32=jnp.asarray(i32), vec=jnp.asarray(vec),
                                        alive=jnp.asarray(alive))
    k.state = jwith_class(k.state, "Npc", cs)
    sk = JSharded(k, mesh=mesh)
    sk.place()
    return k, sk, mig


def _digest(k):
    return canonical_digest(k.state, ["Npc"], {"Npc": 0})


def _elastic_run(k, sk, mig, elastic_cls, step, digest):
    """Warm at 2, grow to 4, drain shard 1 (-> 3), drain shard 2 (-> 2);
    the completed ops, the digest after each phase, and the cost book's
    mark after the warm-up."""
    el = elastic_cls(sk, migration=mig, ident_cols={"Npc": 0}, exodus_tick_bound=64)
    marks = []
    step(4)
    marks.append(("warm@2", int(k.tick_count), digest()))
    warm = k.costbook.mark()
    el.begin_grow(4)
    with pytest.raises(RuntimeError, match="already in flight"):
        el.begin_grow(8)
    for _ in range(40):
        el.poll()
        if el.inflight is None:
            break
        step(1)
    marks.append(("grow@4", int(k.tick_count), digest()))
    step(3)
    for d in (1, 2):
        el.begin_drain(d)
        for _ in range(200):
            el.poll()
            if el.inflight is None:
                break
            step(1)
        marks.append((f"drain{d}", int(k.tick_count), digest()))
    step(3)
    marks.append(("settled@2", int(k.tick_count), digest()))
    return el, marks, warm


def test_grow_drain_digest_parity_vs_static_control_and_jax():
    """2 -> 4 grow, 4 -> 3 -> 2 drains: every phase equals the one-shard
    control (DigestControl) and the JAX package's same run, zero drops,
    the population conserved, the re-signatures all explained."""
    k, sk, mig = _mk_world(2)
    kc, skc, _ = _mk_world(1)

    class _Control:
        kernel = kc

        @staticmethod
        def tick():
            skc.run_device(1, fused=False)

    control = DigestControl(_Control(), {"Npc": 0})
    el, marks, mark = _elastic_run(k, sk, mig, ElasticMesh,
                             lambda n: sk.run_device(n, fused=False), lambda: _digest(k))
    for tag, tick, dig in marks:
        assert dig == control.advance_to(tick), tag
    assert [op["kind"] for op in el.ops_done] == ["grow", "drain", "drain"]
    assert el.n_devices == 2
    st = el.status()
    assert st["dropped_rows"] == 0
    assert st["pop"] == st["pop_baseline"] == N_LIVE
    assert el.ops_done[1]["drained_in_budget"] and el.ops_done[1]["exodus_ticks"] <= 64
    assert k.costbook.unexplained_since(mark) == []

    kj, skj, migj = _mk_jax_world(2)
    elj, jmarks, _ = _elastic_run(
        kj, skj, migj, JElastic, lambda n: [skj.run_device(1, fused=False) for _ in range(n)],
        lambda: jax_canonical(kj.state, ["Npc"], {"Npc": 0}))
    assert marks == jmarks
    assert el.ops_done == elj.ops_done


def test_grow_without_migration_is_pure_replace():
    reg = ClassRegistry()
    reg.define(ClassDef(name="Npc", properties=[prop("Id", "int"), prop("HP", "int"),
                                               prop("Position", "vector2")]))
    k = Kernel(reg, store_config=StoreConfig(default_capacity=CAP, capacities={"Npc": CAP}),
               seed=0, device="cpu")
    k.build([_Drift()])
    cs = k.state.classes["Npc"]
    i32 = cs.i32.clone()
    i32[:, 0] = torch.arange(CAP, dtype=torch.int32)
    alive = cs.alive.clone()
    alive[:N_LIVE] = True
    k.state = with_class(k.state, "Npc", cs.replace(i32=i32, alive=alive))
    sk = ShardedKernel(k, mesh=_mesh(1))
    sk.place()
    el = ElasticMesh(sk, migration=None, ident_cols={"Npc": 0})
    sk.run_device(2, fused=False)
    before = _digest(k)
    el.begin_grow(2)
    moved = el.poll()
    assert el.inflight is None and el.n_devices == 2
    assert sk.mesh.virtual
    assert _digest(k) == before
    assert moved == {}
    sk.run_device(2, fused=False)


class _Pulse(Module):
    """Timer consumer running after the migrate phase (order 40 vs 20)."""

    name = "pulse"

    def __init__(self):
        super().__init__()
        self.add_phase("pulse", self._p, order=40)

    def _p(self, state, ctx):
        cs = state.classes["Npc"]
        hit = ctx.fired("Npc", "beat") & cs.alive
        i32 = cs.i32.clone()
        i32[:, 1] = torch.where(hit, cs.i32[:, 1] + 7, cs.i32[:, 1])
        return with_class(state, "Npc", cs.replace(i32=i32))


def test_fired_mask_migrates_with_row():
    """A timer fire landing on the tick its row crosses a shard boundary
    still reaches handlers after the migrate phase."""
    reg = ClassRegistry()
    reg.define(ClassDef(name="Npc", properties=[prop("Id", "int"), prop("HP", "int"),
                                               prop("Position", "vector2")]))
    k = Kernel(reg, store_config=StoreConfig(default_capacity=CAP, capacities={"Npc": CAP},
                                             timer_slots={"Npc": 1}), seed=0, device="cpu")
    k.schedule.register_timer("Npc", "beat")
    mesh = _mesh(2)
    mig = RowMigrationModule(SpatialPlacement(
        class_name="Npc", pos_prop="Position", extent=EXTENT, cell_size=8.0, width=8,
        n_shards=2, mig_budget=6), mesh=mesh, order=20)
    k.build([_Drift(), mig, _Pulse()])
    mig.bind(k)
    i32 = np.zeros((CAP, 2), np.int32)
    i32[:, 0] = np.arange(CAP)
    i32[:2, 1] = 100
    vec = np.zeros((CAP, 1, 3), np.float32)
    vec[0, 0, :2] = (10.0, 10.0)
    vec[1, 0, :2] = (5.0, 27.0)
    alive = np.zeros(CAP, bool)
    alive[:2] = True
    cs = k.state.classes["Npc"].replace(i32=torch.from_numpy(i32), vec=torch.from_numpy(vec),
                                        alive=torch.from_numpy(alive))
    k.state = with_class(k.state, "Npc", cs)
    k.state = k.schedule.set_timer_rows(k.state, "Npc", np.asarray([0, 1]), "beat",
                                        interval_s=10.0, start_delay_ticks=np.asarray([1, 1]))
    sk = ShardedKernel(k, mesh=mesh)
    sk.place()
    sk.run_device(2, fused=False)
    i32 = k.state.classes["Npc"].i32.numpy()
    alive = k.state.classes["Npc"].alive.numpy()
    where_id1 = int(np.flatnonzero(alive & (i32[:, 0] == 1))[0])
    assert where_id1 >= CAP // 2, "row 1 should have migrated to shard 1"
    assert i32[where_id1, 1] == 107, "migrant's fire was lost mid-flight"
    where_id0 = int(np.flatnonzero(alive & (i32[:, 0] == 0))[0])
    assert i32[where_id0, 1] == 107


def test_begin_guards():
    k, sk, mig = _mk_world(2)
    el = ElasticMesh(sk, migration=mig, ident_cols={"Npc": 0})
    with pytest.raises(ValueError, match="grow_mesh"):
        el.begin_grow(2)
    with pytest.raises(ValueError, match="out of range"):
        el.begin_drain(5)
    _k1, sk1, mig1 = _mk_world(1)
    el1 = ElasticMesh(sk1, migration=mig1)
    with pytest.raises(ValueError, match="last device"):
        el1.begin_drain(0)


def test_scan_classes_rejects_large_non_divisible_capacity():
    reg = ClassRegistry()
    reg.define(ClassDef(name="Big", properties=[prop("Id", "int")]))
    k = Kernel(reg, store_config=StoreConfig(default_capacity=144, capacities={"Big": 144}),
               seed=0, device="cpu")
    k.build([])
    with pytest.raises(ValueError, match="not divisible"):
        ShardedKernel(k, mesh=_mesh(5))


def test_moved_rows_are_identity_based_not_content_based():
    k, sk, mig = _mk_world(2)
    el = ElasticMesh(sk, migration=mig, ident_cols={"Npc": 0})
    snap = el._snapshot()
    cs = k.state.classes["Npc"]
    i32 = cs.i32.clone()
    i32[:, 1] += 7  # HP only
    k.state = with_class(k.state, "Npc", cs.replace(i32=i32))
    assert el._moved_since(snap)["Npc"].size == 0
    cs = k.state.classes["Npc"]
    i32 = cs.i32.clone()
    i32[3, 0] = 999  # row 3 re-homed
    alive = cs.alive.clone()
    alive[5] = False  # row 5 despawned
    k.state = with_class(k.state, "Npc", cs.replace(i32=i32, alive=alive))
    assert set(el._moved_since(snap)["Npc"].tolist()) == {3, 5}


def test_sessions_seeing_rows_resets_only_affected_sessions():
    from noahgameframe_tpu_torch.net.serving import SessionTable, sessions_seeing_rows
    from noahgameframe_tpu_torch.ops.serving import SENTINEL

    tbl = SessionTable(lo=4, device="cpu")
    tbl.ensure("watcher", conn_id=1, avatar_row=0)
    tbl.ensure("bystander", conn_id=2, avatar_row=1)
    seen = tbl.seen_for("Npc", 4)
    rows = seen.rows.clone()
    rows[tbl.slot_of["watcher"]] = torch.tensor([3, 9, SENTINEL, SENTINEL], dtype=rows.dtype)
    rows[tbl.slot_of["bystander"]] = torch.tensor([1, 2, SENTINEL, SENTINEL], dtype=rows.dtype)
    tbl.store_seen("Npc", seen._replace(rows=rows))
    assert sessions_seeing_rows(tbl, "Npc", np.array([9, 30])) == ["watcher"]
    assert sessions_seeing_rows(tbl, "Npc", np.array([], np.int64)) == []
    assert sorted(sessions_seeing_rows(tbl, "Npc", np.array([2, 3]))) == ["bystander", "watcher"]
    assert sessions_seeing_rows(tbl, "Npc", np.array([SENTINEL])) == []


def test_autoscaler_requires_consecutive_breaches_and_cools_down():
    pol = AutoscalePolicy(consecutive=3, cooldown_polls=5, max_devices=8)
    a = Autoscaler(pol)
    hot = {"tick_p95_ms": 80.0}
    assert a.observe(hot, devices=2) is None
    assert a.observe(hot, devices=2) is None
    assert a.observe(hot, devices=2) == "grow"
    for _ in range(pol.cooldown_polls):
        assert a.observe(hot, devices=4) is None
    a2 = Autoscaler(pol)
    a2.observe(hot, 2)
    a2.observe({"tick_p95_ms": 1.0}, 2)
    a2.observe(hot, 2)
    assert a2.observe(hot, 2) is None


def test_autoscaler_drains_when_cold_and_respects_bounds():
    pol = AutoscalePolicy(consecutive=2, cooldown_polls=0, min_devices=2, max_devices=4)
    a = Autoscaler(pol)
    cold = {"tick_p95_ms": 1.0}
    assert a.observe(cold, devices=4) is None
    assert a.observe(cold, devices=4) == "drain"
    a.observe(cold, 2)
    a.observe(cold, 2)
    assert a.observe(cold, devices=2) is None
    hot = {"hbm_frac": 0.99}
    a.observe(hot, 4)
    assert a.observe(hot, devices=4) is None
    assert a.observe({}, devices=4) is None


def test_elastic_autoscale_hook_fires_grow():
    _k, sk, mig = _mk_world(2)
    el = ElasticMesh(sk, migration=mig, ident_cols={"Npc": 0},
                     autoscaler=Autoscaler(AutoscalePolicy(
                         consecutive=1, cooldown_polls=0, max_devices=4)))
    assert el.maybe_autoscale({"tick_p95_ms": 500.0}) == "grow"
    assert el.inflight == "grow"
    assert el.maybe_autoscale({"tick_p95_ms": 500.0}) is None


def test_gameworld_shard_returns_the_elastic_mesh():
    """GameWorld.shard places the world on the placement's mesh and
    returns the ElasticMesh; a grow retargets the migrate phase."""
    from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig

    pl = SpatialPlacement(class_name="NPC", pos_prop="Position", extent=64.0,
                          cell_size=8.0, width=8, n_shards=2, mig_budget=8)
    w = GameWorld(WorldConfig(npc_capacity=64, extent=64.0, combat=True, regen=False,
                              middleware=False, placement=pl, mesh=_mesh(2)),
                  device="cpu").start()
    w.scene.create_scene(1, width=64.0)
    w.seed_npcs(24)
    el = w.shard(ident_cols={"NPC": w.kernel.store.spec("NPC").slot("Gold").col})
    assert isinstance(el, ElasticMesh) and el.n_devices == 2
    assert w.kernel.sharded is w.sharded
    w.tick()
    el.begin_grow(4)
    el.poll()
    assert w.migration.placement.n_shards == 4 and w.migration.mesh.size == 4
    w.tick()
    assert dataclasses.replace(pl, n_shards=4) == w.migration.placement
