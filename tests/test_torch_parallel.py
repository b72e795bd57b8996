"""The port's sharded world tick (noahgameframe_tpu_torch.parallel.shard)
against the JAX package's, case by case after tests/test_parallel.py and
the mesh cases of tests/test_train.py.

The JAX side runs on the conftest's 8-device virtual CPU mesh; the port
on a virtual CPU mesh of the same width (``make_mesh(8, device="cpu",
virtual=True)``).  Both packages build the same seeded worlds; what is
compared (digest streams, counter banks, banks) must be bit-exact."""

import numpy as np
import pytest
import torch

from noahgameframe_tpu.game import GameWorld as JaxWorld
from noahgameframe_tpu.game.world import WorldConfig as JaxConfig
from noahgameframe_tpu.game.world import build_benchmark_world as jax_bench_world
from noahgameframe_tpu.parallel import ShardedKernel as JaxSharded
from noahgameframe_tpu_torch.core.store import state_to_numpy
from noahgameframe_tpu_torch.game import GameEvent
from noahgameframe_tpu_torch.game.defines import COMM_PROPERTY_RECORD, PropertyGroup
from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig, build_benchmark_world
from noahgameframe_tpu_torch.parallel import (
    ShardedKernel,
    make_mesh,
    shard_rows_by_cell,
    world_shardings,
)
from noahgameframe_tpu_torch.persist.checkpoint import load_world, save_world
from test_torch_parity import assert_tree_equal, jax_tree, one_intra_op_thread  # noqa: F401

N_DEV = 8
TICKS = 12
CONFIG = dict(npc_capacity=256, player_capacity=64, extent=64.0, attack_period_s=1.0 / 30.0)


def _mesh(n=N_DEV):
    return make_mesh(n, device="cpu", virtual=True)


def _port_world(engine=0, **over):
    w = GameWorld(WorldConfig(**{**CONFIG, **over}), device="cpu")
    w.start()
    w.scene.create_scene(1, width=64.0)
    w.seed_npcs(200, camps=2)
    w.combat.use_pallas = engine
    w.kernel.enable_digest()
    return w


def _jax_world(**over):
    w = JaxWorld(JaxConfig(**{**CONFIG, **over}))
    w.start()
    w.scene.create_scene(1, width=64.0)
    w.seed_npcs(200, camps=2)
    w.kernel.enable_digest()
    return w


@pytest.fixture(scope="module")
def jax_sharded_stream():
    """The JAX package's 8-device sharded tick: TICKS counter banks, the
    killed-event counts, and the final state."""
    w = _jax_world()
    killed = []
    w.kernel.events.subscribe_batch(
        int(GameEvent.ON_OBJECT_BE_KILLED), lambda c, m, p: killed.append(int(m.sum())))
    sk = JaxSharded(w.kernel, n_devices=N_DEV)
    sk.place()
    stream = [sk.tick().counters for _ in range(TICKS)]
    return stream, killed, jax_tree(w.kernel.state)


def test_make_mesh():
    mesh = _mesh()
    assert mesh.size == N_DEV and mesh.virtual
    # a real mesh takes the first n cards and raises with fewer; a
    # virtual one exists only when asked for
    with pytest.raises(RuntimeError, match="need 8 devices"):
        make_mesh(N_DEV)
    with pytest.raises(ValueError, match="virtual=True"):
        make_mesh(N_DEV, device="cpu")


def test_world_shardings_structure():
    w = _port_world()
    sh = world_shardings(w.kernel.state, _mesh())
    assert sh.classes["NPC"].i32.spec == ("shard",)
    assert sh.tick.spec == () and sh.rng.spec == ()
    # IObject holds 8 rows: divisible by 8, so row-blocked too
    assert sh.classes["IObject"].alive.spec == ("shard",)


@pytest.mark.parametrize("engine", [0, 1, 2])
def test_sharded_tick_matches_single_device_and_jax(jax_sharded_stream, engine):
    """Golden test: the sharded tick's counter banks (state_digest
    included) equal the single-device tick's and the JAX package's
    sharded tick's, tick by tick, under every combat engine (engines 1
    and 2 run their kernels' plain versions on the CPU).  The port's buff
    phase counts ``buffs_active`` and ``buffs_expired``, which the JAX
    package's does not: they are held to the single-device tick's."""
    want, _killed, want_state = jax_sharded_stream
    ref = _port_world(engine)
    single = [ref.kernel.tick().counters for _ in range(TICKS)]
    w = _port_world(engine)
    sk = ShardedKernel(w.kernel, mesh=_mesh())
    sk.place()
    got = [sk.tick().counters for _ in range(TICKS)]
    drop = {"aoi_interest_pairs"}  # engine 2's extra occupancy counter
    port_only = {"buffs_active", "buffs_expired"}
    for t in range(TICKS):
        g = {k: v for k, v in got[t].items() if k not in drop}
        assert g == {k: v for k, v in single[t].items() if k not in drop}, t
        assert set(g) - set(want[t]) == port_only, t
        assert {k: v for k, v in g.items() if k not in port_only} == want[t], t
    assert_tree_equal(want_state, state_to_numpy(w.kernel.state))


def test_sharded_run_device_equals_jax():
    w = _port_world()
    sk = ShardedKernel(w.kernel, mesh=_mesh())
    sk.place()
    sk.run_device(TICKS)
    j = _jax_world()
    jsk = JaxSharded(j.kernel, n_devices=N_DEV)
    jsk.place()
    jsk.run_device(TICKS)
    assert_tree_equal(jax_tree(j.kernel.state), state_to_numpy(w.kernel.state))
    hp = w.kernel.store.column(w.kernel.state, "NPC", "HP")
    alive = w.kernel.state.classes["NPC"].alive
    assert int(alive.sum()) == 200
    assert bool((hp[alive] < 100).any())  # combat happened across shards


def test_sharded_events_still_fire(jax_sharded_stream):
    _stream, want, _state = jax_sharded_stream
    w = _port_world()
    sk = ShardedKernel(w.kernel, mesh=_mesh())
    sk.place()
    killed = []
    w.kernel.events.subscribe_batch(
        int(GameEvent.ON_OBJECT_BE_KILLED), lambda c, m, p: killed.append(int(m.sum())))
    for _ in range(TICKS):
        sk.tick()
    assert killed == want and sum(killed) > 0


def test_capacity_divisibility_check():
    """A LARGE non-divisible class raises; small control-plane classes
    replicate with a warning, and the mixed world ticks as one device
    does."""
    w = GameWorld(WorldConfig(npc_capacity=8191), device="cpu")
    w.start()
    with pytest.raises(ValueError, match="not divisible"):
        ShardedKernel(w.kernel, mesh=_mesh())

    def small():
        w2 = GameWorld(WorldConfig(npc_capacity=96, player_capacity=64), device="cpu")
        w2.start()
        w2.scene.create_scene(1, width=64.0)
        w2.seed_npcs(48)
        w2.kernel.enable_digest()
        return w2

    w2, ref = small(), small()
    with pytest.warns(UserWarning, match="REPLICATED"):
        sk = ShardedKernel(w2.kernel, mesh=_mesh(3))
    assert "IObject" in sk.replicated_classes
    assert "Player" in sk.replicated_classes  # 64 % 3 != 0, small
    assert "NPC" not in sk.replicated_classes  # 96 % 3 == 0, sharded
    sk.place()
    got = [sk.tick().counters for _ in range(3)]
    want = [ref.kernel.tick().counters for _ in range(3)]
    assert got == want
    assert int(w2.kernel.state.classes["NPC"].alive.sum()) == 48


def test_shard_rows_by_cell():
    cell = np.asarray([3, 1, 3, 0, 1, 2])
    order = shard_rows_by_cell(6, 2, cell)
    assert (np.sort(cell[order]) == cell[order]).all()


def _uneven(capacity, alive_rows, ticks):
    """A world whose live rows sit on the first shards only."""
    def build(pkg_world, pkg_config, **kw):
        w = pkg_world(pkg_config(npc_capacity=capacity, player_capacity=64, extent=256.0,
                                 attack_period_s=1.0 / 30.0, middleware=False), **kw)
        w.start()
        w.scene.create_scene(1, width=256.0)
        w.seed_npcs(alive_rows, camps=2)
        return w

    w = build(GameWorld, WorldConfig, device="cpu")
    sk = ShardedKernel(w.kernel, mesh=_mesh())
    sk.place()
    sk.run_device(ticks)
    j = build(JaxWorld, JaxConfig)
    jsk = JaxSharded(j.kernel, n_devices=N_DEV)
    jsk.place()
    jsk.run_device(ticks)
    assert_tree_equal(jax_tree(j.kernel.state), state_to_numpy(w.kernel.state))
    hp = w.kernel.store.column(w.kernel.state, "NPC", "HP")
    alive = w.kernel.state.classes["NPC"].alive
    assert int(alive.sum()) == alive_rows
    assert bool((hp[alive] < 100).any())
    assert not bool(alive[alive_rows:].any())  # the dead region stayed dead


def test_sharded_world_uneven_aliveness():
    """Live rows concentrated on the first shards (rows allocate densely
    from 0): the sharded tick stays bit-exact with the JAX package's."""
    _uneven(4096, 750, 6)


@pytest.mark.slow
def test_sharded_large_world_uneven_aliveness():
    """The JAX test's size: 12k live rows in a 64k-row bank, 35 ticks."""
    _uneven(65536, 12_000, 35)


def _intermingled(pkg_world, pkg_config, movement, **kw):
    """400 NPCs of alternating camps at close quarters: rows i and i+1
    land on different shards."""
    w = pkg_world(pkg_config(npc_capacity=512, player_capacity=64, extent=64.0,
                             attack_period_s=1.0 / 30.0, movement=movement, regen=False,
                             middleware=False), **kw)
    w.start()
    w.scene.create_scene(1, width=64.0)
    rng = np.random.RandomState(5)
    pos = rng.uniform(0, 64.0, (400, 2)).astype(np.float32)
    k = w.kernel
    values = {
        "SceneID": [1] * 400,
        "GroupID": [0] * 400,
        "Position": [(float(x), float(y), 0.0) for x, y in pos],
        "HP": [300] * 400,
        "Camp": [i % 2 for i in range(400)],
    }
    k.state, _guids, rows = k.store.create_many(k.state, "NPC", 400, values=values)
    k.state = k.store.record_write_rows(
        k.state, "NPC", rows, COMM_PROPERTY_RECORD, int(PropertyGroup.EFFECTVALUE),
        {"MAXHP": [300] * 400, "ATK_VALUE": [9] * 400, "DEF_VALUE": [2] * 400})
    w.combat.arm_all()
    return w


@pytest.mark.parametrize("movement", [False, True])
def test_sharded_combat_parity_across_shards(movement):
    """Entities intermingled across shards resolve the single-device
    run's damage and LastAttacker (and, moving, positions), and the JAX
    package's."""
    ref = _intermingled(GameWorld, WorldConfig, movement, device="cpu")
    for _ in range(8):
        ref.tick()
    w = _intermingled(GameWorld, WorldConfig, movement, device="cpu")
    sk = ShardedKernel(w.kernel, mesh=_mesh())
    sk.place()
    for _ in range(8):
        sk.tick()
    j = _intermingled(JaxWorld, JaxConfig, movement)
    for _ in range(8):
        j.tick()
    for col in ("HP", "LastAttacker"):
        a = w.kernel.store.column(w.kernel.state, "NPC", col)
        assert torch.equal(a, ref.kernel.store.column(ref.kernel.state, "NPC", col))
    assert_tree_equal(jax_tree(j.kernel.state), state_to_numpy(w.kernel.state))


def test_sharded_world_checkpoint_roundtrip(tmp_path):
    """A mesh-sharded world checkpoints (the save assembles the blocks)
    and resumes bit-identically on a new mesh; the JAX package loads the
    same checkpoint to the same banks."""
    w = build_benchmark_world(2000, seed=3, device="cpu")
    sk = ShardedKernel(w.kernel, mesh=_mesh())
    sk.place()
    sk.run_device(10)
    save_world(w.kernel, tmp_path, modules=w.all_modules)
    ref = w.kernel.state.classes["NPC"].i32.clone()

    w2 = build_benchmark_world(2000, seed=99, device="cpu")
    load_world(w2.kernel, tmp_path, modules=w2.all_modules)
    assert torch.equal(w2.kernel.state.classes["NPC"].i32, ref)
    j = jax_bench_world(2000, seed=99)
    from noahgameframe_tpu.persist.checkpoint import load_world as jax_load

    jax_load(j.kernel, tmp_path, modules=j.all_modules)
    np.testing.assert_array_equal(np.asarray(j.kernel.state.classes["NPC"].i32), ref.numpy())
    sk2 = ShardedKernel(w2.kernel, mesh=_mesh(4))
    sk2.place()
    sk2.run_device(5)  # the resumed world re-shards and keeps ticking
    w.kernel.run_device(5)
    assert torch.equal(w.kernel.state.classes["NPC"].i32, w2.kernel.state.classes["NPC"].i32)


def test_sharded_kernel_follows_invalidate():
    """kernel.invalidate() (a bucket resize, a phase swap) drops the
    sharded dispatchers and the blocks' aux caches too: the next step
    re-splits the host state with fresh aux."""
    w = _port_world(verlet_skin=2.0)
    sk = ShardedKernel(w.kernel, mesh=_mesh())
    sk.place()
    sk.tick()
    step = sk._step_fn
    splits = sk.splits
    assert step is not None
    w.kernel.invalidate()
    sk.tick()
    assert sk._step_fn is not None and sk._step_fn is not step
    assert sk.splits == splits + 1
    sk.run_device(2)
    run = sk._run_fn
    w.kernel.set_phases(w.kernel._composed)
    sk.run_device(2)
    assert sk._run_fn is not run


def test_sharded_combat_overflow_resize_takes_effect():
    """Everyone piled into one cell with a bucket of 1 overflows; the
    combat module doubles the bucket and invalidates, and the mesh picks
    it up: the drops stop."""
    w = GameWorld(WorldConfig(
        combat=True, movement=False, regen=False, middleware=False,
        npc_capacity=64, player_capacity=8, extent=64.0,
        aoe_radius=8.0, aoi_bucket=1, attack_period_s=1.0 / 30.0, respawn_s=1e6,
    ), device="cpu").start()
    w.scene.create_scene(1)
    w.seed_npcs(32)
    k = w.kernel
    host = k.store._hosts["NPC"]
    for row in np.flatnonzero(host.alloc_mask):
        k.set_property(host.row_guid[int(row)], "Position", (10.0, 10.0, 0.0))
    c = w.combat
    assert c.auto_resize
    c.max_bucket_boost = 64  # headroom for 32 piled into bucket 1
    sk = ShardedKernel(k, mesh=_mesh())
    sk.place()
    for _ in range(TICKS):
        sk.tick()
        if c._bucket_boost >= 32:
            break
    assert c._bucket_boost >= 32, "mesh never picked up the resize"
    assert c.overflow_alerts >= 1
    sk.tick()
    before = c.overflow_total
    sk.tick()
    sk.tick()
    assert c.overflow_total == before


def _recipe():
    """tests/test_train.py's recipe world (16 NPCs, Verlet skin 2)."""
    w = GameWorld(WorldConfig(npc_capacity=32, player_capacity=8, extent=64.0, seed=7,
                              combat=True, movement=True, regen=True, verlet_skin=2.0,
                              middleware=False), device="cpu")
    w.start()
    w.scene.create_scene(1, width=64.0)
    w.seed_npcs(16, rng=np.random.default_rng(107))
    w.kernel.enable_digest()
    return w


def test_sharded_train_digest_parity():
    """K=4 trains on the mesh: 12 frames (3 trains), each frame's digest
    equal to the single-device control's (tests/test_train.py)."""
    ctl = _recipe()
    want = [ctl.kernel.tick().counters["state_digest"] for _ in range(14)]
    w = _recipe()
    sk = ShardedKernel(w.kernel, mesh=_mesh())
    sk.place()
    sk.configure_train(4)
    outs = sk.train(14)  # 3 trains + 2 ragged singles
    assert [o.counters["state_digest"] for o in outs] == want
    assert w.kernel.train_dispatches == 3


def _rooms_on_mesh(n_rooms=16):
    from noahgameframe_tpu_torch.core.prng import prng_key
    from noahgameframe_tpu_torch.parallel import ROOMS_AXIS, RoomBatch, RoomBinPacker

    mesh = make_mesh(8, axis=ROOMS_AXIS, device="cpu", virtual=True)
    w = _recipe()
    w.kernel._ensure_aux()
    batch = RoomBatch(w.kernel, n_rooms, mesh=mesh)
    packer = RoomBinPacker(batch.capacity, n_blocks=8)
    for i in range(n_rooms):
        batch.admit(packer.alloc(), w.kernel.state.replace(rng=prng_key(50 + i, "cpu")))
    return batch


def test_rooms_train_digest_parity():
    """Rooms over an 8-shard mesh: a K=4 train's lanes equal the tick
    control's digests and tick stamps (tests/test_train.py)."""
    b_train, b_ctl = _rooms_on_mesh(), _rooms_on_mesh()
    b_train.configure_train(4)
    lanes = b_train.train(10)  # [10, R, L]: 2 trains + 2 ragged singles
    assert lanes.shape[0] == 10
    assert b_train.train_dispatches == 2
    assert b_train.tick_count == 10
    ctl = [b_ctl.tick() for _ in range(10)]
    for i in range(10):
        c = b_train.kernel.decode_counters(lanes[i])
        assert np.array_equal(c["state_digest"], ctl[i]["state_digest"]), i
        assert np.array_equal(c["tick"], ctl[i]["tick"]), i


def test_rooms_run_refreshes_last_counters():
    """run() returns the FINAL tick's decoded row and run(0) is a no-op,
    on the 8-shard rooms mesh of tests/test_train.py.  The JAX package
    fails this case before its first tick (XLA refuses to shard the
    recipe's zero-width leaf int32[16, 64, 0] on the mesh); the port
    splits the leading room axis of every leaf, zero-width ones too."""
    batch = _rooms_on_mesh()
    c1 = batch.tick()
    assert np.asarray(c1["tick"]).tolist() == [1] * 16
    got = batch.run(5)
    assert np.asarray(got["tick"]).tolist() == [6] * 16
    assert not np.array_equal(got["state_digest"], c1["state_digest"])
    before = batch.tick_count
    again = batch.run(0)
    assert batch.tick_count == before
    assert np.array_equal(again["state_digest"], got["state_digest"])
    assert np.array_equal(again["tick"], got["tick"])
