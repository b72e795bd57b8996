"""The port's many-worlds rooms (noahgameframe_tpu_torch/parallel/rooms.py)
against the JAX package's (noahgameframe_tpu/parallel/rooms.py, run
without a mesh), on the CPU at tolerance 0:

(a) 4 rooms of the train recipe (32 NPC rows, 16 seeded, skin 2.0, digest
    on, PRNGKey(50 + i)): every tick's [R, L] summary equals the JAX
    batch's for 30 ticks under fold engines 0, 1 and 2 (the port's engines
    1 and 2 run their kernels' plain versions on the CPU), with the vmap
    fallback off; the whole batched state is equal at the end, and
    carries across with rooms_from_numpy/rooms_to_numpy;
(b) the JAX package's rooms scenario (tests/test_rooms.py) on the port:
    lockstep single-room controls through destroy, create into the
    recycled slot, re-home, grow and the cross-engine door, with no
    unexplained re-capture after the warm-up mark;
(c) train(4) over 10 ticks (2 dispatches and a ragged tail) against tick();
(d) run(5) stamps tick 6 after one tick, and run(0) is a no-op;
(e) a room blob packed by the JAX package admits into a port slot and
    both advance to the same digest; a port blob decodes in the JAX
    package; corruption and CRC-valid tampering are rejected;
(f) the bin packer's policies, exhaustion and growth.
"""

import jax
import numpy as np
import pytest
import torch

from noahgameframe_tpu.game import GameWorld as JaxWorld
from noahgameframe_tpu.game.world import WorldConfig as JaxConfig
from noahgameframe_tpu.parallel import rooms as jrooms
from noahgameframe_tpu_torch.core.prng import prng_key
from noahgameframe_tpu_torch.core.store import rooms_from_numpy, rooms_to_numpy
from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig
from noahgameframe_tpu_torch.parallel import rooms as prooms
from noahgameframe_tpu_torch.parallel.rooms import (
    RoomBatch,
    RoomBinPacker,
    RoomDirectory,
    RoomSlotsFull,
    no_vmap_fallback,
    room_digest,
)
from noahgameframe_tpu_torch.parallel.mesh import ROOMS_AXIS, make_mesh
from noahgameframe_tpu_torch.persist.rowblob import RowBlobError, frame_blob, unframe_blob
from test_torch_parity import assert_tree_equal, jax_tree
from test_torch_parity import one_intra_op_thread  # noqa: F401

ROOMS = 4
TICKS = 30
TRAIN_CONFIG = dict(npc_capacity=32, player_capacity=8, extent=64.0, seed=7, combat=True,
                    movement=True, regen=True, verlet_skin=2.0)


def _seed_train(w, engine):
    w.start()
    w.scene.create_scene(1, width=64.0)
    w.seed_npcs(16, rng=np.random.default_rng(107))
    w.kernel.enable_digest()
    w.combat.use_pallas = engine
    w.kernel._ensure_aux()
    return w


def _port_batch(engine=0):
    w = _seed_train(GameWorld(WorldConfig(middleware=False, **TRAIN_CONFIG), device="cpu"),
                    engine)
    batch = RoomBatch(w.kernel, ROOMS)
    packer = RoomBinPacker(batch.capacity)
    for i in range(ROOMS):
        batch.admit(packer.alloc(), w.kernel.state.replace(rng=prng_key(50 + i, "cpu")))
    return batch


def _jax_batch(engine=0):
    w = _seed_train(JaxWorld(JaxConfig(middleware=False, **TRAIN_CONFIG)), engine)
    batch = jrooms.RoomBatch(w.kernel, ROOMS)
    packer = jrooms.RoomBinPacker(batch.capacity)
    for i in range(ROOMS):
        batch.admit(packer.alloc(), w.kernel.state.replace(rng=jax.random.PRNGKey(50 + i)))
    return batch


@pytest.fixture(scope="module")
def jax_runs():
    """Per engine: the JAX batch's [R, L] summary of every tick and its
    final state (the reference builds once per module)."""
    out = {}
    for engine in (0, 1, 2):
        batch = _jax_batch(engine)
        step = batch._compile_step()
        summaries = []
        for _ in range(TICKS):
            batch.state, summary = step(batch.state)
            summaries.append(np.asarray(summary))
        out[engine] = (summaries, jax_tree(batch.state),
                       jax.tree.map(lambda a: np.asarray(a).copy(), batch.state))
    return out


@pytest.mark.parametrize("engine", [0, 1, 2])
def test_room_summaries_equal_jax_every_tick(jax_runs, engine):
    want, want_state, _ = jax_runs[engine]
    batch = _port_batch(engine)
    assert torch._C._functorch._is_vmap_fallback_enabled()
    for t in range(TICKS):
        counters = batch.tick()
        assert torch._C._functorch._is_vmap_fallback_enabled(), "the fallback is restored"
        np.testing.assert_array_equal(batch.last_summary, want[t], err_msg=f"tick {t}")
    assert counters["tick"].tolist() == [TICKS] * ROOMS
    assert ("aoi_interest_pairs" in counters) == (engine == 2)
    assert len(set(counters["state_digest"].tolist())) == ROOMS, "rooms differ by their keys"
    assert_tree_equal(want_state, rooms_to_numpy(batch.state))


def test_rooms_numpy_carry_over(jax_runs):
    """rooms_from_numpy of the JAX batch's state round-trips, and a port
    batch loaded with it (fresh Verlet caches) ticks on to the JAX batch's
    next digests."""
    _, tree, jstate = jax_runs[0]
    state = rooms_from_numpy(tree, device="cpu")
    assert_tree_equal(tree, rooms_to_numpy(state))
    batch = _port_batch(0)
    batch.load_state(state)
    got = batch.tick()["state_digest"]
    jb = _jax_batch(0)
    jb.state = jstate
    want = jb.tick()["state_digest"]
    np.testing.assert_array_equal(got, want)


def test_vmap_fallback_switch():
    """Inside no_vmap_fallback() the slow path is off; after it, restored."""
    before = torch._C._functorch._is_vmap_fallback_enabled()
    with no_vmap_fallback():
        assert not torch._C._functorch._is_vmap_fallback_enabled()
    assert torch._C._functorch._is_vmap_fallback_enabled() == before


# -- (b) the rooms scenario with single-room controls --------------------------


def _recipe(seed):
    w = GameWorld(WorldConfig(npc_capacity=48, player_capacity=8, extent=48.0, seed=seed,
                              middleware=False, combat=True, movement=True, regen=True,
                              verlet_skin=2.0), device="cpu")
    w.start()
    w.scene.create_scene(1, width=48.0)
    w.seed_npcs(16, rng=np.random.default_rng(seed + 100))
    return w


@pytest.fixture(scope="module")
def scenario():
    """One choreography, as tests/test_rooms.py runs it; tests assert on
    the recording."""
    from noahgameframe_tpu_torch.telemetry.registry import MetricsRegistry

    rec = {}
    reg = MetricsRegistry()
    d = RoomDirectory(_recipe, capacity=8, template_seed=0, registry=reg)
    rooms = [d.create_room(seed=s, control=True) for s in (1, 2, 3)]
    rec["slots0"] = {r: d.slot_of(r) for r in rooms}
    d.run(2)
    d.digest(rooms[0])
    mark = d.batch.costbook.mark()
    d.run(22)
    rec["parity_24"] = {r: (d.digest(r), d.control_digest(r)) for r in rooms}

    freed = d.destroy_room(rooms[1])
    r4 = d.create_room(seed=9, control=True)
    rec["freed_slot"], rec["recycled_slot"] = freed, d.slot_of(r4)
    src, dst = d.rehome_room(rooms[0])
    rec["rehome"] = (src, dst)
    rec["parity_after_rehome"] = (d.digest(rooms[0]), d.control_digest(rooms[0]))

    d.run(12)
    live = [rooms[0], rooms[2], r4]
    rec["parity_churn"] = {r: (d.digest(r), d.control_digest(r)) for r in live}
    rec["unexplained"] = d.batch.costbook.unexplained_since(mark)
    rec["loads"] = {r: int(d.batch.extract(d.slot_of(r)).classes["NPC"].alive.sum())
                    for r in live}
    rec["status"] = d.status()
    rec["gauges"] = (reg.value("nf_rooms_active"), reg.value("nf_rooms_slots_free"),
                     reg.value("nf_rooms_rehomed_total"))

    mark2 = d.batch.costbook.mark()
    d.grow(16)
    d.run(3)
    rec["grow"] = (d.batch.capacity, d.packer.capacity)
    rec["grow_unexplained"] = d.batch.costbook.unexplained_since(mark2)
    rec["grow_generations"] = [e["cause"] for e in d.batch.costbook.gen_events]
    rec["parity_grow"] = {r: (d.digest(r), d.control_digest(r)) for r in live}

    # the cross-engine door: a single world's snapshot into a batch slot,
    # both advanced 7 (batch.run skews the other rooms, so this runs last)
    w = _recipe(77)
    w.kernel._ensure_aux()
    w.kernel.run_device(5, reconcile=False)
    blob = prooms.pack_room_blob(w.kernel.state, w.kernel.store.class_order)
    slot = d.packer.alloc()
    d.batch.admit_blob(slot, blob)
    d.batch.run(7)
    w.kernel.run_device(7, reconcile=False)
    rec["snapshot_parity"] = (d.batch.digest(slot),
                              room_digest(w.kernel.state, w.kernel.store.class_order))
    return rec


def test_batched_rooms_match_single_room_controls(scenario):
    for r, (live, want) in scenario["parity_24"].items():
        assert live == want, f"room {r} diverged at tick 24"


def test_destroy_recycles_the_slot(scenario):
    assert scenario["recycled_slot"] == scenario["freed_slot"]


def test_rehome_mid_combat_is_slot_invariant(scenario):
    src, dst = scenario["rehome"]
    assert src != dst
    live, want = scenario["parity_after_rehome"]
    assert live == want, "the move itself changed the room's bytes"


def test_parity_survives_churn(scenario):
    for r, (live, want) in scenario["parity_churn"].items():
        assert live == want, f"room {r} diverged after churn"


def test_churn_causes_zero_unexplained_recaptures(scenario):
    assert scenario["unexplained"] == [], scenario["unexplained"]


def test_zero_dropped_rows_across_rehomes(scenario):
    assert all(n == 16 for n in scenario["loads"].values()), scenario["loads"]


def test_occupancy_status_and_gauges(scenario):
    st = scenario["status"]
    assert st["active"] == len(st["occupancy"]) == 3
    assert st["capacity"] - st["active"] == st["slots_free"]
    assert st["destroyed"] == 1 and st["rehomed"] == 1
    assert scenario["gauges"] == (3.0, float(st["slots_free"]), 1.0)


def test_grow_is_sanctioned_and_preserves_parity(scenario):
    assert scenario["grow"] == (16, 16)
    assert scenario["grow_unexplained"] == []
    assert "rooms_grow:8->16" in scenario["grow_generations"]
    for r, (live, want) in scenario["parity_grow"].items():
        assert live == want, f"room {r} diverged across grow"


def test_cross_engine_snapshot_load(scenario):
    live, want = scenario["snapshot_parity"]
    assert live == want


# -- (c) trains, (d) run's last counters -----------------------------------------


def test_train_matches_tick():
    """train(10) at K = 4: two dispatches and a ragged tail of two single
    steps, every tick's [R, L] summary equal to tick()'s."""
    trained, ticked = _port_batch(), _port_batch()
    trained.configure_train(4)
    lanes = trained.train(10)
    assert lanes.shape[:2] == (10, ROOMS)
    assert trained.train_dispatches == 2 and trained.train_ticks == 8
    assert trained.tick_count == 10
    assert trained.train_fetch_bytes == 2 * lanes[:4].nbytes
    for t in range(10):
        ticked.tick()
        np.testing.assert_array_equal(lanes[t], ticked.last_summary, err_msg=f"tick {t}")
    assert trained.last_counters["tick"].tolist() == [10] * ROOMS


def test_run_refreshes_last_counters():
    """The contract of test_train.py::test_rooms_run_refreshes_last_counters,
    without a mesh: run(5) after one tick stamps tick 6 and the final
    digests; run(0) is a no-op."""
    batch = _port_batch()
    c1 = batch.tick()
    assert c1["tick"].tolist() == [1] * ROOMS
    got = batch.run(5)
    assert got["tick"].tolist() == [6] * ROOMS
    assert not np.array_equal(got["state_digest"], c1["state_digest"])
    want = [room_digest(batch.extract(i), batch.kernel.store.class_order)
            for i in range(ROOMS)]
    assert (got["state_digest"].astype(np.int64) & 0xFFFFFFFF).tolist() == want
    before = batch.tick_count
    again = batch.run(0)
    assert batch.tick_count == before
    assert np.array_equal(again["state_digest"], got["state_digest"])
    assert np.array_equal(again["tick"], got["tick"])


# -- (e) blobs across the packages ------------------------------------------------


def _jax_single(seed=77):
    w = JaxWorld(JaxConfig(npc_capacity=32, player_capacity=8, extent=64.0, seed=seed,
                           middleware=False, combat=True, movement=True, regen=True,
                           verlet_skin=2.0))
    w.start()
    w.scene.create_scene(1, width=64.0)
    w.seed_npcs(16, rng=np.random.default_rng(seed + 100))
    w.kernel._ensure_aux()
    return w


@pytest.fixture(scope="module")
def jax_blob():
    w = _jax_single()
    w.kernel.run_device(5, reconcile=False)
    blob = jrooms.pack_room_blob(w.kernel.state, w.kernel.store.class_order)
    w.kernel.run_device(7, reconcile=False)
    return blob, jrooms.room_digest(w.kernel.state, w.kernel.store.class_order), w


def test_jax_blob_admits_into_a_port_slot(jax_blob):
    blob, want, _ = jax_blob
    batch = _port_batch()
    batch.admit_blob(2, blob)
    before = batch.digest(2)
    assert before == jrooms.room_digest(
        jrooms.unpack_room_blob(blob, jax_blob[2].kernel.state,
                                jax_blob[2].kernel.store.class_order),
        jax_blob[2].kernel.store.class_order)
    batch.run(7)
    assert batch.digest(2) == want


def test_port_blob_decodes_in_the_jax_package(jax_blob):
    """The other way: a blob the port packs is the JAX package's format."""
    _, _, jw = jax_blob
    batch = _port_batch()
    batch.run(3)
    blob = batch.pack_blob(1)
    room = jrooms.unpack_room_blob(blob, jw.kernel.state, jw.kernel.store.class_order)
    assert jrooms.room_digest(room, jw.kernel.store.class_order) == batch.digest(1)


@pytest.mark.parametrize("damage", ["flipped_byte", "tampered_tick", "truncated"])
def test_room_blob_fails_closed(jax_blob, damage):
    """A flipped byte fails the frame CRC; a CRC-valid change of the tick
    (re-framed) fails the embedded digest; a torn blob fails the frame."""
    blob = jax_blob[0]
    batch = _port_batch()
    if damage == "flipped_byte":
        bad = bytearray(blob)
        bad[len(bad) // 2] ^= 0xFF
        match = "CRC"
    elif damage == "tampered_tick":
        payload = bytearray(unframe_blob(blob, allow_legacy=False))
        off = (prooms._ROOM_HEADER.size + prooms._LEAF_HEADER.size + len("tick")
               + len(np.dtype(np.int32).str))
        payload[off] ^= 0x01
        bad = frame_blob(bytes(payload))
        match = "digest"
    else:
        bad = blob[:-5]
        match = "torn"
    with pytest.raises(RowBlobError, match=match):
        batch.admit_blob(0, bytes(bad))


def _port_mesh_batch(mesh, engine=0):
    """``_port_batch`` with its slots block-partitioned over ``mesh``."""
    w = _seed_train(GameWorld(WorldConfig(middleware=False, **TRAIN_CONFIG), device="cpu"),
                    engine)
    batch = RoomBatch(w.kernel, ROOMS, mesh=mesh)
    for i in range(ROOMS):
        batch.admit(i, w.kernel.state.replace(rng=prng_key(50 + i, "cpu")))
    return batch


def test_room_batch_on_a_mesh_equals_unsharded_and_jax(jax_runs):
    """Four rooms over a two-shard virtual CPU mesh: every tick's [R, L]
    summary equals the unsharded batch's and the JAX package's, and every
    room's digest the unsharded room's."""
    mesh = make_mesh(2, axis=ROOMS_AXIS, device="cpu", virtual=True)
    sharded, plain = _port_mesh_batch(mesh), _port_batch()
    want = jax_runs[0][0]
    for t in range(6):
        sharded.tick()
        plain.tick()
        np.testing.assert_array_equal(sharded.last_summary, plain.last_summary)
        np.testing.assert_array_equal(sharded.last_summary, want[t])
    assert [sharded.digest(i) for i in range(ROOMS)] == [plain.digest(i) for i in range(ROOMS)]


def test_room_digest_ident_cols_equals_jax():
    """The placement-invariant room digest (canonical_digest over an
    identity column) of a room equals the JAX package's."""
    port, ref = _port_batch(), _jax_batch()
    port.tick()
    ref.tick()
    order = port.kernel.store.class_order
    ident = {c: 0 for c in order}
    want = [jrooms.room_digest(ref.extract(i), order, ident_cols=ident) for i in range(ROOMS)]
    got = [room_digest(port.extract(i), order, ident_cols=ident) for i in range(ROOMS)]
    assert got == want
    assert got != [port.digest(i) for i in range(ROOMS)]  # a different fold


def test_room_capacity_not_dividing_the_mesh_raises():
    """As in the JAX package: a slot bank that does not divide the mesh
    raises, at construction and at grow."""
    from noahgameframe_tpu.parallel.mesh import make_mesh as jax_mesh

    jb = _jax_batch()
    with pytest.raises(ValueError, match="not divisible"):
        jrooms.RoomBatch(jb.kernel, ROOMS, mesh=jax_mesh(8, axis=ROOMS_AXIS))
    with pytest.raises(ValueError, match="not divisible"):
        jrooms.RoomBatch(jb.kernel, ROOMS, mesh=jax_mesh(3, axis=ROOMS_AXIS))
    pb = _port_batch()
    with pytest.raises(ValueError, match="not divisible"):
        RoomBatch(pb.kernel, ROOMS, mesh=make_mesh(8, axis=ROOMS_AXIS, device="cpu",
                                                   virtual=True))
    with pytest.raises(ValueError, match="not divisible"):
        RoomBatch(pb.kernel, ROOMS, mesh=make_mesh(3, axis=ROOMS_AXIS, device="cpu",
                                                   virtual=True))
    # a grow re-partitions the wider bank over the same mesh
    grown = _port_mesh_batch(make_mesh(4, axis=ROOMS_AXIS, device="cpu", virtual=True))
    before = [grown.digest(i) for i in range(ROOMS)]
    assert grown.grow(8) == 8
    assert [grown.digest(i) for i in range(ROOMS)] == before
    assert [p.classes["NPC"].alive.shape[0] for p in grown._parts] == [2] * 4


# -- (f) the bin packer -----------------------------------------------------------


def _least_loaded():
    p = RoomBinPacker(8, n_blocks=4)
    slots = [p.alloc(load=1.0) for _ in range(4)]
    assert sorted(p.block_of(s) for s in slots) == [0, 1, 2, 3]
    p.set_load(slots[2], 9.0)
    assert p.block_of(p.alloc(load=1.0)) != p.block_of(slots[2])


def _first_fit():
    p = RoomBinPacker(4, n_blocks=2, policy="first-fit")
    assert [p.alloc() for _ in range(4)] == [0, 1, 2, 3]


def _exhaustion():
    p = RoomBinPacker(2)
    a, b = p.alloc(), p.alloc()
    with pytest.raises(RoomSlotsFull) as ei:
        p.alloc()
    assert ei.value.capacity == 2
    p.free(a)
    assert p.alloc() == a and b == 1


def _grow():
    p = RoomBinPacker(2, n_blocks=2)
    a = p.alloc(load=3.0)
    p.grow(8, n_blocks=4)
    assert p.capacity == 8 and p.used[a] and p.load[a] == 3.0
    with pytest.raises(ValueError):
        p.grow(4)


def _bad_arguments():
    with pytest.raises(ValueError):
        RoomBinPacker(6, n_blocks=4)
    with pytest.raises(ValueError):
        RoomBinPacker(4, policy="random")


@pytest.mark.parametrize("case", [_least_loaded, _first_fit, _exhaustion, _grow,
                                  _bad_arguments], ids=lambda f: f.__name__.strip("_"))
def test_bin_packer(case):
    case()


# -- the kernels' room axis, host side ---------------------------------------------


def test_launch_grid_bounds_the_room_count():
    """One launch holds at most 2^31 - 1 blocks: R x the room's blocks
    beyond that raises before anything launches."""
    from noahgameframe_tpu_torch.ops import stencil_cuda as sc

    plan = sc._plan_args(sc.plan_fold("combat", 10, 8, 6))  # 2 blocks a room
    assert sc._fold_rooms((), 10, plan) == 1
    assert sc._fold_rooms((16_384,), 10, plan) == 16_384
    assert sc._fold_rooms((2**30 - 1,), 10, plan) == 2**30 - 1
    with pytest.raises(ValueError, match="exceed one launch's grid"):
        sc._fold_rooms((2**30,), 10, plan)


@pytest.mark.parametrize("dim", [None, 0, 1])
def test_vmap_rule_moves_the_room_axis_first(dim):
    """The vmap rules hand the launch [R, ...] contiguous tensors: a
    batched input's room axis moves to the front, an unbatched one is
    expanded to every room."""
    from noahgameframe_tpu_torch.ops.stencil_cuda import _room_front

    x = torch.arange(12).reshape(3, 4)
    got = _room_front(x, dim, 4 if dim == 1 else 3)
    want = {None: x.expand(3, 3, 4), 0: x, 1: x.t()}[dim]
    assert got.is_contiguous() and torch.equal(got, want)
