"""The port's spatially-sharded combat preset
(noahgameframe_tpu_torch.parallel.spatial), case by case after
tests/test_spatial.py.

The parity oracle is ``reference_step``, the single-device twin (same
movement and duty, the square-grid plain fold).  A world whose entities
stand still (speed 0) is also held to the JAX package's preset on its
8-device CPU mesh, tick by tick: positions, HP and the migration
counters.  A moving world is held to the port's own oracle and to a
one-shard world: the walk's headings go through ``cos``/``sin``, and
XLA's CPU ``cos``/``sin`` round differently from torch's in about one
call of a hundred, so a moving world's positions are not comparable
across packages."""

import numpy as np
import pytest
import torch

from noahgameframe_tpu.parallel.spatial import SpatialGeom as JaxGeom
from noahgameframe_tpu.parallel.spatial import SpatialWorld as JaxSpatial
from noahgameframe_tpu_torch.parallel.mesh import make_mesh
from noahgameframe_tpu_torch.parallel.spatial import (
    SpatialGeom,
    SpatialWorld,
    reference_step,
)
from test_torch_parity import one_intra_op_thread  # noqa: F401

TICKS = 12


def _mesh(n):
    return make_mesh(n, device="cpu", virtual=True)


def _world(geom, **kw):
    return SpatialWorld(geom, mesh=_mesh(geom.n_shards), **kw)


def _mk_world(n=1500, seed=3, **over):
    geom_kw = dict(
        extent=128.0, cell_size=4.0, width=32, n_shards=4,
        bucket=24, att_bucket=24, radius=4.0, mig_budget=512,
        speed=1.0, attack_period=3,
    )
    geom_kw.update(over)
    geom = SpatialGeom(**geom_kw)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(1.0, geom.extent - 1.0, (n, 2)).astype(np.float32)
    hp = np.full(n, 1000, np.int32)
    atk = rng.integers(5, 20, n).astype(np.int32)
    camp = (np.arange(n) % 2).astype(np.int32)
    return geom, pos, hp, atk, camp


def _run_reference(geom, pos, hp, atk, camp, ticks):
    n = pos.shape[0]
    gid = torch.arange(n, dtype=torch.int32)
    active = torch.ones(n, dtype=torch.bool)
    p, h = torch.from_numpy(pos), torch.from_numpy(hp)
    d = torch.full((n,), -1, dtype=torch.int32)
    a, c = torch.from_numpy(atk), torch.from_numpy(camp)
    for t in range(ticks):
        p, h, d = reference_step(geom, p, h, a, c, gid, d, active,
                                 torch.tensor(t, dtype=torch.int32))
    return p.numpy(), h.numpy()


def _jax_twin(geom, **kw):
    return JaxSpatial(JaxGeom(**geom._asdict()), **kw)


def test_spatial_matches_single_device():
    """Movement + combat: every gid's position and HP match the oracle
    bit for bit, and rows really migrated."""
    geom, pos, hp, atk, camp = _mk_world()
    world = _world(geom)
    world.place(pos, hp, atk, camp)
    migrated_total = 0
    for _ in range(TICKS):
        world.step()
        migrated_total += int(world.stats_last[:, 0].sum())
        # generous budgets: nothing may overflow or drop
        assert world.stats_last[:, 1:].sum() == 0, world.stats_last
    ref_pos, ref_hp = _run_reference(geom, pos, hp, atk, camp, TICKS)
    got = world.gather()
    assert len(got) == pos.shape[0]
    for gid_, (x, y, hp_) in got.items():
        assert hp_ == int(ref_hp[gid_]), f"gid {gid_} hp"
        np.testing.assert_array_equal(np.float32([x, y]), ref_pos[gid_])
    assert migrated_total > 12, migrated_total
    assert sum(1 for _, (_, _, h) in got.items() if h < 1000) > len(got) * 0.5


def test_spatial_halo_crosses_slab_boundary():
    """Two enemies straddling a slab boundary within radius damage each
    other across the halo (speed 0: nothing migrates); as in the JAX
    package."""
    geom = SpatialGeom(
        extent=64.0, cell_size=4.0, width=16, n_shards=2,
        bucket=8, att_bucket=8, radius=4.0, mig_budget=8,
        speed=0.0, attack_period=1,
    )
    pos = np.float32([[10.0, 31.0], [10.0, 33.0]])
    hp = np.int32([100, 100])
    atk = np.int32([7, 9])
    camp = np.int32([0, 1])
    world = _world(geom)
    world.place(pos, hp, atk, camp)
    st = world.state
    owners = {int(st.gid[r]) for r in np.flatnonzero(st.active.numpy())
              if r < world.bank_size}
    assert owners == {0}, "gid 0 should live on shard 0"
    world.step(3)
    got = world.gather()
    assert got[0][2] == 100 - 3 * 9, got  # hit by gid 1 across the halo
    assert got[1][2] == 100 - 3 * 7, got
    assert world.stats_last[:, 1:].sum() == 0
    ref = _jax_twin(geom)
    ref.place(pos, hp, atk, camp)
    ref.step(3)
    assert ref.gather() == got


def test_spatial_migration_budget_overflow_counts():
    """A starved budget counts its overflow, keeps every row, and alerts."""
    geom, pos, hp, atk, camp = _mk_world(n=800, mig_budget=1, speed=2.0)
    world = _world(geom)
    world.place(pos, hp, atk, camp)
    overflow_seen = 0
    for _ in range(10):
        world.step()
        overflow_seen += int(world.stats_last[:, 1].sum())
    assert len(world.gather()) == 800
    assert overflow_seen > 0, "budget of 1 should have overflowed"
    assert world.overflow_alerts > 0, "breach must raise the alert counter"


def _teleport_gid(world, g, xy):
    """Host-side surgery: move gid g's bank row to world position xy."""
    st = world.state
    act = np.asarray(st.active)
    gids = np.asarray(st.gid)
    r = next(int(i) for i in np.flatnonzero(act) if int(gids[i]) == g)
    newpos = np.asarray(st.pos).copy()
    newpos[r] = xy
    world.state = st._replace(pos=newpos)


def _jax_teleport(world, g, xy):
    import jax
    import jax.numpy as jnp

    st = world.state
    act = np.asarray(st.active)
    gids = np.asarray(st.gid)
    r = next(int(i) for i in np.flatnonzero(act) if int(gids[i]) == g)
    newpos = np.asarray(st.pos).copy()
    newpos[r] = xy
    world.state = st._replace(pos=jax.device_put(jnp.asarray(newpos), st.pos.sharding))


def test_spatial_bank_full_row_retries_never_destroyed():
    """A migrant whose destination bank is full STAYS HOME and retries
    (the sender clamps to the advertised free slots): dropped stays 0,
    and every step's stats equal the JAX package's."""
    geom = SpatialGeom(
        extent=64.0, cell_size=4.0, width=16, n_shards=2,
        bucket=64, att_bucket=8, radius=4.0, mig_budget=64,
        speed=0.0, attack_period=97,
    )
    rng = np.random.default_rng(0)
    pos = np.vstack([
        rng.uniform([1, 1], [62, 30], (2, 2)),    # slab 0
        rng.uniform([1, 33], [62, 62], (8, 2)),   # slab 1: fills bank 1
    ]).astype(np.float32)
    hp = np.full(10, 100, np.int32)
    atk = np.full(10, 5, np.int32)
    camp = (np.arange(10) % 2).astype(np.int32)
    world = _world(geom, bank_size=8)
    world.place(pos, hp, atk, camp)
    ref = _jax_twin(geom, bank_size=8)
    ref.place(pos, hp, atk, camp)

    def teleport(g, xy):
        _teleport_gid(world, g, xy)
        _jax_teleport(ref, g, xy)

    teleport(0, [10.0, 50.0])  # wants slab 1 (full)
    world.step()
    ref.step()
    np.testing.assert_array_equal(world.stats_last, ref.stats_last)
    assert world.stats_last[:, 2].sum() == 0, world.stats_last
    assert world.stats_last[:, 1].sum() == 1, world.stats_last
    assert world.stats_last[:, 3].sum() == 1, world.stats_last
    assert len(world.gather()) == 10
    teleport(2, [10.0, 10.0])
    world.step()   # gid 2 migrates down; gid 0 still blocked this tick
    ref.step()
    np.testing.assert_array_equal(world.stats_last, ref.stats_last)
    assert world.stats_last[:, 0].sum() == 1, world.stats_last
    assert world.stats_last[:, 2].sum() == 0, world.stats_last
    world.step()   # the retry lands in the freed slot
    ref.step()
    np.testing.assert_array_equal(world.stats_last, ref.stats_last)
    assert world.stats_last[:, 0].sum() == 1, world.stats_last
    assert world.stats_last[:, 1:4].sum() == 0, world.stats_last
    got = world.gather()
    assert len(got) == 10 and got == ref.gather()
    assert got[0][:2] == (10.0, 50.0), got[0]


def test_spatial_stranded_row_hops_home():
    """A row teleported 3 slabs from its owner hops one slab per tick and
    then fights; the hops equal the JAX package's."""
    geom = SpatialGeom(
        extent=64.0, cell_size=4.0, width=16, n_shards=4,
        bucket=8, att_bucket=8, radius=4.0, mig_budget=8,
        speed=0.0, attack_period=1,
    )
    pos = np.float32([[10.0, 2.0], [10.0, 60.0], [20.0, 2.0]])
    hp = np.int32([100, 100, 100])
    atk = np.int32([5, 5, 5])
    camp = np.int32([0, 1, 0])
    world = _world(geom)
    world.place(pos, hp, atk, camp)
    ref = _jax_twin(geom)
    ref.place(pos, hp, atk, camp)
    _teleport_gid(world, 0, [10.0, 58.0])  # slab 3, within radius of gid 1
    _jax_teleport(ref, 0, [10.0, 58.0])
    hops, ref_hops = [], []
    for _ in range(4):
        world.step()
        ref.step()
        hops.append(int(world.stats_last[:, 0].sum()))
        ref_hops.append(int(ref.stats_last[:, 0].sum()))
    assert hops[:3] == [1, 1, 1] and hops[3] == 0, hops
    assert hops == ref_hops
    got = world.gather()
    assert len(got) == 3
    assert got[0][2] < 100 and got[1][2] < 100, got
    assert got[2][2] == 100
    assert got == ref.gather()


def test_spatial_checkpoint_resume_continues_exactly(tmp_path):
    """save -> load -> keep ticking reproduces the unbroken trajectory."""
    geom, pos, hp, atk, camp = _mk_world(n=500)
    w1 = _world(geom)
    w1.place(pos, hp, atk, camp)
    w1.step(5)
    ckpt = str(tmp_path / "spatial.npz")
    w1.save(ckpt)
    w1.step(6)
    expect = w1.gather()
    w2 = _world(geom)
    w2.load(ckpt)
    assert w2.tick_count == 5
    w2.step(6)
    assert w2.gather() == expect


def test_spatial_snapshot_loads_across_packages(tmp_path):
    """The npz layout is the JAX package's: a still world saved by either
    package resumes in the other on the same trajectory."""
    geom, pos, hp, atk, camp = _mk_world(n=400, speed=0.0)
    w = _world(geom)
    w.place(pos, hp, atk, camp)
    w.step(3)
    j = _jax_twin(geom)
    j.place(pos, hp, atk, camp)
    j.step(3)
    w.save(str(tmp_path / "port.npz"))
    j.save(str(tmp_path / "jax.npz"))
    a, b = _world(geom), _jax_twin(geom)
    a.load(str(tmp_path / "jax.npz"))
    b.load(str(tmp_path / "port.npz"))
    a.step(3)
    b.step(3)
    assert a.gather() == b.gather()


def test_spatial_speed_zero_is_migration_free():
    geom, pos, hp, atk, camp = _mk_world(n=300, speed=0.0)
    world = _world(geom)
    world.place(pos, hp, atk, camp)
    ref = _jax_twin(geom)
    ref.place(pos, hp, atk, camp)
    for _ in range(5):
        world.step()
        ref.step()
        assert world.stats_last[:, 0].sum() == 0
        np.testing.assert_array_equal(world.stats_last, ref.stats_last)
    assert world.gather() == ref.gather()


def _life_cycle(ticks, hp_max, respawn):
    geom, pos, hp, atk, camp = _mk_world(
        n=600, speed=1.0, attack_period=2,
        regen_per_tick=1, hp_max=hp_max, respawn_ticks=respawn,
    )
    hp = np.full_like(hp, hp_max)
    world = _world(geom)
    world.place(pos, hp, atk, camp)
    for _ in range(ticks):
        world.step()
        assert world.stats_last[:, 1:].sum() == 0, world.stats_last
    _ref_pos, ref_hp = _run_reference(geom, pos, hp, atk, camp, ticks)
    got = world.gather()
    mismatch = [g for g, (_, _, h) in got.items() if h != int(ref_hp[g])]
    assert not mismatch, mismatch[:5]
    assert sum(1 for _, (_, _, h) in got.items() if h == 0) > 0, "nothing died"
    st = world.state
    revived = ((st.died == -1) & (st.hp == hp_max) & st.active).sum()
    assert int(revived) > 0


def test_spatial_life_cycle_parity():
    """Combat + regen + death + respawn while migrating: rows die and
    revive, HP parity-exact with the oracle (a short, lethal cut of the
    JAX test's 60 ticks at HP 60)."""
    _life_cycle(TICKS, hp_max=20, respawn=3)


@pytest.mark.slow
def test_spatial_life_cycle_parity_60_ticks():
    _life_cycle(60, hp_max=60, respawn=5)


@pytest.mark.slow
def test_spatial_soak_conserves_entities():
    """120 ticks of fast movement: every gid exists exactly once and HP
    stays parity-exact with the oracle."""
    geom, pos, hp, atk, camp = _mk_world(n=900, speed=1.5, mig_budget=256,
                                         bucket=48, att_bucket=48)
    world = _world(geom)
    world.place(pos, hp, atk, camp)
    migrated = 0
    for _ in range(120):
        world.step()
        migrated += int(world.stats_last[:, 0].sum())
        assert world.stats_last[:, 1:].sum() == 0, world.stats_last
    st = world.state
    gids = st.gid[st.active]
    assert len(gids) == 900 and len(torch.unique(gids)) == 900
    assert migrated > 120, migrated
    _ref_pos, ref_hp = _run_reference(geom, pos, hp, atk, camp, 120)
    got = world.gather()
    assert not [g for g, (_, _, h) in got.items() if h != int(ref_hp[g])]


def test_spatial_single_shard_degenerate():
    """n_shards=1: self-permutes, halos masked to zero: combat lands and
    nothing migrates or overflows; the many-shard world gives the same
    HP (placement invariance)."""
    geom = SpatialGeom(
        extent=64.0, cell_size=4.0, width=16, n_shards=1,
        bucket=16, att_bucket=16, radius=4.0, mig_budget=8,
        speed=1.0, attack_period=2,
    )
    rng = np.random.default_rng(1)
    n = 300
    args = (rng.uniform(1, 63, (n, 2)).astype(np.float32), np.full(n, 100, np.int32),
            np.full(n, 7, np.int32), (np.arange(n) % 2).astype(np.int32))
    world = _world(geom)
    world.place(*args)
    world.step(10)
    got = world.gather()
    assert len(got) == n
    assert sum(1 for _, (_, _, h) in got.items() if h < 100) > n // 2
    assert world.stats_last.sum() == 0
    wide = _world(geom._replace(n_shards=4, mig_budget=64))
    wide.place(*args)
    wide.step(10)
    assert wide.gather() == got


def test_spatial_auto_resize_stops_bucket_drops():
    """A pile-up with bucket 1 breaches the budget; both buckets double
    (bounded) and the drops stop."""
    geom = SpatialGeom(
        extent=128.0, cell_size=16.0, width=8, n_shards=2,
        bucket=1, att_bucket=1, radius=4.0, mig_budget=64,
        speed=0.0, attack_period=1,
    )
    n = 64
    rng = np.random.default_rng(21)
    pos = rng.uniform(33.0, 40.0, (n, 2)).astype(np.float32)
    hp = np.full(n, 100000, np.int32)
    atk = np.ones(n, np.int32)
    camp = (np.arange(n) % 2).astype(np.int32)
    world = _world(geom)
    world.max_bucket_boost = 256
    world.place(pos, hp, atk, camp)
    for _ in range(TICKS):
        world.step()
        if world.geom.bucket >= n:
            break
    assert world._bucket_boost > 1, "budget breach never resized"
    assert world.geom.bucket >= n and world.geom.att_bucket >= n
    assert world.overflow_alerts >= 1
    world.step()
    world.step()
    assert world.stats_last[:, 4:].sum() == 0, world.stats_last


def test_spatial_auto_resize_disabled_keeps_geometry():
    geom = SpatialGeom(
        extent=128.0, cell_size=16.0, width=8, n_shards=2,
        bucket=1, att_bucket=1, radius=4.0, mig_budget=64,
        speed=0.0, attack_period=1,
    )
    n = 32
    pos = np.random.default_rng(22).uniform(33.0, 40.0, (n, 2)).astype(np.float32)
    world = _world(geom)
    world.auto_resize = False
    args = (pos, np.full(n, 10000, np.int32), np.ones(n, np.int32),
            (np.arange(n) % 2).astype(np.int32))
    world.place(*args)
    ref = _jax_twin(geom)
    ref.auto_resize = False
    ref.place(*args)
    for _ in range(4):
        world.step()
        ref.step()
        np.testing.assert_array_equal(world.stats_last, ref.stats_last)
    assert world.geom.bucket == 1 and world._bucket_boost == 1
    assert world.stats_last[:, 4:].sum() > 0  # drops persist, by choice
    assert world.gather() == ref.gather()


def test_spatial_binning_count_bit_parity(monkeypatch):
    """The slab shards' table build through NF_BINNING=count: the sort
    engine's positions and HP, tick for tick."""
    geom, pos, hp, atk, camp = _mk_world(n=600, seed=8, n_shards=2, mig_budget=256)
    results = {}
    for mode in ("sort", "count"):
        if mode == "sort":
            monkeypatch.delenv("NF_BINNING", raising=False)
        else:
            monkeypatch.setenv("NF_BINNING", mode)
        world = _world(geom)
        world.place(pos, hp, atk, camp)
        world.step(TICKS)
        results[mode] = world.gather()
    assert results["sort"] == results["count"]


def test_spatial_snapshot_cross_engine_drops_verlet_cache(tmp_path, monkeypatch):
    """A snapshot saved under one NF_BINNING engine loads under the other
    with its Verlet cache zeroed, and the resumed trajectory equals an
    unbroken run; a same-engine load keeps the cache."""
    geom, pos, hp, atk, camp = _mk_world(n=400, seed=12, n_shards=2, cell_size=8.0,
                                         width=16, radius=4.0, speed=0.1, skin=4.0)
    monkeypatch.delenv("NF_BINNING", raising=False)
    world = _world(geom)
    world.place(pos, hp, atk, camp)
    world.step(6)
    p = str(tmp_path / "snap.npz")
    world.save(p)
    world.step(6)
    ref = world.gather()
    assert world.rebuilds_total >= 1

    monkeypatch.setenv("NF_BINNING", "count")
    w2 = _world(geom)
    w2.load(p)
    assert not bool(w2.state.vc_active.any())
    w2.step(6)
    assert w2.gather() == ref

    monkeypatch.delenv("NF_BINNING", raising=False)
    w3 = _world(geom)
    w3.load(p)
    assert bool(w3.state.vc_active.any())
