"""The port's Verlet cache (noahgameframe_tpu_torch/ops/verlet.py) against
the JAX package's: the rebuild trigger at exactly skin/2, arrival against
departure, dead rows, the refresh counters, cached tables against
build_cell_table_pair; a 120-tick world with skin 2.0 under both binnings and
engines 0 and 2 gives JAX's digest and counter stream (grid_rebuilds and
grid_reuses included); and an overflow resize drops and re-primes the
cache as JAX's does.  Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noahgameframe_tpu.game.world import build_benchmark_world as jax_world
from noahgameframe_tpu.ops import verlet as jv
from noahgameframe_tpu.ops.stencil import build_cell_table_pair as jax_pair
from noahgameframe_tpu_torch.game.world import build_benchmark_world as torch_world
from noahgameframe_tpu_torch.ops import verlet as tv
from noahgameframe_tpu_torch.ops.stencil import build_cell_table_pair


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _anchored(pos, active, cell=4.0, width=8, bucket=8, skin=1.0):
    cache, rebuilt = tv.refresh(tv.init_cache(pos.shape[0], "cpu"), _t(pos), _t(active), cell,
                                width, bucket, skin)
    assert int(rebuilt) == 1  # a fresh cache always builds
    return cache


def _both_need(cache_pos, cache_active, pos, active, skin):
    """need_rebuild in the port and in JAX for the same anchor and move."""
    tc = _anchored(cache_pos, cache_active, skin=skin)
    jc, _ = jv.refresh(jv.init_cache(len(cache_pos)), jnp.asarray(cache_pos),
                       jnp.asarray(cache_active), 4.0, 8, 8, skin)
    got = bool(tv.need_rebuild(tc, _t(pos), _t(active), skin))
    assert got == bool(jv.need_rebuild(jc, jnp.asarray(pos), jnp.asarray(active), skin))
    return got


POS = np.array([[4.0, 4.0], [20.0, 20.0]], np.float32)
ALL = np.ones(2, bool)


def test_rebuild_boundary_exact_half_skin():
    """2 * displacement == skin rebuilds; just under reuses; euclidean,
    not per axis."""
    moved = POS.copy()
    moved[0, 0] += 0.5
    assert _both_need(POS, ALL, moved, ALL, 1.0)
    almost = POS.copy()
    almost[0, 0] += 0.5 - 1e-3
    assert not _both_need(POS, ALL, almost, ALL, 1.0)
    for step, want in ((0.5 + 1e-3, True), (0.5 - 1e-3, False)):
        diag = POS.copy()
        diag[0] += np.float32(step) / np.sqrt(np.float32(2.0))
        assert _both_need(POS, ALL, diag, ALL, 1.0) is want


def test_rebuild_on_arrival_but_not_departure():
    assert not _both_need(POS, ALL, POS, ALL, 1.0)
    assert not _both_need(POS, ALL, POS, np.array([True, False]), 1.0)
    assert _both_need(POS, np.array([True, False]), POS, ALL, 1.0)


def test_dead_rows_do_not_count_displacement():
    active = np.array([True, False])
    moved = POS.copy()
    moved[1] = 500.0
    assert not _both_need(POS, active, moved, active, 1.0)


def test_refresh_counters_and_reuse():
    cache = _anchored(POS, ALL, skin=2.0)
    for age in (1, 2, 3):
        cache, rebuilt = tv.refresh(cache, _t(POS), _t(ALL), 4.0, 8, 8, 2.0)
        assert int(rebuilt) == 0 and int(cache.age) == age
    assert int(cache.rebuilds) == 1 and int(cache.reuses) == 3
    cache, rebuilt = tv.refresh(cache, _t(POS + 1.5), _t(ALL), 4.0, 8, 8, 2.0)
    assert int(rebuilt) == 1 and int(cache.age) == 0 and int(cache.rebuilds) == 2


@pytest.mark.parametrize("mode", ["sort", "count"])
def test_cached_tables_match_pair_tables(monkeypatch, mode):
    """Through a fresh cache, and again on a reuse tick with a new subset,
    full_table/sub_table equal build_cell_table_pair run on the anchor
    positions, and JAX's cached tables."""
    monkeypatch.setenv("NF_BINNING", mode)
    rng = np.random.default_rng(5)
    n, width, cell = 257, 8, 4.0
    pos0 = rng.uniform(1, width * cell - 1, (n, 2)).astype(np.float32)
    active = rng.random(n) < 0.8
    feats = rng.normal(size=(n, 3)).astype(np.float32)
    tc, _ = tv.refresh(tv.init_cache(n, "cpu"), _t(pos0), _t(active), cell, width, 12, 2.0)
    jc, _ = jv.refresh(jv.init_cache(n), jnp.asarray(pos0), jnp.asarray(active), cell,
                       width, 12, 2.0)
    pos1 = pos0 + rng.uniform(-0.4, 0.4, (n, 2)).astype(np.float32)
    tc, rebuilt = tv.refresh(tc, _t(pos1), _t(active), cell, width, 12, 2.0)
    jc, _ = jv.refresh(jc, jnp.asarray(pos1), jnp.asarray(active), cell, width, 12, 2.0)
    assert int(rebuilt) == 0
    for sub_p in (0.3, 0.6):
        sub = (rng.random(n) < sub_p) & active
        sfeats = rng.normal(size=(n, 2)).astype(np.float32)
        ref = build_cell_table_pair(_t(pos0), _t(active), _t(feats), _t(sub), _t(sfeats),
                                    cell, width, 12, 8)
        got = (tv.full_table(tc, _t(feats), _t(active), width * width, cell, width, 12),
               tv.sub_table(tc, _t(sub), _t(sfeats), width * width, cell, width, 8))
        jgot = (jv.full_table(jc, jnp.asarray(feats), jnp.asarray(active), width * width,
                              cell, width, 12),
                jv.sub_table(jc, jnp.asarray(sub), jnp.asarray(sfeats), width * width,
                             cell, width, 8))
        jref = jax_pair(jnp.asarray(pos0), jnp.asarray(active), jnp.asarray(feats),
                        jnp.asarray(sub), jnp.asarray(sfeats), cell, width, 12, 8)
        for g, r, jg, jr in zip(got, ref, jgot, jref):
            for a, b in ((g, r), (g, jg), (g, jr)):
                np.testing.assert_array_equal(np.asarray(a.payload), np.asarray(b.payload))
                np.testing.assert_array_equal(np.asarray(a.slot_of), np.asarray(b.slot_of))
                assert int(a.dropped) == int(b.dropped)
        np.testing.assert_array_equal(
            tv.sub_slots(tc, _t(sub), width * width, 8).numpy(),
            np.asarray(jv.sub_slots(jc, jnp.asarray(sub), width * width, 8)))


@pytest.mark.parametrize("raw,want", [("", 0.0), ("2.5", 2.5), ("banana", 0.0)])
def test_skin_from_env(monkeypatch, raw, want):
    monkeypatch.setenv("NF_VERLET_SKIN", raw)
    assert tv.skin_from_env() == jv.skin_from_env() == want


def test_skin_widens_the_cells_as_jax(monkeypatch):
    monkeypatch.setenv("NF_VERLET_SKIN", "2.0")
    a, b = jax_world(64, seed=1), torch_world(64, seed=1, device="cpu")
    assert (b.combat.verlet_skin, b.combat.cell_size, b.combat.width) == \
        (a.combat.verlet_skin, a.combat.cell_size, a.combat.width) == (2.0, 6.0, 10)


@pytest.fixture(scope="module")
def jax_skin_stream():
    """120 counter banks (digests included) of the JAX world with skin 2.0,
    engine 0 (the JAX package's own tests pin its stream equal under both
    binnings and all engines)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NF_VERLET_SKIN", "2.0")
        mp.setenv("NF_PALLAS", "0")
        mp.delenv("NF_BINNING", raising=False)
        w = jax_world(512, seed=4)
        w.kernel.enable_digest()
        stream = []
        for _ in range(120):
            w.tick()
            stream.append(dict(w.kernel.last_counters))
    return stream


@pytest.mark.parametrize("mode,engine", [("sort", 0), ("count", 2)])
def test_skin_world_120_ticks_equal_jax(monkeypatch, jax_skin_stream, mode, engine):
    """The port with skin 2.0 under each binning (engine 0 with the sort
    engine, the fused engine 2 with the counting one) gives the JAX stream
    tick by tick, grid_rebuilds and grid_reuses included (engine 2's AOI
    counter aside, which the JAX run at engine 0 does not make)."""
    ref = jax_skin_stream
    monkeypatch.setenv("NF_VERLET_SKIN", "2.0")
    monkeypatch.setenv("NF_BINNING", mode)
    w = torch_world(512, seed=4, device="cpu")
    w.combat.use_pallas = engine
    w.kernel.enable_digest()
    for t, want in enumerate(ref):
        got = dict(w.tick().counters)
        assert ("aoi_interest_pairs" in got) == (engine == 2)
        got.pop("aoi_interest_pairs", None)
        assert got == want, f"tick {t}"
    assert sum(c["grid_reuses"] for c in ref) > 0 and sum(c["grid_rebuilds"] for c in ref) > 1


def test_overflow_resize_drops_and_reprimes_the_cache(monkeypatch):
    """A bucket too small for the crowd: the overflow doubles the bucket,
    invalidate() drops the Verlet cache with the captured tick, and the
    next tick re-primes and rebuilds it, in step with the JAX package."""
    from noahgameframe_tpu.game.world import GameWorld as JaxWorld
    from noahgameframe_tpu.game.world import WorldConfig as JaxConfig
    from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig

    kw = dict(npc_capacity=128, extent=24.0, seed=2, aoi_bucket=8, verlet_skin=2.0)
    a = JaxWorld(JaxConfig(middleware=False, **kw)).start()
    b = GameWorld(WorldConfig(middleware=False, **kw), device="cpu").start()
    mark = b.kernel.costbook.mark()
    for w in (a, b):
        w.scene.create_scene(1, width=24.0)
        w.seed_npcs(120, rng=np.random.default_rng(9))
        w.kernel.enable_digest()
    for t in range(6):
        a.tick()
        got = b.tick().counters
        assert got == a.kernel.last_counters, f"tick {t}"
        ja = a.kernel.state.aux.get("verlet/NPC")
        ta = b.kernel.state.aux.get("verlet/NPC")
        assert (ja is None) == (ta is None), f"tick {t}"
        if ta is not None:
            assert int(ta.rebuilds) == int(ja.rebuilds) and int(ta.age) == int(ja.age)
    assert b.combat._bucket_boost > 1
    assert "invalidate" in [g["cause"] for g in b.kernel.costbook.gen_events
                            if g["seq"] >= mark["seq"]]
