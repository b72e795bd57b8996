"""The port's spatial ops (ops/aoi.py, ops/interest.py, ops/geometry.py)
against the JAX package on the CPU, on three seeds: the grid build, its
overflow count, the 3x3 candidates, neighbor_mask, neighbor_counts under a
partition key, gather_reduce, quantize at its edges, and both
visible_candidates forms (fresh and Verlet-cached over a moving
population).  The AOI and interest functions run in the JAX package as
its callers run them, compiled (``jax.jit``); neighbor_counts also eager.
Tolerance 0 on every integer, mask and row (the rows where ``ok``), and on
every float32 of geometry.  The one exception, stated: gather_reduce of
float32 values sums in a different order from XLA's and is held to
1e-6 relative."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from noahgameframe_tpu.ops import aoi as ja
from noahgameframe_tpu.ops import geometry as jg
from noahgameframe_tpu.ops import interest as ji
from noahgameframe_tpu.ops.verlet import init_cache as jinit
from noahgameframe_tpu_torch.ops import aoi as ta
from noahgameframe_tpu_torch.ops import geometry as tg
from noahgameframe_tpu_torch.ops import interest as ti
from noahgameframe_tpu_torch.ops.verlet import init_cache as tinit
from test_torch_parity import one_intra_op_thread  # noqa: F401

SEEDS = [0, 1, 2]
EXTENT, CELL, WIDTH, BUCKET, RADIUS = 60.0, 4.0, 15, 12, 4.0


def T(x):
    return torch.from_numpy(np.array(x))


def _world(seed, n=3000):
    """Positions (a third on a quarter-unit lattice, so distances land
    exactly on the radius), an active mask and a scene*1024+group key."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, EXTENT, (n, 3)).astype(np.float32)
    pos[: n // 3, :2] = np.round(pos[: n // 3, :2] * 4) / 4
    active = rng.random(n) < 0.9
    part = (rng.integers(0, 3, n) * 1024 + rng.integers(0, 2, n)).astype(np.int32)
    return rng, pos, active, part


@pytest.mark.parametrize("seed", SEEDS)
def test_grid_candidates_and_mask_match_jax(seed):
    rng, pos, active, part = _world(seed)
    g = ja.build_grid(jnp.asarray(pos), jnp.asarray(active), CELL, WIDTH, BUCKET)
    tgr = ta.build_grid(T(pos), T(active), CELL, WIDTH, BUCKET)
    assert np.array_equal(np.asarray(g.slots), tgr.slots.numpy())
    assert np.array_equal(np.asarray(g.counts), tgr.counts.numpy())
    assert int(ja.grid_overflow(g)) == int(ta.grid_overflow(tgr)) > 0
    cells = ja.cell_of(jnp.asarray(pos[:500]), CELL, WIDTH)
    assert np.array_equal(np.asarray(cells), ta.cell_of(T(pos[:500]), CELL, WIDTH).numpy())
    cand = ja.neighbor_candidates(cells, g)
    tcand = ta.neighbor_candidates(T(np.asarray(cells)), tgr)
    assert np.array_equal(np.asarray(cand), tcand.numpy())
    qpos = pos[:500] + rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    args = (pos, qpos, np.asarray(cand), part, part[:500], np.arange(500, dtype=np.int32))
    mask = jax.jit(lambda p, q, c, pt, qpt, ex: ja.neighbor_mask(p, q, c, RADIUS, pt, qpt, ex))(
        *map(jnp.asarray, args))
    tmask = ta.neighbor_mask(*map(T, args[:3]), RADIUS, *map(T, args[3:]))
    assert np.array_equal(np.asarray(mask), tmask.numpy()) and tmask.any()
    plain = jax.jit(lambda p, q, c: ja.neighbor_mask(p, q, c, RADIUS))(*map(jnp.asarray, args[:3]))
    assert np.array_equal(np.asarray(plain), ta.neighbor_mask(*map(T, args[:3]), RADIUS).numpy())
    ints = rng.integers(0, 50, len(pos)).astype(np.int32)
    floats = rng.uniform(0, 3, len(pos)).astype(np.float32)
    red = jax.jit(ja.gather_reduce)
    got = ta.gather_reduce(T(ints), tcand, tmask)
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(red(jnp.asarray(ints), cand, mask)), got.numpy())
    np.testing.assert_allclose(ta.gather_reduce(T(floats), tcand, tmask).numpy(),
                               np.asarray(red(jnp.asarray(floats), cand, mask)), rtol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_neighbor_counts_match_jax(seed):
    _, pos, active, part = _world(seed)
    fn = lambda p, a, pt: ja.neighbor_counts(p, a, RADIUS, CELL, WIDTH, BUCKET, pt)  # noqa: E731
    args = tuple(map(jnp.asarray, (pos, active, part)))
    got = ta.neighbor_counts(T(pos), T(active), RADIUS, CELL, WIDTH, BUCKET, T(part))
    assert got.dtype == torch.int32 and int(got.sum()) > 0
    assert np.array_equal(np.asarray(jax.jit(fn)(*args)), got.numpy())
    assert np.array_equal(np.asarray(fn(*args)), got.numpy())
    nopart = jax.jit(lambda p, a: ja.neighbor_counts(p, a, RADIUS, CELL, WIDTH, 64))
    assert np.array_equal(np.asarray(nopart(*args[:2])),
                          ta.neighbor_counts(T(pos), T(active), RADIUS, CELL, WIDTH, 64).numpy())


def test_quantize_edges_match_jax():
    """0, the extent itself, just outside it on both sides, a half-quantum
    tie, two-column positions, and dead rows."""
    q = EXTENT / 65535
    pos = np.array([[0, 0, 0], [EXTENT, EXTENT, 1], [EXTENT + 1e-3, 3, 0], [-1e-6, 2, 0],
                    [EXTENT / 2, q * 0.5, 0], [q * 2.5, q * 3.5, -0.5], [7, 8, 9e5],
                    [np.nextafter(np.float32(EXTENT), np.float32(0)), 1, 0]], np.float32)
    alive = np.array([1, 1, 1, 1, 1, 1, 0, 1], bool)
    for p in (pos, pos[:, :2]):
        for fn in (ji.quantize, jax.jit(ji.quantize, static_argnums=2)):
            qa, ea = fn(jnp.asarray(p), jnp.asarray(alive), EXTENT)
            qb, eb = ti.quantize(T(p), T(alive), EXTENT)
            assert np.array_equal(np.asarray(qa), qb.numpy()) and qb.dtype == torch.int32
            assert np.array_equal(np.asarray(ea), eb.numpy())
    assert eb.numpy().tolist() == [True, True, False, False, True, True, False, True]


def _observers(rng, part, s=200):
    obs = rng.uniform(-2, EXTENT + 2, (s, 2)).astype(np.float32)
    return (obs, rng.integers(0, 3, s).astype(np.float32), rng.integers(0, 2, s).astype(np.float32),
            (part // 1024).astype(np.float32), (part % 1024).astype(np.float32))


def _same(res, tres):
    ok = np.asarray(res.ok)
    assert np.array_equal(ok, tres.ok.numpy()) and ok.sum() > 0
    assert np.array_equal(np.where(ok, np.asarray(res.rows), 0),
                          np.where(ok, tres.rows.numpy(), 0))


@pytest.mark.parametrize("seed", SEEDS)
def test_visible_candidates_match_jax(seed):
    rng, pos, _, part = _world(seed)
    obs, osc, ogr, sc, gr = _observers(rng, part)
    moved = rng.random(len(pos)) < 0.5
    fn = jax.jit(lambda *a: ji.visible_candidates(*a, 8.0, 8.0, 8, 40))
    args = (pos, moved, sc, gr, obs, osc, ogr)
    _same(fn(*map(jnp.asarray, args)), ti.visible_candidates(*map(T, args), 8.0, 8.0, 8, 40))


@pytest.mark.parametrize("seed", SEEDS)
def test_visible_candidates_cached_match_jax(seed):
    """Five frames of a drifting population through each package's Verlet
    cache: equal results and equal rebuild flags (a rebuild on the first
    frame and again once the drift passes skin/2)."""
    rng, pos, active, part = _world(seed)
    obs, osc, ogr, sc, gr = _observers(rng, part)
    fn = jax.jit(lambda c, *a: ji.visible_candidates_cached(c, *a, 8.0, 10.0, 6, 60, 2.0))
    jc, tc = jinit(len(pos)), tinit(len(pos), "cpu")
    rebuilt = []
    for step in range(5):
        p = pos.copy()
        p[:, :2] += step * 0.4
        moved = rng.random(len(pos)) < 0.5
        args = (p, moved, active, sc, gr, obs, osc, ogr)
        res, jc, jr = fn(jc, *map(jnp.asarray, args))
        tres, tc, tr = ti.visible_candidates_cached(tc, *map(T, args), 8.0, 10.0, 6, 60, 2.0)
        _same(res, tres)
        assert int(jr) == int(tr)
        rebuilt.append(int(tr))
    assert rebuilt[0] == 1 and sum(rebuilt) >= 2


def _geometry_inputs(seed, n=4000):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.uniform(-5, 5, s).astype(np.float32)  # noqa: E731
    o, d, c, lo = r(n, 3), r(n, 3), r(n, 3), r(n, 3)
    d[:40] = 0.0  # degenerate rays
    return o, d, c, lo, lo + np.abs(r(n, 3)), np.abs(r(n))


GEOMETRY = {
    "dot": lambda m, o, d, c, lo, hi, r: m.dot(o, d),
    "length": lambda m, o, d, c, lo, hi, r: m.length(o),
    "normalize": lambda m, o, d, c, lo, hi, r: m.normalize(d),
    "distance": lambda m, o, d, c, lo, hi, r: m.distance(o[:, :2], c[:, :2]),
    "lerp": lambda m, o, d, c, lo, hi, r: m.lerp(o, d, r),
    "cross": lambda m, o, d, c, lo, hi, r: m.cross(o, d),
    "ray_point": lambda m, o, d, c, lo, hi, r: m.ray_point(o, d, r),
    "ray_sphere": lambda m, o, d, c, lo, hi, r: m.ray_sphere(o, d, c, r),
    "ray_sphere_scalar": lambda m, o, d, c, lo, hi, r: m.ray_sphere(o, d, c, 1.5),
    "ray_plane": lambda m, o, d, c, lo, hi, r: m.ray_plane(o, d, c, r),
    "ray_aabb": lambda m, o, d, c, lo, hi, r: m.ray_aabb(o, d, lo, hi),
    "point_in_aabb": lambda m, o, d, c, lo, hi, r: m.point_in_aabb(o, lo, hi),
    "sphere_overlap": lambda m, o, d, c, lo, hi, r: m.sphere_overlap(o, r, c, r),
    "segment_point_distance": lambda m, o, d, c, lo, hi, r: m.segment_point_distance(o, d, c),
}


@pytest.mark.parametrize("seed", SEEDS)
def test_geometry_matches_jax(seed):
    """Every helper against the JAX function called op by op (as its
    tests call it), bit for bit, misses (inf) included."""
    inputs = _geometry_inputs(seed)
    for name, fn in GEOMETRY.items():
        want = np.asarray(fn(jg, *map(jnp.asarray, inputs)))
        got = fn(tg, *map(T, inputs)).numpy()
        assert got.dtype == want.dtype, name
        assert np.array_equal(want, got, equal_nan=True), name
