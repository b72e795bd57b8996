"""The port's world tick (noahgameframe_tpu_torch) against the JAX package
on the CPU: the same seeded benchmark world, ticked in both, gives equal
per-tick state_digest streams and counter banks under every combat
engine, and equal banks at the end.  The port's import hygiene, its
device default and its default world are in test_torch_world_defaults.py."""

import pytest

from noahgameframe_tpu.game.world import build_benchmark_world as jax_world
from noahgameframe_tpu_torch.core.store import state_to_numpy
from noahgameframe_tpu_torch.game.world import build_benchmark_world as torch_world
from test_torch_parity import assert_tree_equal, jax_tree
from test_torch_parity import one_intra_op_thread  # noqa: F401


def _worlds(n, seed, engine):
    a = jax_world(n, seed=seed)
    b = torch_world(n, seed=seed, device="cpu")
    for w in (a, b):
        w.combat.use_pallas = engine
        w.kernel.enable_digest()
    return a, b


def _tick_both(a, b, ticks):
    """Tick both worlds, asserting equal counter banks (digest included)
    after every tick; returns the port's counter stream."""
    stream = []
    for t in range(ticks):
        a.tick()
        got = b.tick().counters
        assert got == a.kernel.last_counters, f"tick {t}"
        stream.append(got)
    return stream


def test_engine0_digest_stream_2000_npcs():
    """60 ticks at 2000 NPCs: movement, staggered AoE combat with the
    overflow auto-resize, regen and the stat recompute stay bit-exact."""
    a, b = _worlds(2000, seed=3, engine=0)
    stream = _tick_both(a, b, 60)
    assert sum(c["combat_hits"] for c in stream) > 0
    assert_tree_equal(jax_tree(a.kernel.state), state_to_numpy(b.kernel.state))


@pytest.mark.parametrize("engine", [1, 2])
def test_kernel_engines_digest_stream_200_npcs(engine):
    """Engines 1 and 2 (the JAX package runs its Pallas kernels in
    interpret mode; the port runs the kernels' plain versions on CPU)."""
    a, b = _worlds(200, seed=3, engine=engine)
    stream = _tick_both(a, b, 24)
    assert ("aoi_interest_pairs" in stream[-1]) == (engine == 2)
    assert_tree_equal(jax_tree(a.kernel.state), state_to_numpy(b.kernel.state))


def test_run_device_end_digest():
    """run_device(n) (no per-tick observation) lands on the same state
    as the JAX package's fused run loop."""
    a, b = _worlds(200, seed=5, engine=0)
    a.kernel.run_device(12)
    b.kernel.run_device(12)
    a.kernel.tick()
    got = b.kernel.tick().counters
    assert got["tick"] == 13
    assert got["state_digest"] == a.kernel.last_counters["state_digest"]


def test_arm_all_rearm_invalidates_like_jax(monkeypatch):
    """A re-arm that changes the attack duty (``arm_all(stagger=False)``
    after the staggered seeding) invalidates the kernel in both packages:
    the Verlet aux is dropped and rebuilt, so the counter banks (the
    grid rebuild/reuse counts and the cache age among them), the aux
    entries and the digests stay equal on every tick.  Tolerance 0."""
    monkeypatch.setenv("NF_VERLET_SKIN", "2.0")
    monkeypatch.setenv("NF_PALLAS", "0")
    a = jax_world(512, seed=4)
    b = torch_world(512, seed=4, device="cpu")
    for w in (a, b):
        w.kernel.enable_digest()
    _tick_both(a, b, 5)
    assert set(b.kernel.state.aux) == set(a.kernel.state.aux) == {"verlet/NPC"}
    gen = b.kernel.costbook.generation
    for w in (a, b):
        w.combat.arm_all(stagger=False)
    assert set(b.kernel.state.aux) == set(a.kernel.state.aux) == set()
    assert b.kernel.costbook.generation == gen + 1
    for t in range(5):
        a.tick()
        got = b.tick().counters
        assert got == a.kernel.last_counters, f"tick {t} after the re-arm"
        assert set(b.kernel.state.aux) == set(a.kernel.state.aux), t
    assert got["grid_cache_age"] == a.kernel.last_counters["grid_cache_age"]
    assert_tree_equal(jax_tree(a.kernel.state), state_to_numpy(b.kernel.state))
