"""The port's entity store (noahgameframe_tpu_torch/core/store.py) and
state digest against the JAX package: seeded banks, digests of random
banks, and the numpy carry-over of a world between the two packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from noahgameframe_tpu.core import store as jstore
from noahgameframe_tpu.game.world import build_benchmark_world as jax_world
from noahgameframe_tpu.kernel.kernel import state_digest as jax_digest
from noahgameframe_tpu_torch.core.store import state_from_numpy, state_to_numpy
from noahgameframe_tpu_torch.game.world import build_benchmark_world as torch_world
from noahgameframe_tpu_torch.kernel.kernel import state_digest as torch_digest
from test_torch_parity import assert_tree_equal, jax_tree
from test_torch_parity import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("seed", [0, 5])
def test_seeded_world_banks_equal(seed):
    """create_many + record_write_rows + the staggered timer arming of
    seed_npcs give the same banks, array by array."""
    a = jax_world(300, seed=seed)
    b = torch_world(300, seed=seed, device="cpu")
    assert a.kernel.store.class_order == b.kernel.store.class_order
    assert_tree_equal(jax_tree(a.kernel.state), state_to_numpy(b.kernel.state))
    assert a.combat.resolved_bucket(512) == b.combat.resolved_bucket(512)
    assert a.combat.resolved_att_bucket(512) == b.combat.resolved_att_bucket(512)


def _random_tree(rng) -> dict:
    def cls(cap, n_i, n_f, n_v, n_t, recs):
        return {
            "i32": rng.integers(-2**31, 2**31, (cap, n_i), dtype=np.int64).astype(np.int32),
            "f32": rng.standard_normal((cap, n_f)).astype(np.float32),
            "vec": rng.uniform(-1e3, 1e3, (cap, n_v, 3)).astype(np.float32),
            "alive": rng.random(cap) < 0.5,
            "timers": {
                "next_fire": rng.integers(0, 1000, (cap, n_t)).astype(np.int32),
                "interval": rng.integers(1, 60, (cap, n_t)).astype(np.int32),
                "remain": rng.integers(-1, 5, (cap, n_t)).astype(np.int32),
                "active": rng.random((cap, n_t)) < 0.5,
            },
            "records": {
                r: {"i32": rng.integers(-9, 9, (cap, rows, n)).astype(np.int32),
                    "f32": np.zeros((cap, rows, 0), np.float32),
                    "vec": np.zeros((cap, rows, 0, 3), np.float32),
                    "used": rng.random((cap, rows)) < 0.3}
                for r, rows, n in recs
            },
        }

    return {
        "tick": np.int32(rng.integers(0, 10_000)),
        "rng": rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32),
        "classes": {
            "Zeta": cls(64, 5, 1, 2, 1, [("B", 4, 2), ("A", 9, 29)]),
            "Alpha": cls(33, 0, 0, 1, 0, []),
            "NPC": cls(257, 47, 1, 2, 2, [("CommPropertyValue", 9, 29)]),
        },
    }


def _jax_state(tree):
    def cls(d):
        return jstore.ClassState(
            i32=jnp.asarray(d["i32"]), f32=jnp.asarray(d["f32"]),
            vec=jnp.asarray(d["vec"]), alive=jnp.asarray(d["alive"]),
            timers=jstore.TimerState(**{k: jnp.asarray(v) for k, v in d["timers"].items()}),
            records={r: jstore.RecordState(**{k: jnp.asarray(v) for k, v in rd.items()})
                     for r, rd in d["records"].items()},
        )

    return jstore.WorldState(
        classes={c: cls(d) for c, d in tree["classes"].items()},
        tick=jnp.asarray(tree["tick"]), rng=jnp.asarray(tree["rng"]))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_state_digest_equal_on_random_banks(seed):
    tree = _random_tree(np.random.default_rng(seed))
    order = ["NPC", "Zeta", "Alpha"]
    want = int(jax.jit(lambda st: jax_digest(st, order))(_jax_state(tree)))
    got = int(torch_digest(state_from_numpy(tree, "cpu"), order))
    assert got == want


def test_numpy_carry_over_round_trips_a_jax_world():
    """state_from_numpy / state_to_numpy take a JAX world's leaves and
    give them back unchanged, and the digest survives the trip."""
    w = jax_world(200, seed=2)
    tree = jax_tree(w.kernel.state)
    state = state_from_numpy(tree, "cpu")
    assert_tree_equal(tree, state_to_numpy(state))
    order = w.kernel.store.class_order
    want = jax.jit(lambda st: jax_digest(st, order))(w.kernel.state)
    assert int(torch_digest(state, order)) == int(want)
