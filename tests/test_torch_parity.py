"""The parity harness shared by the port's tests (tests/test_torch_*.py): a
JAX WorldState as the nested numpy dict that noahgameframe_tpu_torch's
``state_to_numpy`` / ``state_from_numpy`` exchange, and a bitwise tree
compare that names the first diverging leaf and index.  Its own tests
check that the compare misses no flipped bit."""

from __future__ import annotations

import numpy as np
import pytest


def jax_tree(state) -> dict:
    """The leaves of a JAX ``WorldState`` as nested numpy dicts."""
    classes = {}
    for cname, cs in state.classes.items():
        t = cs.timers
        classes[cname] = {
            "i32": np.asarray(cs.i32), "f32": np.asarray(cs.f32),
            "vec": np.asarray(cs.vec), "alive": np.asarray(cs.alive),
            "timers": {"next_fire": np.asarray(t.next_fire),
                       "interval": np.asarray(t.interval),
                       "remain": np.asarray(t.remain),
                       "active": np.asarray(t.active)},
            "records": {
                r: {"i32": np.asarray(rec.i32), "f32": np.asarray(rec.f32),
                    "vec": np.asarray(rec.vec), "used": np.asarray(rec.used)}
                for r, rec in cs.records.items()
            },
        }
    return {"tick": np.asarray(state.tick), "rng": np.asarray(state.rng),
            "classes": classes}


def assert_tree_equal(a, b, path: str = "state") -> None:
    """Bit-for-bit equality of two trees (same keys, dtypes, shapes, bytes)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}.{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if a.tobytes() != b.tobytes():
        bad = np.argwhere(a.view(np.uint8).reshape(a.shape + (-1,))
                          != b.view(np.uint8).reshape(b.shape + (-1,)))
        idx = tuple(bad[0][:-1])
        raise AssertionError(f"{path} differs first at {idx}: {a[idx]!r} != {b[idx]!r}")


def _tree():
    rng = np.random.default_rng(0)
    return {"tick": np.int32(3), "rng": np.arange(2, dtype=np.uint32),
            "classes": {"NPC": {"f32": rng.standard_normal((4, 2)).astype(np.float32),
                                "alive": np.ones(4, bool)}}}


def test_tree_compare_accepts_equal_trees():
    assert_tree_equal(_tree(), _tree())


@pytest.mark.parametrize("leaf", ["f32", "alive"])
def test_tree_compare_names_a_flipped_bit(leaf):
    """A one-bit change (including -0.0 against 0.0) is reported with the
    leaf's path and index."""
    a, b = _tree(), _tree()
    arr = b["classes"]["NPC"][leaf]
    arr.view(np.uint8).reshape(-1)[arr.itemsize * 2] ^= 1  # third element
    with pytest.raises(AssertionError, match=f"state.classes.NPC.{leaf} differs"):
        assert_tree_equal(a, b)
    z = _tree()
    z["classes"]["NPC"]["f32"][0, 0] = -0.0
    y = _tree()
    y["classes"]["NPC"]["f32"][0, 0] = 0.0
    with pytest.raises(AssertionError):
        assert_tree_equal(y, z)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for a module's tests (import this fixture
    into the module): beside the other test workers on the box, torch's
    default pool oversubscribes the cores, and the mesh tests' many small
    per-shard ops then run a hundred times slower."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
