"""The port's counting binning (NF_BINNING=count, noahgameframe_tpu_torch/
ops/stencil.py) against its sort engine and against the JAX package's
count engine: payload, slot_of and dropped bit for bit, overflow drops
included; the knob validates as JAX's does; and a 120-tick world under
NF_BINNING=count gives JAX's digest and counter stream.  Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noahgameframe_tpu.game.world import build_benchmark_world as jax_world
from noahgameframe_tpu.ops import stencil as jst
from noahgameframe_tpu_torch.game.world import build_benchmark_world as torch_world
from noahgameframe_tpu_torch.ops import stencil as tst


def _case(seed, n, width, cell, p_active=0.85, p_sub=0.3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, width * cell, (n, 2)).astype(np.float32)
    active = rng.random(n) < p_active
    sub = (rng.random(n) < p_sub) & active
    feats = rng.normal(size=(n, 3)).astype(np.float32)
    sfeats = rng.normal(size=(n, 2)).astype(np.float32)
    return pos, active, feats, sub, sfeats


def _set_mode(monkeypatch, mode):
    monkeypatch.setenv("NF_BINNING", mode)


def _torch_pair(case, *geom):
    return tst.build_cell_table_pair(*(torch.from_numpy(a) for a in case), *geom)


def _jax_pair(case, *geom):
    return jst.build_cell_table_pair(*(jnp.asarray(a) for a in case), *geom)


def _assert_tables(got, ref, label):
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g.payload), np.asarray(r.payload),
                                      err_msg=f"{label} payload")
        np.testing.assert_array_equal(np.asarray(g.slot_of), np.asarray(r.slot_of),
                                      err_msg=f"{label} slot_of")
        assert int(g.dropped) == int(r.dropped), label


def _count_vs_sort_vs_jax(monkeypatch, case, geom, label):
    """The port's count tables equal its sort tables and JAX's count
    tables; returns the victim table's drop count."""
    _set_mode(monkeypatch, "sort")
    sort = _torch_pair(case, *geom)
    _set_mode(monkeypatch, "count")
    count = _torch_pair(case, *geom)
    ref = _jax_pair(case, *geom)
    _assert_tables(count, sort, f"{label} count vs sort")
    _assert_tables(count, ref, f"{label} count vs jax")
    slots = tst.build_cell_slots_pair(torch.from_numpy(case[0]), torch.from_numpy(case[1]),
                                      torch.from_numpy(case[3]), *geom)
    for s, t in zip(slots, count):
        assert torch.equal(s.slot_of, t.slot_of) and int(s.dropped) == int(t.dropped)
    return int(count[0].dropped)


@pytest.mark.parametrize("bucket,sub_bucket", [(16, 8), (4, 2), (1, 1)])
def test_pair_tables_bit_identical(monkeypatch, bucket, sub_bucket):
    """The bucket pairs of the JAX package's own matrix, down to (1, 1)
    where most rows drop: every engine keeps the same smallest row ids."""
    case = _case(7, 311, 8, 4.0)
    drops = _count_vs_sort_vs_jax(monkeypatch, case, (4.0, 8, bucket, sub_bucket), "pair")
    assert (drops > 0) == (bucket < 16)


@pytest.mark.parametrize("knobs", [dict(p_active=0.0), dict(p_active=1.0, p_sub=1.0),
                                   dict(p_sub=0.0)], ids=["all_inactive", "all_active",
                                                          "sub_empty"])
def test_degenerate_masks_bit_identical(monkeypatch, knobs):
    _count_vs_sort_vs_jax(monkeypatch, _case(11, 200, 8, 4.0, **knobs), (4.0, 8, 8, 4),
                          "degenerate")


def test_one_overfull_cell(monkeypatch):
    """Half the population packed into one cell among a uniform field:
    the scatter-min rounds rank exactly the bucket smallest row ids."""
    pos, active, feats, sub, sfeats = _case(13, 300, 8, 4.0, p_active=1.0, p_sub=0.4)
    pos[:150] = 4.0 * 5.5
    drops = _count_vs_sort_vs_jax(monkeypatch, (pos, active, feats, sub, sfeats),
                                  (4.0, 8, 8, 4), "overfull")
    assert drops > 0


def test_overflow_drop_sweep(monkeypatch):
    """Random densities and tiny buckets: whatever drops, every engine
    drops the same rows."""
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        n, width = int(rng.integers(16, 400)), int(rng.integers(2, 10))
        bucket = int(rng.integers(1, 6))
        sub_bucket = int(rng.integers(1, bucket + 1))
        case = _case(seed, n, width, 4.0, p_active=float(rng.uniform(0.1, 1.0)),
                     p_sub=float(rng.uniform(0.0, 1.0)))
        _count_vs_sort_vs_jax(monkeypatch, case, (4.0, width, bucket, sub_bucket),
                              f"seed {seed}")


def test_single_table_and_cell_counts(monkeypatch):
    pos, active, feats, _sub, _sf = _case(3, 257, 8, 4.0)
    tp, ta, tf = (torch.from_numpy(a) for a in (pos, active, feats))
    _set_mode(monkeypatch, "sort")
    sort = tst.build_cell_table(tp, ta, tf, 4.0, 8, 12)
    _set_mode(monkeypatch, "count")
    count = tst.build_cell_table(tp, ta, tf, 4.0, 8, 12)
    ref = jst.build_cell_table(jnp.asarray(pos), jnp.asarray(active), jnp.asarray(feats),
                               4.0, 8, 12)
    _assert_tables([count], [sort], "single count vs sort")
    _assert_tables([count], [ref], "single count vs jax")
    n_cells, key = tst._cell_keys(tp, ta, 4.0, 8)
    _, jkey = jst._cell_keys(jnp.asarray(pos), jnp.asarray(active), 4.0, 8)
    np.testing.assert_array_equal(tst._cell_counts(key, n_cells).numpy(),
                                  np.asarray(jst._cell_counts(jkey, n_cells)))


@pytest.mark.parametrize("raw", ["", "sort", " count ", "banana", "Sort", "radix"])
def test_binning_mode_validates_as_jax(monkeypatch, raw):
    """Unset/empty means sort; an unknown value raises in both packages."""
    monkeypatch.setenv("NF_BINNING", raw)
    try:
        want = jst.binning_mode()
    except ValueError:
        with pytest.raises(ValueError, match="NF_BINNING"):
            tst.binning_mode()
        return
    assert tst.binning_mode() == want
    assert tst.BINNING_MODES == jst.BINNING_MODES


def test_unknown_binning_raises_in_the_tick(monkeypatch):
    w = torch_world(64, seed=1, device="cpu")
    monkeypatch.setenv("NF_BINNING", "banana")
    with pytest.raises(ValueError, match="NF_BINNING"):
        w.tick()


def test_count_world_120_ticks_equal_jax(monkeypatch):
    """120 ticks at 512 NPCs under NF_BINNING=count (movement, staggered
    combat with the overflow auto-resize, regen, stat recompute): the
    port's digest and counter stream equals the JAX package's, tick by
    tick."""
    _set_mode(monkeypatch, "count")
    a = jax_world(512, seed=5)
    b = torch_world(512, seed=5, device="cpu")
    for w in (a, b):
        w.kernel.enable_digest()
    hits = 0
    for t in range(120):
        a.tick()
        got = b.tick().counters
        assert got == a.kernel.last_counters, f"tick {t}"
        hits += got["combat_hits"]
    assert hits > 0
