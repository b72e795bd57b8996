"""The port's K-tick trains (Kernel.configure_train/train in
noahgameframe_tpu_torch/kernel/kernel.py) against tick() and against the
JAX package's trains: per-tick counters and digests equal for K in
{1, 3, 8} with a ragged tail, deaths attributed to their exact lane, the
lane-coverage gate in both directions.  The world is the JAX package's
own train recipe (16 NPCs, skin 2.0).  Tolerance 0."""

import numpy as np
import pytest
import torch

from noahgameframe_tpu.game import GameWorld as JaxWorld
from noahgameframe_tpu.game.world import WorldConfig as JaxConfig
from noahgameframe_tpu_torch.core.store import with_class
from noahgameframe_tpu_torch.core.tree import flatten
from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig
from noahgameframe_tpu_torch.kernel.kernel import (
    TRAIN_EXCLUDED,
    TRAIN_LANE_SPEC,
    ObjectEvent,
    _assert_train_lanes,
)
from noahgameframe_tpu_torch.kernel.module import Phase

TICKS = 60
CONFIG = dict(npc_capacity=32, player_capacity=8, extent=64.0, seed=7, combat=True,
              movement=True, regen=True, verlet_skin=2.0)


def _seed(w, seed=7):
    w.start()
    w.scene.create_scene(1, width=64.0)
    w.seed_npcs(16, rng=np.random.default_rng(seed + 100))
    w.kernel.enable_digest()
    return w


def _recipe():
    return _seed(GameWorld(WorldConfig(middleware=False, **CONFIG), device="cpu"))


def _jax_recipe():
    return _seed(JaxWorld(JaxConfig(middleware=False, **CONFIG)))


@pytest.fixture(scope="module")
def control():
    """The port's single-ticking control: one counter bank per tick."""
    w = _recipe()
    return [dict(w.kernel.tick().counters) for _ in range(TICKS)]


def test_control_equals_jax_ticks(control):
    w = _jax_recipe()
    for t, want in enumerate(control):
        w.kernel.tick()
        assert w.kernel.last_counters == want, f"tick {t}"


@pytest.mark.parametrize("k", [1, 3, 8])
def test_train_equals_tick(control, k):
    """train(60) as 60 // K trains plus a ragged tail of 60 % K ticks: one
    TickOutputs per tick, each counter bank (digest and tick stamp
    included) equal to tick()'s; dispatch and tick accounting exact."""
    kern = _recipe().kernel
    kern.configure_train(k)
    outs = kern.train(TICKS)
    assert [o.counters for o in outs] == control
    assert [o.counters["tick"] for o in outs] == list(range(1, TICKS + 1))
    assert kern.train_dispatches == TICKS // k
    assert kern.train_ticks == TICKS // k * k
    assert kern.tick_count == TICKS
    assert kern.train_fetch_bytes > 0


def _lanes(out):
    """Every tensor lane of one TickOutputs, as numpy, in a fixed order."""
    lanes = {"fired": out.fired, "diff": out.diff, "died": out.died,
             "events": [(e.mask, e.params) for e in out.events]}
    leaves, spec, paths = flatten(lanes)
    return spec, {p: x.cpu().numpy() for p, x in zip(paths, leaves)}


def test_train_lanes_equal_tick_lanes():
    """The fired, diff, died and event masks of every frame of two K = 4
    trains, read after both trains ran, equal tick()'s frame for frame:
    a later dispatch does not touch an earlier one's lanes."""
    ticker, trainer = _recipe().kernel, _recipe().kernel
    want = [_lanes(ticker.tick()) for _ in range(8)]
    trainer.configure_train(4)
    outs = trainer.train(8)
    assert trainer.train_dispatches == 2
    for t, (out, (spec, lanes)) in enumerate(zip(outs, want)):
        got_spec, got = _lanes(out)
        assert got_spec == spec, f"tick {t}"
        for p, x in lanes.items():
            assert np.array_equal(got[p], x), f"tick {t}: {p}"


def test_train_equals_jax_train():
    """K = 8 over 20 ticks (two trains and a ragged tail of four): the
    port's lanes decode to the JAX package's, and a reconfigure is a
    sanctioned re-capture."""
    a, b = _jax_recipe().kernel, _recipe().kernel
    for kern in (a, b):
        kern.configure_train(8)
    want = [o.counters for o in a.train(20)]
    got = [o.counters for o in b.train(20)]
    assert got == want
    mark = b.costbook.mark()
    b.configure_train(3)
    assert [o.counters for o in b.train(6)] == [o.counters for o in a.train(6)]
    assert b.costbook.unexplained_since(mark) == []
    assert b.costbook.entries["kernel.train"].causes == {"static:train_k": 1}


def _kill_phase(row: int, at_tick: int):
    def fn(state, ctx):
        cs = state.classes["NPC"]
        alive = cs.alive.clone()
        alive[row] = torch.where(ctx.tick + 1 == at_tick, False, alive[row])
        return with_class(state, "NPC", cs.replace(alive=alive))
    return fn


def test_train_death_attributed_to_exact_lane():
    """A device kill at tick 6 (lane 1 of the second K=4 train) shows in
    exactly that lane's died mask, frees the row once and fires its
    destroy event once."""
    w = _recipe()
    kt = w.kernel
    row = 0
    guid = kt.store._hosts["NPC"].row_guid[row]
    kt.set_phases(list(kt._composed) + [Phase("test.kill", _kill_phase(row, 6), order=999)])
    live_before = kt.store.live_count("NPC")
    destroyed = []
    kt.register_class_event(lambda g, cn, ev: destroyed.append((g, int(ev))))
    kt.configure_train(4)
    outs = kt.train(8)
    died = [i for i, o in enumerate(outs) if bool(o.died["NPC"].any())]
    assert died == [5]
    assert guid not in kt.store.guid_map
    assert destroyed == [(guid, int(ObjectEvent.DESTROY))]
    assert kt.store.live_count("NPC") == live_before - 1


def test_assert_train_lanes_gates_both_directions():
    ok = {name: None for name in TRAIN_LANE_SPEC}
    _assert_train_lanes(ok)
    with pytest.raises(AssertionError, match="unlisted.*aggro"):
        _assert_train_lanes({**ok, "aggro": None})
    short = dict(ok)
    del short["died"]
    with pytest.raises(AssertionError, match="stale.*died"):
        _assert_train_lanes(short)
    # the record-diff lanes are stacked like every other lane, as in JAX
    no_rec = dict(ok)
    del no_rec["rec_diff_count"]
    with pytest.raises(AssertionError, match="stale.*rec_diff_count"):
        _assert_train_lanes(no_rec)
    assert TRAIN_EXCLUDED == ()


def test_configure_train_rejects_zero():
    kern = _recipe().kernel
    with pytest.raises(ValueError, match="train length"):
        kern.configure_train(0)
    with pytest.raises(RuntimeError, match="configure_train"):
        kern.train(4)
