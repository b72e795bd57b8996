"""The port's combat-overflow host contract against the JAX package on the
CPU (the cases of tests/test_overflow.py, each run in both packages): the
tick's drop signal reaches ``overflow_last``/``overflow_total``, alerts
past the budget, and ``auto_resize`` doubles the bucket until the drops
stop; with ``emit_events=False`` the overflow, be-killed and respawn
events are not emitted.  Tolerance 0 on every count, mask and digest."""

import numpy as np
import pytest

from noahgameframe_tpu.game import GameWorld as JWorld
from noahgameframe_tpu.game import WorldConfig as JConfig
from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig

CROWD = dict(combat=True, movement=False, regen=False, npc_capacity=64, player_capacity=8,
             extent=64.0, attack_period_s=1 / 30, respawn_s=1e6)


def _world(jax_side: bool, emit_events: bool = True, **cfg):
    w = (JWorld(JConfig(middleware=False, **cfg)) if jax_side
         else GameWorld(WorldConfig(middleware=False, **cfg), device="cpu"))
    w.combat.emit_events = emit_events
    return w.start()


def crowded_worlds(bucket=1, auto_resize=True, emit_events=True):
    """Both packages' worlds with every NPC piled into one cell and a
    bucket of 1: overflow on the first combat tick."""
    out = []
    for jax_side in (True, False):
        w = _world(jax_side, emit_events, aoe_radius=8.0, aoi_bucket=bucket, **CROWD)
        w.combat.auto_resize = auto_resize
        w.scene.create_scene(1)
        w.seed_npcs(32)
        w.kernel.enable_digest()
        k = w.kernel
        host = k.store._hosts["NPC"]
        for row in np.flatnonzero(host.alloc_mask):
            k.set_property(host.row_guid[int(row)], "Position", (10.0, 10.0, 0.0))
        out.append(w)
    return out


def _frame(w):
    """One frame in either package, returning the tick's outputs (the JAX
    world's run_once does not return them)."""
    if isinstance(w, JWorld):
        for m in w.pm.modules.values():
            if m is not w.kernel:
                m.execute()
        w.kernel.execute()
        out = w.kernel.tick()
        w.pm.frame += 1
        return out
    return w.tick()


def _overflow_state(w):
    c = w.combat
    return (c.overflow_last, c.overflow_total, c.overflow_alerts, c._bucket_boost,
            c._overflow_log_muted, w.kernel.last_counters)


def _events(out):
    return [(e.event_id, e.class_name, np.asarray(e.mask).tolist()) for e in out.events]


def test_overflow_alerts_and_counts_without_resize():
    a, b = crowded_worlds(auto_resize=False)
    for t in range(3):
        _frame(a)
        _frame(b)
        assert _overflow_state(b) == _overflow_state(a), t
    c = b.combat
    assert c.overflow_total > 0 and c.overflow_alerts >= 1
    assert c._bucket_boost == 1 and c._overflow_log_muted


def test_auto_resize_stops_the_drops():
    a, b = crowded_worlds(auto_resize=True)
    for w in (a, b):
        w.combat.max_bucket_boost = 64
    for t in range(20):
        _frame(a)
        _frame(b)
        assert _overflow_state(b) == _overflow_state(a), t
        if b.combat._bucket_boost >= 32:
            break
    c = b.combat
    assert c.overflow_alerts >= 1 and c._bucket_boost >= 32
    for _ in range(2):
        _frame(a)
        _frame(b)
        assert _overflow_state(b) == _overflow_state(a)
    assert c.overflow_last == (0, 0)


def test_no_overflow_no_alert():
    ws = []
    for jax_side in (True, False):
        w = _world(jax_side, aoe_radius=4.0, **CROWD)
        w.scene.create_scene(1)
        w.seed_npcs(32)
        w.kernel.enable_digest()
        ws.append(w)
    a, b = ws
    for t in range(3):
        _frame(a)
        _frame(b)
        assert _overflow_state(b) == _overflow_state(a), t
    assert b.combat.overflow_alerts == 0 and b.combat.overflow_last == (0, 0)


@pytest.mark.parametrize("emit_events", [True, False])
def test_emit_events_switch_matches_jax(emit_events):
    """A fight to the death with respawns: the per-tick event lists
    (ids, classes, masks) equal JAX's, with the overflow, be-killed and
    respawn events present only when ``emit_events`` is on; the digests
    and counter banks are equal either way."""
    a, b = crowded_worlds(bucket=64, emit_events=emit_events)
    for w in (a, b):
        w.combat.respawn_s = 0.2
    kinds = set()
    for t in range(40):
        ea, eb = _events(_frame(a)), _events(_frame(b))
        assert eb == ea, t
        assert b.kernel.last_counters == a.kernel.last_counters, t
        kinds |= {e[0] for e in eb if any(e[2])}
    assert b.kernel.counter_totals["deaths"] == 0
    assert b.kernel.counter_totals["respawns"] > 0
    assert bool(kinds) == emit_events
    if not emit_events:
        assert b.combat.overflow_total == 0
