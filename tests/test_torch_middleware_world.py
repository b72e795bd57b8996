"""The game role's own world at benchmark scale on the CPU: the
middleware stack on (``build_benchmark_world(middleware=True)``), every
NPC seeded with timed buffs from a recipe (``buffs=...``), held against
the benchmark's plain reference of the stack
(``nfbench/reference/buffs.py``) cell for cell; the batched
``BuffModule.apply_buffs`` and ``apply_buff`` against the store's
per-guid record helpers; the
buff fold's plain version (``ops/buff_cuda.py``) against the phase's old
loop; and the span and counters the buffs add.  The kernel itself is
held to its plain version on the card (tests/test_torch_cuda.py)."""

import copy
import subprocess
import sys

import numpy as np
import pytest
import torch

from nfbench import program, run
from nfbench.checks.world import cells_off
from nfbench.checks.world_middleware import reference_inputs, start_state
from nfbench.reference.buffs import fold
from nfbench.reference.buffs import step as buff_step
from noahgameframe_tpu_torch.core.prng import prng_key
from noahgameframe_tpu_torch.core.store import state_to_numpy
from noahgameframe_tpu_torch.game.defines import PropertyGroup
from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig, build_benchmark_world
from noahgameframe_tpu_torch.ops import buff_cuda
from noahgameframe_tpu_torch.ops import stencil_cuda as sc
from noahgameframe_tpu_torch.parallel.rooms import RoomBatch, no_vmap_fallback
from noahgameframe_tpu_torch.telemetry.tracing import SpanTracer
from test_torch_parity import assert_tree_equal
from test_torch_parity import one_intra_op_thread  # noqa: F401

CELL = "world_1m.middleware"


def tiny_config(**buffs) -> dict:
    """The cell's configuration cut by its kind's ``tiny`` (4,096 NPCs),
    with the buff recipe's keys in ``buffs`` replaced."""
    found = copy.deepcopy(run.find_cell(run.load_benchmark(), CELL))
    cfg = run.named("deployments", found["config"]["kind"]).tiny(found)["config"]
    cfg["buffs"].update(buffs)
    return cfg


def _deploy(cfg, seed):
    """The tiny world, its combat buckets held at the configuration's (an
    observed tick would otherwise grow them on an overflow, as the
    unobserved frames of the benchmark never do)."""
    dep = run.named("deployments", cfg["kind"]).deploy(cfg, seed, torch.device("cpu"))
    dep.world.combat.auto_resize = False
    return dep


def _snap(dep):
    s = program.Snapshot(dep.leaves())
    s.take(dep.leaves())
    return s.as_rooms()


@pytest.mark.parametrize("expire", [(1, 18000), (1, 30)])
def test_middleware_world_matches_the_reference(expire):
    """40 observed ticks of the tiny world (the configuration's recipe,
    and one whose buffs all expire inside the window) equal the
    reference's trajectory on every leaf after every tick, with deaths
    and expiries on the way and the counters ``buffs_active`` and
    ``buffs_expired`` equal to the reference's counts.  With the
    configuration's recipe, single ticks from the program's state past
    the respawn time still agree, respawns included."""
    cfg = tiny_config(expire_ticks=list(expire))
    seed = 4242
    dep = _deploy(cfg, seed)
    lay = dep.layout()
    inputs = reference_inputs(cfg, seed, torch.device("cpu"))
    st, geo = start_state(cfg, lay, inputs, _snap(dep))
    assert cells_off(st, _snap(dep)) == 0
    recipe = cfg["buffs"]
    k = dep.kernel
    seen = {"deaths": 0, "buffs_expired": 0}
    for t in range(40):
        stats = {}
        st, _ = buff_step(st, lay, geo, recipe, stats=stats)
        got = k.tick().counters
        assert cells_off(st, _snap(dep)) == 0, f"tick {t}"
        assert got["buffs_active"] == stats["buffs_active"], t
        assert got["buffs_expired"] == stats["buffs_expired"], t
        for name in seen:
            seen[name] += stats[name]
    assert seen["deaths"] > 50 and seen["buffs_expired"] > 10
    if expire[1] < 40:
        assert int(k.state.classes["NPC"].records["BuffList"].used.sum()) == 0
        return
    k.run_device(113, reconcile=False, graph=False)
    respawns = 0
    for t in range(3):
        before = _snap(dep)
        stats = {}
        want, _ = buff_step(before, lay, geo, recipe, stats=stats)
        k.run_device(1, reconcile=False, graph=False)
        assert cells_off(want, _snap(dep)) == 0, f"late tick {t}"
        respawns += stats["respawns"]
    assert respawns > 0


def test_a_def_buff_leaves_only_the_chip_of_one():
    """With every NPC carrying a DEF buff beyond any attack it can take,
    each hit does the least damage, 1, on the program and on the
    reference alike."""
    cfg = tiny_config(kinds=[{"DEF_VALUE": 1000}], slots_used=1.0,
                      expire_ticks=[18000, 18000])
    seed = 77
    dep = _deploy(cfg, seed)
    lay = dep.layout()
    inputs = reference_inputs(cfg, seed, torch.device("cpu"))
    st, geo = start_state(cfg, lay, inputs, _snap(dep))
    hp_col = lay.i32["NPC"]["HP"]
    hits = 0
    for t in range(24):
        before = dep.kernel.state.classes["NPC"].i32[:, hp_col].clone()
        out = dep.kernel.tick().counters
        st, _ = buff_step(st, lay, geo, cfg["buffs"])
        after = dep.kernel.state.classes["NPC"].i32[:, hp_col]
        assert cells_off(st, _snap(dep)) == 0, t
        # the first tick's recompute is the first to fold the buff in
        if t >= 1:
            assert out["combat_damage_total"] == out["combat_hits"]
            assert int((before - after).max()) <= 1
        hits += out["combat_hits"] if t >= 1 else 0
    assert hits > 100
    assert int(dep.kernel.state.classes["NPC"].i32[:, lay.i32["NPC"]["DEF_VALUE"]].min()) == 1003


def _buff_world(n=256):
    w = GameWorld(WorldConfig(npc_capacity=n, combat=False, movement=False, seed=3),
                  device="cpu")
    w.start()
    w.scene.create_scene(1)
    rows = w.seed_npcs(n)
    w.buffs.define_buff("a", 2.0, {"ATK_VALUE": 2})
    w.buffs.define_buff("b", 5.0, {"DEF_VALUE": 1})
    for i in range(2, 10):
        w.buffs.define_buff(f"k{i}", 1.0 + i, {"MAXHP": i})
    return w, rows


def _record_events(w):
    """The world's host record events, each ``(op, entity row, record
    row, tags)``."""
    seen = []

    def hook(cname, record, op, rows, rec_row, tags):
        seen.extend((int(op), int(r), int(rec_row), tags) for r in rows)

    w.kernel.store.subscribe_records(hook)
    return seen


def _store_apply(w, guid, idx, ticks) -> bool:
    """One application through the store's per-guid record helpers
    (upstream's FindInt, then SetInt or AddRow): the sequential reference
    that ``apply_buffs`` is held to."""
    k = w.kernel
    expire = int(k.state.tick) + max(1, int(ticks))
    found = k.store.record_find_rows(k.state, guid, "BuffList", "ConfigIdx", idx)
    if found:
        k.state = k.store.record_set(k.state, guid, "BuffList", found[0], "ExpireTick", expire)
        return True
    try:
        k.state, _ = k.store.record_add_row(k.state, guid, "BuffList",
                                            {"ConfigIdx": idx, "ExpireTick": expire})
    except RuntimeError:
        return False
    return True


def test_apply_buffs_equals_per_guid_apply_buff():
    """One batched ``apply_buffs`` and ``apply_buff`` called once per
    application in order both leave the state, the answers and the record
    events of the store's per-guid record helpers: re-applications that
    refresh an expiry, full lists that refuse, unknown kinds, the kinds'
    own durations and given ones, over two rounds with ticks between."""
    a, rows = _buff_world()
    b, _ = _buff_world()
    c, _ = _buff_world()
    guids, cguids = ({int(w.kernel.store.row_of(g)[1]): g for g in w.kernel.store.guid_map
                      if w.kernel.store.row_of(g)[0] == "NPC"} for w in (a, c))
    names = {i: n for n, i in a.buffs._defs.items()}
    dt = a.kernel.schedule.dt
    kind_ticks = np.asarray([round(d / dt) for d in a.buffs._durations])
    seen = [_record_events(w) for w in (a, b, c)]
    took = 0
    r = np.random.default_rng(11)
    for round_ in range(2):
        n = 1200
        app_rows = np.sort(r.choice(rows, n)) if round_ else r.choice(rows[:40], n)
        kinds = r.integers(-1, 11, n)  # -1 and 10 are not defined
        ticks = r.integers(1, 200, n) if round_ else kind_ticks[np.clip(kinds, 0, 9)]
        want, per_guid = [], []
        for i, (row, kind) in enumerate(zip(app_rows, kinds)):
            if kind not in names:
                want.append(False)
                per_guid.append(c.buffs.apply_buff(cguids[int(row)], "undefined"))
                continue
            want.append(_store_apply(a, guids[int(row)], int(kind), ticks[i]))
            c.buffs._durations[kind] = float(ticks[i]) * dt
            per_guid.append(c.buffs.apply_buff(cguids[int(row)], names[int(kind)]))
        got = b.buffs.apply_buffs("NPC", app_rows, kinds, ticks)
        assert got.tolist() == want and per_guid == want
        assert 0 < sum(want) < n
        took += sum(want)
        for w in (b, c):
            assert_tree_equal(state_to_numpy(a.kernel.state), state_to_numpy(w.kernel.state))
        assert sorted(seen[0]) == sorted(seen[1]) == sorted(seen[2]) and len(seen[0]) == took
        full = a.kernel.state.classes["NPC"].records["BuffList"].used.all(dim=1)
        assert int(full.sum()) > 0
        c.buffs._durations[:] = a.buffs._durations
        for w in (a, b, c):
            w.kernel.run_device(40, graph=False)


def test_seed_buffs_is_one_apply_buffs_of_the_draws():
    """A world built with a recipe holds the lists that ``apply_buffs`` of
    the recipe's draws, slot by slot in order, leaves on the bare world,
    and the recipe's kinds as ``recipe.<i>``."""
    cfg = tiny_config()
    recipe = cfg["buffs"]
    w = build_benchmark_world(512, seed=9, device="cpu", middleware=True, buffs=recipe)
    bare = build_benchmark_world(512, seed=9, device="cpu", middleware=True)
    for i, stats in enumerate(recipe["kinds"]):
        assert bare.buffs.define_buff(f"recipe.{i}", 600.0, stats) == i
    from noahgameframe_tpu_torch.game.world import buff_draws

    used, kind, ticks = buff_draws(9, 512, 8, 0.5, len(recipe["kinds"]), 1, 18000)
    took = bare.buffs.apply_buffs("NPC", np.repeat(np.arange(512), 8)[used.ravel()],
                                  kind.ravel()[used.ravel()], ticks.ravel()[used.ravel()])
    assert took.all()
    assert_tree_equal(state_to_numpy(w.kernel.state), state_to_numpy(bare.kernel.state))
    assert sorted(w.buffs._defs) == sorted(f"recipe.{i}" for i in range(16))


def test_buffs_need_the_middleware_stack():
    with pytest.raises(ValueError, match="middleware"):
        build_benchmark_world(64, seed=1, device="cpu", buffs=tiny_config()["buffs"])


def _old_loop(buf, used, table, tick, cfg_col, exp_col):
    """The buff phase's fold as it was written in the phase: an int32
    accumulator over the record rows, one gathered row at a time."""
    hi = table.shape[0] - 1
    cfg = buf[:, :, cfg_col].clamp(0, hi)
    active = used & (buf[:, :, exp_col] > tick)
    contrib = torch.zeros((cfg.shape[0], table.shape[1]), dtype=torch.int32)
    for r in range(cfg.shape[1]):
        contrib += table[cfg[:, r]] * active[:, r, None]
    return contrib, active


def buff_fold_population(c, k, s, seed, tick=500):
    """A class's buff lists: kinds below 0 and beyond the table (clamped),
    expiries on, below and above the tick, empty rows, full rows, and
    deltas of both signs near the int32 ends."""
    r = np.random.default_rng(seed)
    buf = np.zeros((c, 8, 2), np.int32)
    buf[:, :, 0] = r.integers(-3, k + 3, (c, 8))
    buf[:, :, 1] = tick + r.integers(-2, 3, (c, 8))
    used = r.random((c, 8)) < 0.6
    used[: c // 8] = False
    used[c // 8: c // 4] = True
    table = r.integers(-2**31, 2**31 - 1, (k, s), dtype=np.int64).astype(np.int32)
    table[: k // 2] = r.integers(-50, 50, (k // 2, s))
    return (torch.from_numpy(buf), torch.from_numpy(used), torch.from_numpy(table),
            torch.tensor(tick, dtype=torch.int32))


@pytest.mark.parametrize("c,k,s", [(4096, 16, 29), (333, 1, 29), (1000, 200, 32)])
def test_buff_fold_plain_matches_the_old_loop(c, k, s):
    """The fold's plain version is the phase's old eight-pass loop, bit for
    bit: clamped kinds, ``ExpireTick == tick`` inactive, empty rows,
    wrapping int32 sums."""
    buf, used, table, tick = buff_fold_population(c, k, s, c + k)
    got = buff_cuda.buff_fold(buf, used, table, tick, 0, 1)
    want = _old_loop(buf, used, table, tick, 0, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool((buf[:, :, 1] == tick).any()) and not bool(got[1][buf[:, :, 1] == tick].any())
    assert int(got[1].sum()) > 0 and int((used & ~got[1]).sum()) > 0


def _emulated_launch_buff_fold(buf, used, table, tick, cfg_col, exp_col, lead=()):
    """The kernel's launch emulated on the CPU by the plain version, room
    by room, counted as one launch."""
    buff_cuda.KERNELS["buff_fold"].launches += 1
    if not lead:
        return buff_cuda.buff_fold_plain(buf, used, table, tick, cfg_col, exp_col)
    outs = [buff_cuda.buff_fold_plain(buf[i], used[i], table, tick[i], cfg_col, exp_col)
            for i in range(lead[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


@pytest.mark.parametrize("rooms", [1, 3])
def test_buff_fold_vmap_rule_makes_one_launch_for_all_rooms(monkeypatch, rooms):
    """Under torch.func.vmap (a ``RoomBatch`` of middleware worlds, its
    fallback off) ``nf::buff_fold`` makes one launch for all rooms, each
    room folding at its own tick or at one shared tick, and gives the
    vmapped plain version."""
    monkeypatch.setattr(buff_cuda, "_launch_buff_fold", _emulated_launch_buff_fold)
    pops = [buff_fold_population(200, 12, 29, 40 + r, tick=500 + r) for r in range(rooms)]
    buf, used = torch.stack([p[0] for p in pops]), torch.stack([p[1] for p in pops])
    table = pops[0][2]
    ticks = torch.tensor([500, 501, 502][:rooms], dtype=torch.int32)

    def op(b, u, t):
        return torch.ops.nf.buff_fold(b, u, table, t, 0, 1)

    def plain(b, u, t):
        return buff_cuda.buff_fold_plain(b, u, table, t, 0, 1)

    sc.reset_launch_counts()
    with no_vmap_fallback():
        got = torch.func.vmap(op)(buf, used, ticks)
        shared = torch.func.vmap(op, in_dims=(0, 0, None))(buf, used, ticks[0])
        want = torch.func.vmap(plain)(buf, used, ticks)
        want_shared = torch.func.vmap(plain, in_dims=(0, 0, None))(buf, used, ticks[0])
        with pytest.raises(ValueError, match="one buff table"):
            torch.func.vmap(lambda b, u, tb: torch.ops.nf.buff_fold(b, u, tb, ticks[0], 0, 1))(
                buf, used, table.expand(rooms, *table.shape))
    assert sc.KERNELS["buff_fold"].launches == 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(shared, want_shared))
    for r in range(rooms):
        one = _old_loop(buf[r], used[r], table, ticks[r], 0, 1)
        assert all(torch.equal(a[r], b) for a, b in zip(got, one))


def test_room_batch_of_middleware_worlds_matches_one_world():
    """A ``RoomBatch`` over the middleware world (the buff phase vmapped,
    its fallback off) ticks each room as the world alone ticks: room 0,
    admitted with the world's state, equals it after 20 ticks of short
    buffs expiring."""
    recipe = tiny_config(expire_ticks=[1, 30])["buffs"]
    w = build_benchmark_world(256, seed=4, device="cpu", middleware=True, buffs=recipe)
    st0 = w.kernel.state
    batch = RoomBatch(w.kernel, 2)
    batch.admit(0, st0)
    batch.admit(1, st0.replace(rng=prng_key(9, "cpu")))
    for _ in range(20):
        batch.tick()
        w.kernel.tick()
    assert_tree_equal(state_to_numpy(batch.extract(0)), state_to_numpy(w.kernel.state))
    used = [int(s.classes["NPC"].records["BuffList"].used.sum()) for s in (st0, w.kernel.state)]
    assert used[0] > used[1] > 0


def test_world_seed_buffs_span_sits_under_world_build():
    tr = SpanTracer(enabled=True)
    build_benchmark_world(256, seed=4, device="cpu", tracer=tr, middleware=True,
                          buffs=tiny_config()["buffs"])
    ev = {e.name: e for e in tr.events()}
    assert ev["world.seed_buffs"].parent == ev["world.build"].id
    assert ev["world.seed_npcs"].parent == ev["world.build"].id
    assert ev["world.seed_buffs"].ts_ns >= ev["world.seed_npcs"].ts_ns


def test_a_world_without_buffs_has_no_buff_counters():
    """The benchmark's stripped world has no buff phase and no buff
    counter; the middleware world has both, zero with nothing applied."""
    plain = build_benchmark_world(256, seed=4, device="cpu")
    assert "BuffModule.buffs" not in [p.name for p in plain.kernel._composed]
    got = plain.kernel.tick().counters
    assert "buffs_active" not in got and "buffs_expired" not in got
    mw = build_benchmark_world(256, seed=4, device="cpu", middleware=True)
    got = mw.kernel.tick().counters
    assert got["buffs_active"] == got["buffs_expired"] == 0


def test_the_stack_without_buffs_ticks_as_the_stripped_world():
    """The middleware stack adds the buff phase and nothing else to the
    device loop: with no buff applied, 30 ticks of the middleware world
    leave every leaf of the stripped world's state as it does."""
    a = build_benchmark_world(1024, seed=6, device="cpu")
    b = build_benchmark_world(1024, seed=6, device="cpu", middleware=True)
    assert [p.name for p in b.kernel._composed] == (
        [p.name for p in a.kernel._composed[:5]] + ["BuffModule.buffs"]
        + [p.name for p in a.kernel._composed[5:]])
    for w in (a, b):
        w.kernel.run_device(30, graph=False)
    assert_tree_equal(state_to_numpy(a.kernel.state), state_to_numpy(b.kernel.state))


def test_the_reference_fold_writes_the_runtime_buff_row():
    """The reference's fold on a hand-made list: two active rows sum, an
    expiring one (ExpireTick == tick) is freed and counted."""
    cfg = tiny_config()
    dep = _deploy(cfg, 5)
    lay = dep.layout()
    st = _snap(dep)
    ci, ei = lay.buff_cols["NPC"]
    buf = st["classes.NPC.records.BuffList.i32"].clone()
    used = torch.zeros_like(st["classes.NPC.records.BuffList.used"])
    buf[0, 0, 0, ci], buf[0, 0, 0, ei] = 3, 10
    buf[0, 0, 1, ci], buf[0, 0, 1, ei] = 3, 10
    buf[0, 0, 2, ci], buf[0, 0, 2, ei] = 5, 0
    used[0, 0, :3] = True
    st = {**st, "classes.NPC.records.BuffList.i32": buf,
          "classes.NPC.records.BuffList.used": used}
    stats = {}
    out = fold(st, lay, cfg["buffs"], stats)
    rec = out["classes.NPC.records.CommPropertyValue.i32"][0, 0, int(PropertyGroup.RUNTIME_BUFF)]
    cols = lay.stat_cols["NPC"]
    assert int(rec[cols["ATK_VALUE"]]) == 10 and int(rec[cols["MAXHP"]]) == 86
    assert int(rec[cols["MOVE_SPEED"]]) == 28000 and int(rec.sum()) == 10 + 86 + 28000
    assert out["classes.NPC.records.BuffList.used"][0, 0, :3].tolist() == [True, True, False]
    assert stats == {"buffs_active": 2, "buffs_expired": 1}


def test_the_buff_reference_imports_no_program_and_no_jax():
    code = ("import sys, nfbench.reference.buffs, nfbench.checks.world_middleware; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'noahgameframe_tpu', 'noahgameframe_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_every_custom_op_is_named_by_the_cost_book():
    from noahgameframe_tpu_torch.ops import stencil_cuda
    from noahgameframe_tpu_torch.telemetry import costbook

    doc = " ".join(costbook.__doc__.split())
    for op in (*stencil_cuda.CUSTOM_OP_PARITY_TESTS, *buff_cuda.CUSTOM_OP_PARITY_TESTS):
        assert f"``{op}``" in doc, op
    assert "buff_fold" in stencil_cuda.KERNELS
