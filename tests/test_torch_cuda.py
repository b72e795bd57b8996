"""The port's CUDA kernels on the card: each against its plain version,
and a world ticked on cuda against the same world on the CPU.  Marked
``cuda``; they skip where torch sees no CUDA device.  On a machine with a
card (which need not have jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from noahgameframe_tpu_torch.game.world import build_benchmark_world
from noahgameframe_tpu_torch.ops import stencil as st
from noahgameframe_tpu_torch.ops import stencil_cuda as sc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,kv,ka,clump", [(3000, 16, 8, None), (600, 8, 8, (4.5, 7.5))])
def test_kernels_match_plain_versions(cuda, n, kv, ka, clump):
    rng = np.random.default_rng(n)
    width, cell, radius = 10, 4.0, 4.0
    lo, hi = clump or (0.0, width * cell)
    pos = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    alive = rng.random(n) < 0.9
    attacking = alive & (rng.random(n) < 0.4)
    atk = rng.integers(1, 4, n).astype(np.float32)  # many ties
    camp, scene, group = (rng.integers(0, 2, n).astype(np.float32) for _ in range(3))
    eff = np.where(attacking, atk, 0.0).astype(np.float32)
    rows = np.arange(n, dtype=np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

    vt, at = st.build_cell_table_pair(
        t(pos), t(alive), t(np.stack([pos[:, 0], pos[:, 1], camp, scene, group], -1)),
        t(attacking), t(np.stack([pos[:, 0], pos[:, 1], eff, camp, scene, group, rows], -1)),
        cell, width, kv, ka)
    vs, ats = st.build_cell_slots_pair(t(pos), t(alive), t(attacking), cell, width, kv, ka)
    bank = t(np.stack([pos[:, 0], pos[:, 1], camp, scene, group, eff], -1))
    before = {k: v.launches for k, v in sc.KERNELS.items()}
    for a, b in zip(sc.combat_fold(vt, at, radius), sc.combat_fold_plain(vt, at, radius)):
        assert torch.equal(a, b)
    for a, b in zip(sc.fused_neighborhood(bank, vs, ats, radius),
                    sc.fused_neighborhood_plain(bank, vs, ats, radius)):
        assert torch.equal(a, b)
    assert all(sc.KERNELS[k].launches == before[k] + 1 for k in before)


def _edge_population(n, extent, seed, *, clump=None, duty=0.3, origin=0):
    """A combat population; ``origin`` > 0 puts that many attacking scene-0,
    group-0 entities within 3 units of (0, 0), within reach of the
    all-zero rows of empty victim slots."""
    rng = np.random.default_rng(seed)
    lo, hi = clump or (0.0, extent)
    pos = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    alive = rng.random(n) < 0.9
    attacking = alive & (rng.random(n) < duty)
    atk = rng.integers(1, 30, n).astype(np.float32)
    camp = rng.integers(0, 2, n).astype(np.float32)
    scene = rng.integers(1, 3, n).astype(np.float32)
    group = rng.integers(0, 2, n).astype(np.float32)
    if origin:
        pos[:origin] = rng.uniform(0.0, 3.0, (origin, 2)).astype(np.float32)
        scene[:origin], group[:origin], camp[:origin] = 0.0, 0.0, 1.0
        alive[:origin] = attacking[:origin] = True
    eff = np.where(attacking, atk, 0.0).astype(np.float32)
    rows = np.arange(n, dtype=np.float32)
    return pos, alive, attacking, np.stack([pos[:, 0], pos[:, 1], camp, scene, group], -1), \
        np.stack([pos[:, 0], pos[:, 1], eff, camp, scene, group, rows], -1), \
        np.stack([pos[:, 0], pos[:, 1], camp, scene, group, eff], -1)


def _misalign(t):
    """A copy of ``t`` at a 4-byte offset from an 8-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 8 == 4
    return out


# name -> (n, width, kv, ka, population knobs, forced chunk slots or 0)
EDGE_CASES = {
    "width_1": (60, 1, 64, 32, {"duty": 0.5}, 0),
    "width_2": (120, 2, 32, 16, {"duty": 0.5}, 0),
    "width_tile_plus_1": (1300, 9, 16, 6, {}, 0),  # fused tiles are 8 cells wide
    "width_combat_tile_plus_1": (3000, 17, 16, 6, {"origin": 4}, 0),  # 16 wide
    "width_not_tile_multiple": (2700, 13, 16, 6, {}, 0),
    "dense_kv128_ka48": (6000, 6, 128, 48, {}, 0),
    "chunk_planned": (2500, 3, 1024, 1024, {"duty": 0.5}, 0),
    "chunk_forced": (1500, 5, 100, 60, {"duty": 0.5, "origin": 5}, 7),
    "origin": (600, 10, 16, 8, {"origin": 12}, 0),
    "unaligned_inputs": (600, 10, 16, 8, {"origin": 6}, 0),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_kernels_match_plain_versions_on_edge_cases(cuda, case):
    """Tolerance 0 on every output slot at grid widths around the tile, the
    boost ceiling, the chunk kernels and empty slots reached from the
    origin; the row tables equal ``slot_rows``."""
    n, width, kv, ka, knobs, chunk = EDGE_CASES[case]
    pos, alive, attacking, vic, att, bank = _edge_population(n, 4.0 * width, n, **knobs)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

    vt, at = st.build_cell_table_pair(t(pos), t(alive), t(vic), t(attacking), t(att),
                                      4.0, width, kv, ka)
    vs, ats = st.build_cell_slots_pair(t(pos), t(alive), t(attacking), 4.0, width, kv, ka)
    bank = t(bank)
    kt = (vt, at)
    if case == "unaligned_inputs":  # the kernels' 4-byte load and copy paths
        kt = (vt._replace(payload=_misalign(vt.payload)), at._replace(payload=_misalign(at.payload)))
        bank_k = _misalign(bank)
    else:
        bank_k = bank
    if chunk:
        plans = (sc.FoldPlan("combat", width, 1, 1, 64, chunk * 32 + 16, chunk),
                 sc.FoldPlan("fused", width, 1, 1, 64, chunk * 28, chunk))
    else:
        plans = (sc.plan_fold("combat", width, kv, ka), sc.plan_fold("fused", width, kv, ka))
    assert all((p.chunk > 0) == (case.startswith("chunk")) for p in plans)
    k1 = sc.combat_fold_planned(*kt, 4.0, plans[0])
    k2 = sc.fused_neighborhood_planned(bank_k, vs, ats, 4.0, plans[1])
    for a, b in zip(k1, sc.combat_fold_plain(vt, at, 4.0)):
        assert torch.equal(a, b)
    p2 = sc.fused_neighborhood_plain(bank, vs, ats, 4.0)
    for a, b in zip(k2, p2):
        assert torch.equal(a, b)
    for tab, slots in zip(sc.row_tables(vs, ats, n), (vs, ats)):
        assert torch.equal(torch.where(tab == 0, n, tab - 1), sc.slot_rows(slots, n))
    if knobs.get("origin"):
        empty = vt.grid_view()[..., sc.V_FEATS] == 0
        assert bool(((k1[0] > 0) & empty).any()) and bool(((p2[2] > 0) & empty).any())


def test_world_on_cuda_matches_cpu(cuda):
    streams = []
    for device in (cuda, "cpu"):
        w = build_benchmark_world(1024, seed=9, device=device)
        w.kernel.enable_digest()
        streams.append([w.tick().counters for _ in range(20)])
    assert streams[0] == streams[1]


def test_world_on_cuda_matches_cpu_with_skin(cuda, monkeypatch):
    """NF_VERLET_SKIN=2.0: the refresh the card runs gives the CPU's
    digest and counter stream, grid_rebuilds and grid_reuses included."""
    monkeypatch.setenv("NF_VERLET_SKIN", "2.0")
    streams = []
    for device in (cuda, "cpu"):
        w = build_benchmark_world(1024, seed=9, device=device)
        w.kernel.enable_digest()
        streams.append([w.tick().counters for _ in range(20)])
    assert streams[0] == streams[1]
    assert sum(c["grid_reuses"] for c in streams[0]) > 0


def _digest(kernel):
    from noahgameframe_tpu_torch.kernel.kernel import state_digest

    return int(state_digest(kernel.state, kernel.store.class_order))


@pytest.mark.parametrize("skin", [0.0, 2.0])
@pytest.mark.parametrize("engine", [1, 2])
def test_graph_run_device_matches_eager(cuda, engine, skin, monkeypatch):
    """run_device as a CUDA graph lands on the eager loop's state (digest
    equal, bit for bit) and counts kernel launches per replay.  Without a
    skin, a second capture after invalidate() is a sanctioned one (with a
    skin, invalidate() drops the Verlet cache, and the rebuilt anchor may
    drop other rows of an overfull cell than the stale one would)."""
    monkeypatch.setenv("NF_VERLET_SKIN", str(skin))
    worlds = [build_benchmark_world(4096, seed=11, device=cuda) for _ in range(2)]
    for w in worlds:
        w.combat.use_pallas = engine
    eager, graph = (w.kernel for w in worlds)
    eager.run_device(24, graph=False)
    before = {k: v.launches for k, v in sc.KERNELS.items()}
    graph.run_device(12)
    mark = graph.costbook.mark()
    if not skin:
        graph.invalidate()
    graph.run_device(12)
    assert _digest(graph) == _digest(eager)
    name = "combat_fold" if engine == 1 else "fused_neighborhood"
    captures = 1 if skin else 2
    # each capture runs 2 eager warm-up ticks; 24 ticks are replayed
    assert sc.KERNELS[name].launches - before[name] == 24 + 2 * captures
    assert graph.costbook.unexplained_since(mark) == []
    assert graph.costbook.entries["kernel.run"].causes == ({} if skin else {"rewrap": 1})
    assert graph.costbook.launches_per_replay("kernel.run") > 0


@pytest.mark.parametrize("engine", [1, 2])
def test_graph_train_matches_tick(cuda, engine):
    """A K=4 train (one CUDA graph of four observed steps) with a ragged
    tail gives tick()'s counters and digests, tick by tick."""
    worlds = [build_benchmark_world(4096, seed=12, device=cuda) for _ in range(2)]
    for w in worlds:
        w.combat.use_pallas = engine
        w.kernel.enable_digest()
    ticked = [worlds[0].kernel.tick().counters for _ in range(14)]
    k = worlds[1].kernel
    k.configure_train(4)
    trained = [o.counters for o in k.train(14)]
    assert trained == ticked
    assert k.train_dispatches == 3
    assert k.costbook.entries["kernel.train"].last["graph"] is True


@pytest.mark.parametrize("engine", [1, 2])
def test_graph_train_lanes_match_tick(cuda, engine):
    """The fired, diff, died and event masks of every frame of two K = 4
    train replays, read after both ran, equal tick()'s frame for frame:
    each dispatch returns its own copy of the graph's lane buffers."""
    from noahgameframe_tpu_torch.core.tree import flatten

    def lanes(out):
        leaves, spec, _ = flatten({"fired": out.fired, "diff": out.diff, "died": out.died,
                                   "events": [(e.mask, e.params) for e in out.events]})
        return spec, leaves

    worlds = [build_benchmark_world(4096, seed=12, device=cuda) for _ in range(2)]
    for w in worlds:
        w.combat.use_pallas = engine
    want = [lanes(worlds[0].kernel.tick()) for _ in range(8)]
    k = worlds[1].kernel
    k.configure_train(4)
    outs = k.train(8)
    assert k.train_dispatches == 2
    assert k.costbook.entries["kernel.train"].last["graph"] is True
    for t, (out, (spec, leaves)) in enumerate(zip(outs, want)):
        got_spec, got = lanes(out)
        assert got_spec == spec, f"tick {t}"
        assert all(torch.equal(a, b) for a, b in zip(got, leaves)), f"tick {t}"


def test_graph_replay_sees_eager_ticks_and_host_writes(cuda):
    """Between replays, an eager observed tick and a host write (a spawn
    wave, which re-arms every timer) replace state leaves; the next
    replay copies them in and lands where the eager loop lands."""
    worlds = [build_benchmark_world(4000, seed=13, device=cuda) for _ in range(2)]
    counters = []
    for w, graph in zip(worlds, (False, True)):
        k = w.kernel
        k.run_device(5, graph=graph)
        counters.append(w.tick().counters)
        k.run_device(5, graph=graph)
        w.seed_npcs(64)
        k.run_device(5, graph=graph)
    assert counters[0] == counters[1]
    assert _digest(worlds[1].kernel) == _digest(worlds[0].kernel)
    assert worlds[1].kernel.costbook.entries["kernel.run"].compiles == 1


# -- the room axis -------------------------------------------------------------


def _room_inputs(cuda, rooms, width, kv, ka, seed):
    """Per room, a population of 64 rows (room 1 with entities at the
    origin) binned on the room's own grid, all rooms built in one vmapped
    call: (victim payloads, attacker payloads, victim slots, attacker
    slots, banks), each with a leading room axis."""
    from noahgameframe_tpu_torch.parallel.rooms import no_vmap_fallback

    pops = [_edge_population(64, 4.0 * width, seed + r, origin=2 if r == 1 else 0)
            for r in range(rooms)]
    pos, alive, attacking, vic, att, bank = (
        torch.from_numpy(np.stack([p[i] for p in pops])).to(cuda) for i in range(6))

    def build(pos, alive, attacking, vic, att):
        vt, at = st.build_cell_table_pair(pos, alive, vic, attacking, att, 4.0, width, kv, ka)
        return vt.payload, at.payload, vt.slot_of, at.slot_of

    with no_vmap_fallback():
        return (*torch.func.vmap(build)(pos, alive, attacking, vic, att), bank)


def _tables(width, kv, ka, vp, ap, vs=None, as_=None):
    return (st.CellTable(vp, vs, None, width, 4.0, kv), st.CellTable(ap, as_, None, width, 4.0, ka))


def _slots(width, kv, ka, vs, as_):
    return st.CellSlots(vs, None, width, 4.0, kv), st.CellSlots(as_, None, width, 4.0, ka)


@pytest.mark.parametrize("rooms", [1, 3])
@pytest.mark.parametrize("width", [10, 13])
def test_batched_kernels_match_room_loop_and_vmapped_plain(cuda, rooms, width):
    """Under torch.func.vmap each kernel makes ONE launch for all rooms
    (its count goes up by one), and equals, bit for bit, a loop of one
    launch a room and the vmapped plain version."""
    from noahgameframe_tpu_torch.parallel.rooms import no_vmap_fallback

    kv, ka = 8, 6
    vp, ap, vs, as_, bank = _room_inputs(cuda, rooms, width, kv, ka, seed=width)
    before = {k: v.launches for k, v in sc.KERNELS.items()}
    with no_vmap_fallback():
        k1 = torch.func.vmap(lambda v, a: sc.combat_fold(*_tables(width, kv, ka, v, a), 4.0))(
            vp, ap)
        k2 = torch.func.vmap(lambda b, v, a: sc.fused_neighborhood(
            b, *_slots(width, kv, ka, v, a), 4.0))(bank, vs, as_)
    assert all(sc.KERNELS[k].launches == before[k] + 1 for k in before)
    with no_vmap_fallback():
        p1 = torch.func.vmap(lambda v, a: sc.combat_fold_plain(
            *_tables(width, kv, ka, v, a), 4.0))(vp, ap)
        p2 = torch.func.vmap(lambda b, v, a: sc.fused_neighborhood_plain(
            b, *_slots(width, kv, ka, v, a), 4.0))(bank, vs, as_)
    loop1 = [sc.combat_fold(*_tables(width, kv, ka, vp[r], ap[r]), 4.0) for r in range(rooms)]
    loop2 = [sc.fused_neighborhood(bank[r], *_slots(width, kv, ka, vs[r], as_[r]), 4.0)
             for r in range(rooms)]
    for i in range(2):
        assert torch.equal(k1[i], torch.stack([x[i] for x in loop1]))
        assert torch.equal(k1[i], p1[i])
    for i in range(3):
        assert torch.equal(k2[i], torch.stack([x[i] for x in loop2]))
        assert torch.equal(k2[i], p2[i])
    assert bool((k1[0] > 0).any()) and bool((k2[2] > 0).any())


@pytest.mark.parametrize("engine", [1, 2])
def test_rooms_on_the_card_match_the_cpu(cuda, engine):
    """A RoomBatch on the card (its step and run loop CUDA graphs of the
    vmapped step) gives the CPU batch's [R, L] summaries tick by tick, and
    its fold kernel launches once per replayed rooms tick."""
    from noahgameframe_tpu_torch.core.prng import prng_key
    from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig
    from noahgameframe_tpu_torch.parallel.rooms import RoomBatch

    def batch(device):
        w = GameWorld(WorldConfig(npc_capacity=32, player_capacity=8, extent=64.0, seed=7,
                                  verlet_skin=2.0, middleware=False), device=device)
        w.start()
        w.scene.create_scene(1, width=64.0)
        w.seed_npcs(16, rng=np.random.default_rng(107))
        w.kernel.enable_digest()
        w.combat.use_pallas = engine
        w.kernel._ensure_aux()
        b = RoomBatch(w.kernel, 4)
        for i in range(4):
            b.admit(i, w.kernel.state.replace(rng=prng_key(50 + i, device)))
        return b

    gpu, cpu = batch(cuda), batch("cpu")
    name = "combat_fold" if engine == 1 else "fused_neighborhood"
    before = sc.KERNELS[name].launches
    for t in range(6):
        gpu.tick()
        cpu.tick()
        np.testing.assert_array_equal(gpu.last_summary, cpu.last_summary, err_msg=f"tick {t}")
    gpu.run(4)
    cpu.run(4)
    np.testing.assert_array_equal(gpu.last_summary, cpu.last_summary)
    # each capture runs 2 eager warm-up steps; 10 rooms ticks are replayed
    assert sc.KERNELS[name].launches - before == 10 + 2 * 2
    for entry in ("rooms.step", "rooms.run"):
        assert gpu.costbook.entries[entry].last["graph"] is True
        assert gpu.costbook.entries[entry].last["kernel_launches_per_replay"][name] == 1


def _settled(n, device, ticks=20):
    """The main path's recipe with the digest on, settled ``ticks`` frames
    (the overflow auto-resize is host state a checkpoint does not carry)."""
    w = build_benchmark_world(n, seed=0, device=device)
    w.kernel.enable_digest()
    w.run(ticks)
    return w


def _stream(w, n):
    return [w.tick().counters["state_digest"] for _ in range(n)]


def _captures(k):
    return {n: k.costbook.entry(n).compiles for n in ("kernel.step", "kernel.run")}


def test_checkpoint_rewind_and_fresh_world_on_cuda(cuda, tmp_path):
    """At 65,536 NPCs on the card: a world captured as a CUDA graph saves,
    ticks, and rewound by load repeats its stream and graph run with no
    new capture; a fresh settled world loading the checkpoint ticks the
    same stream under engines 1 and 2, and its graph run ends on the
    same digest."""
    w = _settled(65_536, cuda)
    k = w.kernel
    k.run_device(5)
    w.save(tmp_path / "ck")

    def run():
        s = _stream(w, 10)
        k.run_device(10)
        return s, _digest(k)

    first = run()
    before = _captures(k)
    w.load(tmp_path / "ck")
    assert run() == first
    assert _captures(k) == before
    f = _settled(65_536, cuda)
    for engine in (1, 2):
        f.combat.use_pallas = engine
        f.load(tmp_path / "ck")
        assert _stream(f, 10) == first[0], engine
    f.combat.use_pallas = None
    f.load(tmp_path / "ck")
    f.kernel.run_device(10)
    f.tick()
    w.load(tmp_path / "ck")
    k.run_device(10)
    w.tick()
    assert f.kernel.last_counters["state_digest"] == k.last_counters["state_digest"]


def test_checkpoint_saved_on_cuda_resumes_on_cpu(cuda, tmp_path):
    """A checkpoint saved on the card resumes on the CPU: equal streams."""
    a = _settled(4096, cuda, ticks=10)
    a.save(tmp_path / "ck")
    b = _settled(4096, "cpu", ticks=10)
    b.load(tmp_path / "ck")
    assert _stream(a, 20) == _stream(b, 20)


def test_host_layer_script_graph_matches_eager(cuda):
    """chip_smoke.py's (h) script of host operations (scenes and groups,
    players, skills, timers, add_exp, the stat API, releases, a forced
    diff column, record-diff subscribers, arm_all) at 65,536 NPCs: one
    graph train a batch against eager observed ticks give equal digest
    streams, subscriber logs and scene answers, and the train graph is
    captured once, then once per invalidating op."""
    import chip_smoke as cs

    a = cs.host_layer_world(65_536, "cuda")
    b = cs.host_layer_world(65_536, "cuda")
    assert cs.digest(a.kernel) == cs.digest(b.kernel)
    a.kernel.configure_train(cs.H_TICKS)
    sync = torch.cuda.synchronize
    ra = cs.run_host_script(a, a.kernel.train, sync)
    rb = cs.run_host_script(b, lambda n: [b.kernel.tick() for _ in range(n)], sync)
    assert ra["stream"] == rb["stream"] and len(ra["stream"]) == cs.H_BATCHES * cs.H_TICKS
    assert ra["log"] == rb["log"]
    assert ra["answers"] == rb["answers"]
    entry = a.kernel.costbook.entry("kernel.train")
    assert entry.compiles == 5 and entry.last["graph"] is True
    assert sorted(entry.causes) == ["static:att_bucket", "static:forced_diff", "static:rec_diff"]


def test_served_role_on_cuda_matches_cpu(cuda):
    """The served frame (graph tick, batched serve lanes) at 65,536 NPCs
    and 64 sessions sends the same bytes and digests on the card as on
    the CPU (chip_smoke.py phase (i)'s stream, at this size)."""
    import chip_smoke

    a = chip_smoke.stream_run(65536, 64, "cuda", 8, serve_batch=True)
    b = chip_smoke.stream_run(65536, 64, "cpu", 8, serve_batch=True)
    assert a == b


def test_middleware_script_on_cuda_matches_cpu(cuda, monkeypatch):
    """chip_smoke.py phase (k)'s middleware script (items, equips and gems,
    heroes, a kill task, two timed buffs expiring on the card, teams,
    guilds, mail, rank, an SLG farm; graph tick, batched serving) at 2,048
    NPCs and 16 sessions on the card and on the CPU: equal send streams,
    digests, module state and credited killers."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "MW_PARITY_N", 2048)
    monkeypatch.setattr(chip_smoke, "MW_PARITY_SESSIONS", 16)
    on_card = chip_smoke.mw_parity("cuda")
    assert on_card == chip_smoke.mw_parity("cpu")
    assert len(set(on_card[1])) > 1


@pytest.mark.parametrize("engine", [1, 2])
def test_sharded_world_on_cuda_matches_cpu(cuda, engine, monkeypatch):
    """A 4,096-row world on a 4-shard virtual mesh of the card gives the
    digest stream of the same sharded world on a virtual CPU mesh, and of
    the single-device tick, with the engine's fold launched on every shard
    of every tick."""
    from noahgameframe_tpu_torch.parallel import ShardedKernel, make_mesh

    monkeypatch.setenv("NF_PALLAS", str(engine))
    streams = {}
    for dev in ("cpu", "cuda"):
        w = build_benchmark_world(4096, seed=5, device=dev)
        w.kernel.enable_digest()
        sk = ShardedKernel(w.kernel, mesh=make_mesh(4, device=dev, virtual=True))
        sk.place()
        before = {k: v.launches for k, v in sc.KERNELS.items()}
        streams[dev] = [sk.tick().counters["state_digest"] for _ in range(6)]
        name = "combat_fold" if engine == 1 else "fused_neighborhood"
        if dev == "cuda":
            assert sc.KERNELS[name].launches - before[name] == 6 * 4
    single = build_benchmark_world(4096, seed=5, device="cpu")
    single.kernel.enable_digest()
    want = [single.kernel.tick().counters["state_digest"] for _ in range(6)]
    assert streams["cuda"] == streams["cpu"] == want


def test_spatial_walk_on_cuda_matches_cpu(cuda):
    """The spatial preset's random walk lands on the same float32 positions
    on the card and on the CPU (float32 cos/sin differ between them in the
    last bit for many angles; the walk takes them in float64)."""
    from noahgameframe_tpu_torch.parallel.spatial import SpatialGeom, _walk

    geom = SpatialGeom(extent=128.0, cell_size=4.0, width=32, n_shards=4, bucket=24,
                       att_bucket=24, radius=4.0, mig_budget=256, speed=1.5)
    n = 1 << 20
    gid = torch.arange(n, dtype=torch.int32)
    pos = torch.rand(n, 2, generator=torch.Generator().manual_seed(3)) * 120.0 + 4.0
    for tick in (0, 1, 977):
        want = _walk(pos, gid, tick, geom)
        got = _walk(pos.to(cuda), gid.to(cuda), tick, geom).cpu()
        assert torch.equal(got, want), tick


def test_traced_capture_times_its_phases_on_the_card(cuda):
    """With the world's tracer off, ``kernel.run``'s graph has no event
    node; turning it on re-captures (cause ``static:phase_events``) with
    one event-record node at the graph's start and after each boundary,
    and otherwise the same nodes, launches and copy-back bytes.  The
    replay's device spans are named by the boundaries, and at 1M NPCs
    their sum is within 3 % of the replay timed by two events around
    it on the stream."""
    from noahgameframe_tpu_torch.telemetry.tracing import SpanTracer

    event_record = 7  # CU_GRAPH_NODE_TYPE_EVENT_RECORD
    tr = SpanTracer()
    w = build_benchmark_world(1_000_000, seed=5, device="cuda", tracer=tr)
    k = w.kernel
    k.run_device(1, reconcile=False)
    entry = k.costbook.entries["kernel.run"]
    off_types, off_last = entry.runner.node_types(), dict(entry.last)
    assert event_record not in off_types and k.device_spans() is None
    assert off_last["copy_back_bytes"] > 0 and off_last["copy_backs"] > 0
    tr.enabled = True
    k.run_device(1, reconcile=False)
    assert entry.causes == {"static:phase_events": 1}
    names = (["nf.schedule"] + [f"nf.phase.{p.name}" for p in k._composed]
             + ["nf.step", "nf.copy_back"])
    on_types = entry.runner.node_types()
    assert on_types[event_record] == len(names) + 1
    assert {t: n for t, n in on_types.items() if t != event_record} == off_types
    for key in ("launches_per_replay", "copy_backs", "copy_back_bytes"):
        assert entry.last[key] == off_last[key], key
    copy_ins = entry.copy_ins
    sums, outer = [], []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        # the card sleeps while the host dispatches, so the two events
        # enclose the replay's device time alone
        torch.cuda._sleep(50_000_000)
        a.record()
        k.run_device(1, reconcile=False)
        b.record()
        torch.cuda.synchronize()
        spans = k.device_spans()
        assert [n for n, _ in spans] == names and all(ms >= 0 for _, ms in spans)
        sums.append(sum(ms for _, ms in spans))
        outer.append(a.elapsed_time(b))
    assert entry.copy_ins == copy_ins
    s, o = sorted(sums)[2], sorted(outer)[2]
    assert 0.97 * o <= s <= o * 1.001 + 0.005, (sums, outer)
