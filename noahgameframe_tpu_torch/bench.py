"""The port's benchmark entry: the world tick of ``build_benchmark_world``,
or the many-worlds rooms ladder.

    python -m noahgameframe_tpu_torch.bench [--entities 1000000] [--ticks 90]
        [--seed 42] [--train K] [--lat-k N] [--lat-budget-s S] [--no-combat]
        [--device cuda]
    python -m noahgameframe_tpu_torch.bench --rooms [--rooms-count 256,4096,16384]
        [--rooms-entities 64] [--rooms-ticks 30] [--rooms-churn 8] [--train K]
    python -m noahgameframe_tpu_torch.bench --served [--entities 100000]
        [--sessions 50] [--interest-radius R] [--serve-batch] [--serve-overlap]
        [--train K] [--no-combat] [--ticks 90]

Counterpart of ``run_bench`` in the repository's ``bench.py``: builds the
world, times a ``run_device`` window, takes single-step latency samples
and fused-window latency samples (``lat_k`` ticks per sample), optionally
times a K-tick train arm instead of the window, and prints ONE JSON line
whose ``metric``/``unit``/``value``/``detail`` keys keep ``run_bench``'s
names wherever the quantity is the same.  The knobs are the same
environment variables: ``NF_PALLAS`` (fold engine), ``NF_BINNING``
(``sort``/``count``) and ``NF_VERLET_SKIN``.  Percentiles are read from
the world's metrics registry.

It adds ``device_name`` and ``power_limit_w`` (from ``nvidia-smi``),
``graph`` (whether ``run_device`` replayed a CUDA graph) and
``launches_per_tick`` (device launches of one replay), and has no
``vs_baseline``.  It never falls back to the CPU: without a card it
fails unless ``--device cpu`` is given.

``--rooms`` runs the counterpart of ``run_rooms`` (parallel/rooms.py's
``RoomBatch`` on one card, the JAX package's ladder without its mesh):
per rung of R rooms, the admit cost, single-tick p50/p99 (``tick()`` with
its ``[R, L]`` counter fetch), fused room-ticks/s (``run(2 * ticks)``, one
CUDA graph replayed), a re-home churn with its dropped rows and
unexplained re-captures, and under ``--train K`` the train arm and a
120-tick digest parity of trains against ticks.  Its line's metric is
``rooms_room_ticks_per_sec`` (``rooms_train_room_ticks_per_sec`` under
``--train``) at the last rung.

``--served`` runs the counterpart of ``run_served``: the game role's
frame (``GameRole.execute``: the tick, the diff harvest, the interest
lanes and the encode and fan-out to ``--sessions`` sessions, each with a
live Player avatar seated as ``bench.py`` seats them), with the
transport's writes counted instead of sent.  Three warm-up frames, then
``--ticks`` timed frames, each ended by ``torch.cuda.synchronize()``.  Its
line's metric is ``served_entity_ticks_per_sec``, with ``frame_ms_p50``/
``p95``/``p99``, ``sync_msgs``/``sync_bytes``, ``serve_batch``/
``serve_overlap``, ``tick_train`` and the ``StageClock`` waterfall
(``pipeline``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import torch

from .core.device import resolve_device
from .game.world import GameWorld, build_benchmark_world
from .ops.stencil import binning_mode, build_cell_table
from .ops.verlet import skin_from_env


def card_identity() -> Dict[str, object]:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    name, limit = [f.strip() for f in out.strip().splitlines()[0].split(",")]
    return {"device_name": name, "power_limit_w": float(limit.split()[0]),
            "nvidia_smi": out.strip().splitlines()[0]}


def _hist_pcts(hist) -> tuple:
    """p50/p95/p99 in ms from a registry histogram."""
    return tuple(round(hist.percentile(p) * 1e3, 3) for p in (50, 95, 99))


def _drops(world: GameWorld, mask, bucket: int) -> int:
    combat = world.combat
    cs = world.kernel.state.classes[combat.class_name]
    spec = world.kernel.store.spec(combat.class_name)
    pos = cs.vec[:, spec.slot("Position").col, :2]
    feats = torch.zeros((pos.shape[0], 0), dtype=torch.float32, device=pos.device)
    return int(build_cell_table(pos, mask, feats, combat.cell_size, combat.width,
                                bucket).dropped)


def overflow_replays(world: GameWorld) -> tuple:
    """(victim drops, worst attacker-residue drops) of the combat tables
    rebuilt from the final state, published on the registry and read back
    from it; -1 each without combat."""
    combat = world.combat
    if combat is None:
        return -1, -1
    k = world.kernel
    cname = combat.class_name
    cs = k.state.classes[cname]
    cap = cs.alive.shape[0]
    grid = _drops(world, cs.alive, combat.resolved_bucket(cap))
    # the attacker table holds one firing residue per tick (staggered
    # heartbeats keep their phase), so replay each residue
    slot = k.schedule.slot(cname, "Attack")
    interval = max(1, k.schedule.ticks_of(combat.attack_period_s))
    armed = cs.timers.active[:, slot] & cs.alive
    residue = cs.timers.next_fire[:, slot] % interval
    att = max(_drops(world, armed & (residue == p), combat.resolved_att_bucket(cap))
              for p in range(interval))
    reg = world.telemetry.registry
    g = reg.gauge("nf_bench_overflow_replay",
                  "offline cell-table overflow replay (max drops per tick)", ("side",))
    g.set(grid, side="victim")
    g.set(att, side="attacker")
    return (int(reg.value("nf_bench_overflow_replay", side="victim")),
            int(reg.value("nf_bench_overflow_replay", side="attacker")))


def costbook_detail(book, device) -> dict:
    hbm = book.hbm_sample(device if device.type == "cuda" else None)
    return {
        "capture_ms": round(book.capture_s_total * 1e3, 1),
        "compiles": book.total_compiles,
        "recompiles": book.total_recompiles,
        "recompile_causes": {n: dict(e.causes)
                             for n, e in sorted(book.entries.items()) if e.causes},
        "hbm_peak_bytes": int(hbm.get("peak_bytes", 0)),
        "hbm_live_bytes": int(hbm.get("live_bytes", 0)),
        "hbm_source": hbm.get("source"),
        "entries": {n: {"compiles": e.compiles, "calls": e.calls, "replays": e.replays,
                        "capture_ms_total": round(e.capture_s_total * 1e3, 1),
                        "launches_per_replay": book.launches_per_replay(n),
                        "pool_bytes": e.last.get("pool_bytes")}
                    for n, e in sorted(book.entries.items())},
    }


def run_bench(args, device: torch.device) -> dict:
    n = args.entities
    sync: Callable[[], None] = (
        (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None))
    world = build_benchmark_world(n, combat=not args.no_combat, seed=args.seed, device=device)
    k = world.kernel

    train_k = int(args.train or 0)
    if train_k > 1:
        # the observed path, K ticks per dispatch; tick_ms is per tick
        t_c0 = time.perf_counter()
        k.configure_train(train_k)
        k.train(train_k)
        sync()
        compile_s = time.perf_counter() - t_c0
        d0 = k.train_dispatches
        t0 = time.perf_counter()
        k.train(args.ticks)
        sync()
        dt = time.perf_counter() - t0
        train_detail = {"tick_train": train_k, "train_dispatches": k.train_dispatches - d0,
                        "train_ticks_timed": args.ticks,
                        "train_fetch_bytes": k.train_fetch_bytes}
        k.run_device(1, reconcile=False)  # capture the run graph outside the windows
        sync()
    else:
        train_detail = {}
        t_c0 = time.perf_counter()
        k.run_device(args.ticks)  # capture + warm-up
        sync()
        compile_s = time.perf_counter() - t_c0
        t0 = time.perf_counter()
        k.run_device(args.ticks)
        sync()
        dt = time.perf_counter() - t0

    # single-step latency: one dispatch per sample, as a 30 Hz loop sees it
    reg = world.telemetry.registry
    lat_hist = reg.histogram("nf_bench_tick_seconds", "single-dispatch tick latency")
    for _ in range(max(8, min(64, args.ticks))):
        t1 = time.perf_counter()
        k.run_device(1, reconcile=False)
        sync()
        lat_hist.observe(time.perf_counter() - t1)
    p50, p95, p99 = _hist_pcts(lat_hist)

    # fused windows: lat_k ticks per dispatch, so the per-dispatch cost is
    # spread over lat_k ticks; window count adapts to a wall budget
    tick_s_est = max(1e-5, dt / max(1, args.ticks))
    lat_k = max(1, args.lat_k) if args.lat_k else max(4, min(256, int(round(1.6 / tick_s_est))))
    n_windows = int(max(24, min(256, args.lat_budget_s / (lat_k * tick_s_est))))
    k.run_device(lat_k, reconcile=False)
    sync()
    dev_hist = reg.histogram("nf_bench_tick_seconds_device",
                             "fused-window per-tick latency (dispatch spread over lat_k)")
    for _ in range(n_windows):
        t1 = time.perf_counter()
        k.run_device(lat_k, reconcile=False)
        sync()
        dev_hist.observe((time.perf_counter() - t1) / lat_k)
    dp50, dp95, dp99 = _hist_pcts(dev_hist)

    # Verlet cache effectiveness, read before the reconciling tick (an
    # overflow there would invalidate, and drop the caches)
    verlet = {}
    for key, c in (k.state.aux or {}).items():
        if key.startswith("verlet/"):
            reb, reu = int(c.rebuilds), int(c.reuses)
            verlet[key[len("verlet/"):]] = {
                "rebuilds": reb, "reuses": reu,
                "rebuilds_per_tick": round(reb / max(1, reb + reu), 4)}
    k.tick()  # reconcile host free-lists; fetches the counter bank
    grid_drop, att_drop = overflow_replays(world)
    launches = k.costbook.launches_per_replay("kernel.run")
    run_entry = k.costbook.entries.get("kernel.run")
    rate = n * args.ticks / dt
    detail = {
        "entities": n,
        "ticks": args.ticks,
        "seed": args.seed,
        "elapsed_s": round(dt, 4),
        "compile_and_warmup_s": round(compile_s, 2),
        "ticks_per_s": round(args.ticks / dt, 2),
        "tick_ms": round(1000 * dt / args.ticks, 3),
        "tick_ms_p50": p50,
        "tick_ms_p95": p95,
        "tick_ms_p99": p99,
        "tick_ms_p50_device": dp50,
        "tick_ms_p95_device": dp95,
        "tick_ms_p99_device": dp99,
        "lat_windows": n_windows,
        "lat_k": lat_k,
        "device": str(device),
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "graph": bool(run_entry is not None and run_entry.last.get("graph")),
        "launches_per_tick": launches,
        "combat": not args.no_combat,
        **train_detail,
        "grid_overflow_max": grid_drop,
        "att_overflow_max": att_drop,
        "tick_counters": dict(k.last_counters),
        "verlet_skin": skin_from_env(),
        "binning": binning_mode(),
        **({"pallas_engine": world.combat.resolved_engine()} if world.combat else {}),
        **({"verlet": verlet} if verlet else {}),
        "costbook": costbook_detail(k.costbook, device),
    }
    if device.type == "cuda":
        detail.update(card_identity())
        detail["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
    return {"metric": "entities_ticked_per_sec_per_chip", "value": round(rate, 1),
            "unit": "entity-ticks/s", "detail": detail}


def _rooms_point(args, device: torch.device, n_rooms: int, sync) -> dict:
    """One rung of the rooms ladder (``run_rooms``'s ``point``)."""
    import numpy as np

    from .core.prng import prng_key
    from .game.world import WorldConfig
    from .parallel.rooms import RoomBatch, RoomBinPacker

    per_room = int(args.rooms_entities)
    seeded = max(1, per_room // 2)
    ticks = int(args.rooms_ticks)
    train_k = int(args.train or 0)
    t0 = time.perf_counter()
    w = GameWorld(WorldConfig(npc_capacity=per_room, player_capacity=8, extent=64.0,
                              seed=args.seed, middleware=False, combat=True,
                              movement=True, regen=True, verlet_skin=2.0), device=device)
    w.start()
    w.scene.create_scene(1, width=64.0)
    w.seed_npcs(seeded, rng=np.random.default_rng(args.seed + 100))
    w.kernel._ensure_aux()
    batch = RoomBatch(w.kernel, n_rooms)
    packer = RoomBinPacker(batch.capacity)
    sync()
    build_s = time.perf_counter() - t0

    def room_of(i):
        return w.kernel.state.replace(rng=prng_key(args.seed + i, device))

    # warm-up captures every entry once, then the no-re-capture gate arms:
    # churn after the mark must be free
    batch.admit(packer.alloc(), room_of(0))
    batch.tick()
    batch.run(1)
    if train_k > 1:
        batch.configure_train(train_k)
        batch.train(train_k)
    batch.extract(0)
    batch.rehome(0, 1)
    packer.free(0)
    mark = batch.costbook.mark()

    # every slot but one; the spare is what the churn rotates rooms through
    t0 = time.perf_counter()
    used = []
    while packer.free_count > 1:
        slot = packer.alloc()
        batch.admit(slot, room_of(len(used)))
        used.append(slot)
    sync()
    admit_s = time.perf_counter() - t0

    lat = []
    for _ in range(ticks):
        t1 = time.perf_counter()
        counters = batch.tick()
        lat.append(time.perf_counter() - t1)
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    p50 = float(lat_ms[len(lat_ms) // 2])
    p99 = float(lat_ms[min(len(lat_ms) - 1, int(len(lat_ms) * 0.99))])

    sync()
    torch_peak0 = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    t1 = time.perf_counter()
    batch.run(2 * ticks)
    sync()
    run_s = time.perf_counter() - t1
    room_ticks = n_rooms * 2 * ticks / run_s

    train = {}
    if train_k > 1:
        n_train = 2 * ticks
        d0 = batch.train_dispatches
        t1 = time.perf_counter()
        lanes = batch.train(n_train)
        train_s = time.perf_counter() - t1
        dispatches = batch.train_dispatches - d0
        train = {
            "tick_train": train_k,
            "train_ticks_timed": n_train,
            "train_tick_ms": round(train_s * 1e3 / n_train, 3),
            "train_room_ticks_per_sec": round(n_rooms * n_train / train_s, 1),
            "train_dispatches": dispatches,
            "train_dispatch_gate": dispatches == n_train // train_k,
            "train_rows": int(lanes.shape[0]),
            "train_fetch_bytes": batch.train_fetch_bytes,
        }

    def rows():
        return int(batch.state.classes["NPC"].alive[used].sum())

    before = rows()
    rng = np.random.default_rng(args.seed)
    for _ in range(int(args.rooms_churn)):
        src = used.pop(int(rng.integers(0, len(used))))
        dst = packer.alloc()
        batch.rehome(src, dst)
        packer.free(src)
        used.append(dst)
    dropped = before - rows()
    unexplained = batch.costbook.unexplained_since(mark)
    launches = batch.costbook.launches_per_replay("rooms.run")
    point = {
        "rooms": n_rooms,
        "rooms_admitted": len(used),
        "entities_per_room": seeded,
        "build_wall_s": round(build_s, 2),
        "admit_wall_s": round(admit_s, 2),
        "admit_ms_per_room": round(admit_s * 1e3 / n_rooms, 3),
        "tick_p50_ms": round(p50, 3),
        "tick_p99_ms": round(p99, 3),
        "run_tick_ms": round(run_s * 1e3 / (2 * ticks), 3),
        "room_ticks_per_sec": round(room_ticks, 1),
        "entity_ticks_per_sec": round(room_ticks * seeded, 1),
        "counters_sample": {k: int(np.asarray(v).sum()) for k, v in counters.items()},
        "rehomed": int(args.rooms_churn),
        "dropped_rows": int(dropped),
        "unexplained_recompiles": len(unexplained),
        "launches_per_tick": launches,
        "graph": bool(batch.costbook.entries["rooms.run"].last.get("graph")),
        **train,
    }

    # digest parity: a fresh train batch against a fresh ticking one, 120
    # ticks, every room's digest lane; after the gates, since
    # enable_digest() is a sanctioned re-capture
    if train_k > 1:
        w.kernel.enable_digest()

        def parity_batch():
            pb = RoomBatch(w.kernel, n_rooms)
            pk = RoomBinPacker(pb.capacity)
            for i in range(n_rooms):
                pb.admit(pk.alloc(), room_of(i))
            return pb

        pb_t = parity_batch()
        pb_t.configure_train(train_k)
        p_ticks = 120
        lanes_p = pb_t.train(p_ticks)
        del pb_t
        pb_c = parity_batch()
        ok = True
        for i in range(p_ticks):
            c = w.kernel.decode_counters(lanes_p[i])
            ctl = pb_c.tick()
            if not (np.array_equal(c["state_digest"], ctl["state_digest"])
                    and np.array_equal(c["tick"], ctl["tick"])):
                ok = False
                break
        point.update(digest_parity_ticks=p_ticks, digest_parity=ok)
        del pb_c
    point["costbook"] = costbook_detail(batch.costbook, device)
    if device.type == "cuda":
        point["peak_mem_bytes"] = max(torch_peak0, torch.cuda.max_memory_allocated(device))
    return point


def run_rooms(args, device: torch.device) -> dict:
    """The many-worlds rooms ladder on one device (``run_rooms``)."""
    import gc

    sync: Callable[[], None] = (
        (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None))
    counts = [int(x) for x in args.rooms_count.split(",")]
    train_k = int(args.train or 0)
    points = []
    for n in counts:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        points.append(_rooms_point(args, device, n, sync))
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    head = points[-1]
    detail = {
        "seed": args.seed,
        "device": str(device),
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "ticks_timed": int(args.rooms_ticks),
        "tick_train": train_k,
        "binning": binning_mode(),
        "all_gates": all(
            p["dropped_rows"] == 0 and p["unexplained_recompiles"] == 0
            and p.get("train_dispatch_gate", True) and p.get("digest_parity", True)
            for p in points),
        "launches_per_tick": head["launches_per_tick"],
        "points": points,
    }
    if device.type == "cuda":
        detail.update(card_identity())
        detail["peak_mem_bytes"] = max(p["peak_mem_bytes"] for p in points)
    return {
        "metric": ("rooms_train_room_ticks_per_sec" if train_k > 1
                   else "rooms_room_ticks_per_sec"),
        "value": head["train_room_ticks_per_sec"] if train_k > 1 else head["room_ticks_per_sec"],
        "unit": "room-ticks/s",
        "detail": detail,
    }


def build_served_role(n: int, sessions: int, device: torch.device, *, seed: int = 42,
                      combat: bool = True, interest_radius: Optional[float] = None,
                      serve_batch: Optional[bool] = None,
                      serve_overlap: Optional[bool] = None,
                      tick_train: Optional[int] = None, graph_tick: Optional[bool] = None,
                      world: Optional[GameWorld] = None):
    """``run_served``'s role: ``build_benchmark_world(n)`` with a Player
    bank for ``sessions`` avatars, a ``GameRole`` over it, and ``sessions``
    sessions seated as bench.py seats them (avatar at the origin of scene
    1, group 0; conns 1000..1007).  Returns ``(role, sent)``: ``sent``
    counts the messages and bytes handed to the transport."""
    from .core.datatypes import next_pow2
    from .net.roles.base import RoleConfig
    from .net.roles.game import GameRole, Session
    from .net.wire import Ident, ident_key

    if world is None:
        world = build_benchmark_world(n, combat=combat, seed=seed,
                                      player_capacity=next_pow2(sessions + 8, lo=64),
                                      device=device)
    role = GameRole(RoleConfig(6, 0, "BenchGame", "127.0.0.1", 0), backend="py",
                    world=world, cross_server_sync=False, interest_radius=interest_radius,
                    serve_batch=serve_batch, serve_overlap=serve_overlap,
                    tick_train=tick_train, graph_tick=graph_tick)
    sent = {"msgs": 0, "bytes": 0}

    def count_send(conn_id: int, msg_id: int, body: bytes) -> bool:
        sent["msgs"] += 1
        sent["bytes"] += len(body)
        return True

    role.server.send_raw = count_send
    for i in range(sessions):
        ident = Ident(svrid=99, index=i + 1)
        sess = Session(ident=ident, conn_id=1000 + (i % 8), account=f"bot{i}")
        g = role.kernel.create_object("Player", {"Name": f"Bot{i}"}, scene=1, group=0)
        sess.guid = g
        role.sessions[ident_key(ident)] = sess
        role._guid_session[g] = ident_key(ident)
    return role, sent


def serve_frames(role, frames: int, now: float, sync: Callable[[], None]):
    """``frames`` frames of ``role.execute``, each ended by ``sync()``;
    returns (per-frame ms, the clock after the last frame)."""
    dt = role.game_world.config.dt * 1.0001  # beat float >= dt jitter
    ms = []
    for _ in range(frames):
        now += dt
        t0 = time.perf_counter()
        role.execute(now)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms, now


def run_served(args, device: torch.device) -> dict:
    """The served path: the tick with host observation plus the role's
    per-frame flush (diff fetch, interest lanes, encode, fan-out)."""
    n = int(args.entities)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    role, sent = build_served_role(
        n, int(args.sessions), device, seed=args.seed, combat=not args.no_combat,
        interest_radius=args.interest_radius, serve_batch=args.serve_batch or None,
        serve_overlap=args.serve_overlap or None, tick_train=args.train or None)
    # warm-up: captures and the first full flush
    _ms, now = serve_frames(role, 3, 1000.0, sync)
    sent["msgs"] = sent["bytes"] = 0
    t_all = time.perf_counter()
    frame_ms, now = serve_frames(role, int(args.ticks), now, sync)
    elapsed = time.perf_counter() - t_all
    frame_hist = role.telemetry.registry.histogram(
        "nf_bench_frame_seconds", "served-path frame wall time",
        window=max(512, int(args.ticks)))
    for ms in frame_ms:
        frame_hist.observe(ms / 1e3)
    p50, p95, p99 = _hist_pcts(frame_hist)
    ticks = int(args.ticks) * max(1, role.tick_train)
    out = {
        "metric": "served_entity_ticks_per_sec",
        "value": round(n * ticks / elapsed, 1),
        "unit": "entity-ticks/s",
        "detail": {
            "entities": n, "frames": int(args.ticks), "ticks": ticks, "seed": args.seed,
            "sessions": int(args.sessions), "elapsed_s": round(elapsed, 4),
            "frame_ms_p50": p50, "frame_ms_p95": p95, "frame_ms_p99": p99,
            "sync_msgs": sent["msgs"], "sync_bytes": sent["bytes"],
            "interest_radius": args.interest_radius,
            "serve_batch": bool(role.serve_batch), "serve_overlap": bool(role.serve_overlap),
            "tick_train": int(role.tick_train), "combat": not args.no_combat,
            "device": str(device), "binning": binning_mode(),
            "pipeline": role.pipeline_stats(),
            "costbook": costbook_detail(role.kernel.costbook, device),
        },
    }
    if device.type == "cuda":
        out["detail"].update(card_identity())
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m noahgameframe_tpu_torch.bench")
    ap.add_argument("--entities", type=int, default=1_000_000)
    ap.add_argument("--ticks", type=int, default=90)
    ap.add_argument("--seed", type=int, default=42,
                    help="world seed; recorded in the line so a run can be repeated")
    ap.add_argument("--train", type=int, default=0, metavar="K",
                    help="time K-tick observed trains instead of run_device (0/1 = off)")
    ap.add_argument("--lat-k", type=int, default=0,
                    help="ticks per fused latency window; 0 = sized for ~1.6 s windows")
    ap.add_argument("--lat-budget-s", type=float, default=20.0,
                    help="wall budget of the windowed latency pass (24 to 256 windows)")
    ap.add_argument("--no-combat", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU runs only when asked for by name")
    ap.add_argument("--rooms", action="store_true",
                    help="run the many-worlds rooms ladder instead of the world tick")
    ap.add_argument("--rooms-count", default="256,4096,16384", metavar="R,R,...",
                    help="rooms ladder rungs (rooms per batch)")
    ap.add_argument("--rooms-entities", type=int, default=64,
                    help="per-room NPC capacity (half of it seeded live)")
    ap.add_argument("--rooms-ticks", type=int, default=30,
                    help="individually timed batch ticks per rung (the fused "
                         "window runs 2x this)")
    ap.add_argument("--rooms-churn", type=int, default=8,
                    help="re-homes rotated through the spare slot per rung")
    ap.add_argument("--served", action="store_true",
                    help="time the game role's served frame (tick + diff flush + "
                         "fan-out) instead of the world tick")
    ap.add_argument("--sessions", type=int, default=50,
                    help="served: sessions, each with a live Player avatar")
    ap.add_argument("--interest-radius", type=float, default=None,
                    help="served: per-session interest-filtered Position streams "
                         "instead of group-wide broadcast")
    ap.add_argument("--serve-batch", action="store_true",
                    help="served: the batched serve engine (NF_SERVE_BATCH)")
    ap.add_argument("--serve-overlap", action="store_true",
                    help="served: serve the pre-tick snapshot while the tick runs "
                         "(NF_SERVE_OVERLAP; implies --serve-batch)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench: error: {e}", file=sys.stderr)
        return 2
    run = run_rooms if args.rooms else run_served if args.served else run_bench
    print(json.dumps(run(args, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
