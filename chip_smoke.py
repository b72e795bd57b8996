#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (noahgameframe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without printing a result:

1. the card's name and power limit (nvidia-smi), then the build of the
   CUDA kernels from csrc/stencil.cu (seconds, ptxas resource lines:
   registers, shared memory, spills);
2. each kernel against its plain PyTorch version on the card, bit for bit
   (tolerance 0, every output slot), on random tables at the 1M-entity
   geometry and on edge cases (attack ties, a one-cell siege, bucket
   overflow, grid widths 1, 2, TX + 1 and 13, the Kv = 128 / Ka = 48
   boost ceiling, the chunk kernels, empty slots reached from the
   origin, inputs at a 4-byte offset), with times;
3. the main path, with (a): ``build_benchmark_world(1_000_000)`` on
   ``cuda`` under the default engine 1; ``run_device(90)`` as a CUDA
   graph (the default) and as the eager loop from the same state land on
   the same ``state_digest``; tick times (median and mean), the drain
   after the host's last launch, launches per tick, busy share, and each
   kernel's launches in the graph run (counted per replay);
(b) ``NF_BINNING=count`` against ``sort`` under engines 0, 1 and 2: one
   digest after 30 graph ticks from the same state, and each setting's
   tick time;
(d) ``train(K=8)`` against ``tick()``: equal counters and digests over 16
   observed ticks (after 20 that settle the overflow auto-resize), and
   the train's peak memory;
4. 30 observed ticks at 1M under engines 0, 1 and 2 from the same state
   give identical ``state_digest`` streams (the engine-2 run is kernel
   2's path);
(c) ``NF_VERLET_SKIN=2.0`` at 1M under engines 1 and 2: graph (sort and
   count binning) and eager runs of 30 ticks give equal digests and equal
   rebuild/reuse counts;
5. ``build_benchmark_world(4096)`` gives the same digest stream for 60
   ticks on ``cuda`` and on ``cpu``;
(e) one run of the bench entry (``python -m noahgameframe_tpu_torch.bench``)
   at 1M, its JSON line printed on a line of its own;
(f) many-worlds rooms at R = 16,384 (parallel/rooms.py ``RoomBatch``, the
   rooms recipe of the JAX package's bench: 64 NPC rows, 32 seeded, skin
   2.0): all rooms admitted into one batch; 30 ticks as the CUDA graph of
   the vmapped step under engines 1, 0 and 2 from the same state land on
   equal ``[R]`` digest lanes, which equal single-room control worlds
   ticked with ``run_device`` (first, middle and last room); the profiler
   sees exactly one fold-kernel launch per replayed rooms tick (engines 1
   and 2); ``train(K=8)`` equals ``tick()`` over 16 ticks; a churn
   (destroy, create into the recycled slot, re-home) drops no row and
   re-captures nothing; then the bench's rooms ladder (``--rooms``), its
   line printed.  Phase 2 also holds each kernel's room axis: at the
   rooms geometry (R = 16,384, 10 x 10 cells, Kv = 8, Ka = 6) and at R = 3
   with width 13, one batched launch equals a loop of one launch a room
   and the vmapped plain version, bit for bit, with times and bounds;
(g) persistence at 1M (run after phase 5): the main path's world, its
   digest on, settles 20 observed frames and 10 graph ticks, saves
   (``GameWorld.save``: the D2H and npz-write split, bytes on disk), then
   ticks 30 observed frames and a 30-tick graph run (stream A); rewound by
   ``load`` it repeats both with no new capture (stream B); a second 1M
   world of the recipe, settled the same 20 frames, loads the checkpoint
   and ticks stream A under engine 1 (C) and engine 2 (D), and a graph run
   after a load ends on C's last digest; a checkpoint saved on the card at
   4,096 NPCs resumes on the CPU with an equal stream; and the host
   plane's times at 1M (a create, a write, a destroy; 32 players saved and
   reloaded by a PlayerDataAgent on FileKV, each equal to what was saved),
   with the card's name and power limit.  The kernel table gains each
   kernel's launches in the resumed runs (``resumed_launches``);
(h) the scene and host layer at 1M (run after (f)): two worlds of the
   main path's recipe (engine 1, sort, no skin, digest on, settled 20
   observed frames, the same seed, so the same state) take the same
   seeded script of host operations in six batches (40 NPCs destroyed, a
   second scene with four seeds, eight groups seeding 32 NPCs into the
   recycled rows, 32
   players entering and swapping groups and a clone scene, 96 skills,
   timers, add_exp across two level-ups, the stat API, two group
   releases, a forced ``LastAttacker`` diff column, record-diff
   subscribers on ``CommPropertyValue``, ``arm_all(stagger=False)``),
   with 10 observed ticks after each: world A as one graph train a
   batch, world B as eager ticks.  Their digest streams, subscriber logs
   (scene hooks, class events, property rows, record codes, host record
   ops) and scene answers are equal; A re-captured once per invalidating
   op, each with its cause; one ``combat_fold`` a replayed tick.  Then
   engine 2 (graph) against engine 1 (eager) over 30 ticks of the
   script's end state, the graph tick and the observed graph tick before
   and after the subscribers (with the record diff's byte bound), the
   median host time of each op kind, and the script at 4,096 NPCs on
   cuda and on cpu with equal streams, logs and answers.  Last, BASELINE
   config 3 (``neighbor_counts`` over 500k NPCs) and the interest query
   of 4,096 observers over the 1M world (fresh and Verlet-cached), each
   equal to the CPU and timed.  The kernel table gains each kernel's
   launches on this path (``host_layer_launches``);
(i) the served path (run last): the game role's frame
   (``GameRole.execute``: the tick as a CUDA graph, the diff harvest, the
   interest lanes, encode and send) at 100,000 NPCs and 500 sessions
   (radius 8.0, combat on, engine 1, sort, sessions seated as bench.py
   seats them) under the legacy, batched, overlap and ``NF_TICK_TRAIN=8``
   engines, then the batched engine under engine 2 and at 1M NPCs: frame
   p50/p95/p99, messages and bytes, the exclusive stage waterfall, host
   syncs a frame (CUDA's sync debug mode), each fold's launches (once per
   tick served, plus the eager warm-up runs of any re-capture in the
   window) and the re-captures with their causes.  The legacy and batched
   engines send byte-equal streams at 100k (sessions at seeded spots);
   at 4,096 NPCs and 32 sessions the card and the CPU (batched, overlap
   and train engines), and the graph and the eager tick, send equal
   streams with equal digests; a journal of 60
   frames recorded on the card replays digest-clean on the card and on
   the CPU, and a perturbed replay is bisected to the injected tick; then
   the bench's ``--served`` line at 100k and 500 sessions.  The kernel
   table gains each kernel's launches on this path (``served_launches``);
(j) the five-role cluster (run after (i)): ``LocalCluster(backend="auto",
   http_port=0, n_games=2, device="cuda")`` over two 100,000-NPC worlds
   of the served recipe (radius 8, batched serving, graph ticks, a WAL and
   a checkpoint dir a game): 64 ``GameClient``s log in through login,
   world, proxy and game (the master's ``/json`` lists the five roles);
   tests/test_roles.py's flows; 64 chats' round trip and each game's
   frame p50/p99; 8 switches from Game1 to Game2; a failover as
   scripts/failover_smoke.run does (24 sessions re-homed from the WAL,
   no drop, chat replayed in order); chaos and a revive as
   scripts/chaos_smoke.run does, the revived banks equal to a control
   world's, with the device memory around two kill/revive cycles; the
   login and chat again under ``NF_PALLAS=2``; the lease cadence, the
   longest pump round and every lease expiry; and a lockstep script at
   4,096 NPCs and 8 clients on the card and on the CPU with equal digests
   and client logs (``phase_cluster``).  The kernel table gains each
   kernel's launches on this path (``cluster_launches``);
(k) the gameplay middleware (run after (i)): the served recipe at
   100,000 NPCs built as ``GameWorld(WorldConfig(middleware=True))``
   (player capacity 512), under a game role (radius 8, batched serving,
   a graph tick) with 500 sessions; each avatar's script goes through the
   role's dispatch as client messages, a step a frame: shop buys of a
   potion, a token, an equip, a gem and a hero card, using the potion and
   the token, socketing the gem into the equip, wearing and taking it off,
   the card's hero set to fight, a kill task accepted (each avatar's
   ``slash`` kills an NPC; the kill event credits whichever attacker the
   tick stamps) and its award drawn, a team of five and one of 10 guilds,
   an SLG farm bought, upgraded (1 s) and collected; two timed buffs, a
   mail with an item (sent and drawn) and a rank update go through the
   host API, as neither package has client messages for them.  Each
   avatar's resulting state is checked.  Printed: frame p50/p99 with the
   stage waterfall beside (i)'s batched frame, the handlers' ms, the
   buff phase's ms by CUDA events at 100k and on a 1M middleware world
   (with its least bytes), the 1M graph tick with the stack against
   phase 3's tick without it, ``TaskModule._on_kills``' host ms a frame, the
   re-captures and their causes, and each fold's launches (ticks served
   plus warm-ups).  Held: a checkpoint of the 100k middleware world loads
   into a fresh one with equal banks, module state and next 30 digests;
   the script under ``NF_PALLAS=2`` (100 sessions) launches
   ``fused_neighborhood``; at
   4,096 NPCs and 32 sessions the card and the CPU send equal streams
   with equal digests, module state and credited killers.  The kernel
   table gains each kernel's launches on this path
   (``middleware_launches``).

Then the kernel table line and, last, the result line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this file, it fails before printing any result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from noahgameframe_tpu_torch.core import tree
from noahgameframe_tpu_torch.core.prng import prng_key
from noahgameframe_tpu_torch.game import world as gw
from noahgameframe_tpu_torch.game.defines import STAT_NAMES, PropertyGroup
from noahgameframe_tpu_torch.kernel import scene as gsc
from noahgameframe_tpu_torch.kernel import kernel as km
from noahgameframe_tpu_torch.ops import stencil as sc
from noahgameframe_tpu_torch.ops import stencil_cuda as sck
from noahgameframe_tpu_torch.parallel import rooms
from noahgameframe_tpu_torch.persist import FileKV, PlayerDataAgent
from noahgameframe_tpu_torch.telemetry.costbook import WARMUP_RUNS

# published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32
# rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float32 operations per occupied pair: 2 subtractions, 1 multiply, 1 fma
FLOPS_PER_PAIR = 5

N_MAIN = 1_000_000
N_AOI = 500_000  # BASELINE config 3's AOI scan
ROOMS_MAIN = 16_384  # the rooms path: 16,384 rooms of 64 NPC rows
SEED = 0
DEV = "cuda"


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``t``, the script's
    seconds when the phase ended."""
    if "phase" in obj:
        obj = {**obj, "t": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int = 20, warmup: int = 3, graph: bool = False) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events).  With
    ``graph`` the ``reps`` calls are captured in one CUDA graph and the
    replay is timed, so the host's time per call (Python, the custom op's
    dispatch) is not counted: a kernel's own time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run = None
    if graph:
        g = torch.cuda.CUDAGraph()
        gc.collect()  # no dropped graph may be destroyed mid-capture
        gc.disable()
        try:
            with torch.cuda.graph(g):
                for _ in range(reps):
                    fn()
        finally:
            gc.enable()
        g.replay()
        run = g.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if run is not None:
        run()
    else:
        for _ in range(reps):
            fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int, flops: int):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2 -------------------------------------------------------------------


def cell_counts(slot_of: torch.Tensor, width: int, bucket: int) -> torch.Tensor:
    """[H, W] occupied slots per cell of a slot assignment (rows in the
    dump slot are not placed)."""
    placed = slot_of[slot_of < width * width * bucket].long() // bucket
    return torch.bincount(placed, minlength=width * width).reshape(width, width)


def nbhd_sum(c: torch.Tensor) -> torch.Tensor:
    """Sum of c over each cell's 3x3 neighbourhood, zero beyond the grid."""
    h, w = c.shape
    p = torch.nn.functional.pad(c, (1, 1, 1, 1))
    return sum(p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3))


def population(n, cap, extent, seed, *, clump=None, atk_hi=30, duty=1 / 30,
               scenes=1, groups=1, origin=0, dev="cuda"):
    """A random combat population on ``cap`` rows (the first ``n`` alive).
    ``origin`` > 0 puts that many attacking scene-0, group-0 entities
    within 3 units of (0, 0), where they reach the all-zero rows of empty
    victim slots."""
    rng = np.random.default_rng(seed)
    lo, hi = clump if clump is not None else (0.0, extent)
    pos = np.zeros((cap, 2), np.float32)
    pos[:n] = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    alive = np.zeros(cap, bool)
    alive[:n] = True
    attacking = alive & (rng.random(cap) < duty)
    atk = rng.integers(1, atk_hi + 1, cap).astype(np.float32)
    camp = rng.integers(0, 2, cap).astype(np.float32)
    scene = rng.integers(1, scenes + 1, cap).astype(np.float32)
    group = rng.integers(0, groups, cap).astype(np.float32)
    if origin:
        pos[:origin] = rng.uniform(0.0, 3.0, (origin, 2)).astype(np.float32)
        scene[:origin], group[:origin], camp[:origin] = 0.0, 0.0, 1.0
        attacking[:origin] = True
    eff = np.where(attacking, atk, 0.0).astype(np.float32)
    rows = np.arange(cap, dtype=np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return dict(
        pos=t(pos), alive=t(alive), attacking=t(attacking),
        vic=t(np.stack([pos[:, 0], pos[:, 1], camp, scene, group], -1)),
        att=t(np.stack([pos[:, 0], pos[:, 1], eff, camp, scene, group, rows], -1)),
        bank=t(np.stack([pos[:, 0], pos[:, 1], camp, scene, group, eff], -1)),
    )


def misalign(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` at a 4-byte offset from an 8-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    out.copy_(t)
    return out


def kernels_vs_plain(pop, cell, width, kv, ka, radius, timed: bool, plans=None,
                     unaligned=False):
    """Both kernels against their plain versions on one population, every
    output slot compared; ``plans`` = (combat, fused) FoldPlans to launch
    under instead of the planner's; ``unaligned`` hands the kernels their
    inputs at a 4-byte offset.  The row tables are compared with
    ``slot_rows`` too."""
    vt, at = sc.build_cell_table_pair(pop["pos"], pop["alive"], pop["vic"],
                                      pop["attacking"], pop["att"], cell, width, kv, ka)
    vs, ats = sc.build_cell_slots_pair(pop["pos"], pop["alive"], pop["attacking"],
                                       cell, width, kv, ka)
    check(torch.equal(vt.slot_of, vs.slot_of) and torch.equal(at.slot_of, ats.slot_of),
          "table and slot builders place rows identically")
    n = pop["bank"].shape[0]
    plans = plans or (sck.plan_fold("combat", width, kv, ka),
                      sck.plan_fold("fused", width, kv, ka))
    kt, bank = (vt, at), pop["bank"]
    if unaligned:
        kt = (vt._replace(payload=misalign(vt.payload)), at._replace(payload=misalign(at.payload)))
        bank = misalign(bank)
        check(bank.data_ptr() % 8 == 4, "the unaligned case is unaligned")
    k1 = sck.combat_fold_planned(*kt, radius, plans[0])
    p1 = sck.combat_fold_plain(vt, at, radius)
    k2 = sck.fused_neighborhood_planned(bank, vs, ats, radius, plans[1])
    p2 = sck.fused_neighborhood_plain(pop["bank"], vs, ats, radius)
    for tab, slots in zip(sck.row_tables(vs, ats, n), (vs, ats)):
        check(torch.equal(torch.where(tab == 0, n, tab - 1), sck.slot_rows(slots, n)),
              "row tables equal slot_rows")
    torch.cuda.synchronize()
    err1 = max(int((a.long() - b.long()).abs().max()) for a, b in zip(k1, p1))
    err2 = max(int((a.long() - b.long()).abs().max()) for a, b in zip(k2, p2))
    check(err1 == 0, "combat_fold kernel equals its plain version")
    check(err2 == 0, "fused_neighborhood kernel equals its plain version")
    check(torch.equal(k1[0], k2[0]) and torch.equal(k1[1], k2[1]),
          "split and fused kernels agree on damage and best attacker")
    empty = vt.grid_view()[..., sck.V_FEATS] == 0
    out = {"vic_dropped": int(vt.dropped), "att_dropped": int(at.dropped),
           "hits": int((k1[0] > 0).sum()), "empty_slot_hits": int(((k1[0] > 0) & empty).sum()),
           "empty_slot_nbr": int(((k2[2] > 0) & empty).sum()), "err": [err1, err2],
           "plans": [[p.ty, p.tx, p.threads, p.smem, p.chunk] for p in plans]}
    if not timed:
        return out
    n_slots = width * width * kv
    occ_v = cell_counts(vs.slot_of, width, kv)
    occ_a = cell_counts(ats.slot_of, width, ka)
    # the work this run's data needs: a pair is an occupied victim slot
    # and an occupied candidate in its 3x3 neighbourhood (empty slots fold
    # as neutral elements); the fused fold also counts AOI pairs among
    # victims, self excluded
    pairs1 = int((occ_v * nbhd_sum(occ_a)).sum())
    pairs2 = pairs1 + int((occ_v * nbhd_sum(occ_v)).sum() - occ_v.sum())
    # bytes: the payload columns the fold reads (not the occupancy column),
    # the bank and the two slot assignments, and the int32 outputs
    b1 = bound_ms(4 * (width * width * (kv * sck.V_FEATS + ka * sck.A_FEATS))
                  + 2 * n_slots * 4, FLOPS_PER_PAIR * pairs1)
    b2 = bound_ms(pop["bank"].nbytes + vs.slot_of.nbytes + ats.slot_of.nbytes
                  + 3 * n_slots * 4, FLOPS_PER_PAIR * pairs2)
    out["timing"] = {
        "combat_fold": dict(
            ms=time_ms(lambda: sck.combat_fold(vt, at, radius), graph=True),
            # the eager wrapper, the custom op's host dispatch included
            eager_ms=time_ms(lambda: sck.combat_fold(vt, at, radius)),
            plain_ms=time_ms(lambda: sck.combat_fold_plain(vt, at, radius), reps=5),
            bound_ms=b1[0], bound_by=b1[1], pairs=pairs1),
        "fused_neighborhood": dict(
            ms=time_ms(lambda: sck.fused_neighborhood(pop["bank"], vs, ats, radius),
                       graph=True),
            eager_ms=time_ms(lambda: sck.fused_neighborhood(pop["bank"], vs, ats, radius)),
            plain_ms=time_ms(
                lambda: sck.fused_neighborhood_plain(pop["bank"], vs, ats, radius), reps=5),
            bound_ms=b2[0], bound_by=b2[1], pairs=pairs2,
            # the wrapper's row-table build, part of its ms above
            row_tables_ms=time_ms(lambda: sck.row_tables(vs, ats, n), graph=True)),
    }
    return out


def phase_kernels():
    """Random tables at the 1M geometry, plus ties, a siege, overflow, grid
    widths around the tile (1, 2, TX + 1, not a multiple of the tile), a
    dense clump at the boost ceiling (Kv = 128, Ka = 48), the chunk
    kernels (planned for Kv = Ka = 1024, and forced with 7-slot chunks)
    and empty victim slots within reach of entities at the origin."""
    cap = 1 << int(np.ceil(np.log2(N_MAIN)))
    extent = float(np.sqrt(N_MAIN / 0.4))
    cell, radius = 4.0, 4.0
    width = int(extent / cell)
    kv = sc.auto_bucket(cap, width)
    ka = sc.auto_bucket(int(np.ceil(cap / 30)), width, lo=4, align=2)
    tx = sck.plan_fold("combat", width, kv, ka).tx
    forced = (sck.FoldPlan("combat", 5, 1, 1, 64, 7 * 32 + 16, 7),
              sck.FoldPlan("fused", 5, 1, 1, 64, 7 * 28, 7))
    # name -> (population, width, kv, ka, timed, plans); "unaligned" hands
    # the kernels inputs at a 4-byte offset
    cases = {
        "random_1m": (population(N_MAIN, cap, extent, 1), width, kv, ka, True, None),
        "ties_1m": (population(N_MAIN, cap, extent, 2, atk_hi=1, duty=0.2,
                               scenes=2, groups=2), width, kv, ka, False, None),
        "siege": (population(4000, 4096, 40.0, 3, clump=(8.5, 11.5), duty=0.5),
                  10, 16, 8, False, None),
        "overflow": (population(20000, 1 << 15, 40.0, 4, duty=0.3), 10, 4, 4, False, None),
        "width_1": (population(60, 64, 4.0, 5, duty=0.5), 1, 64, 32, False, None),
        "width_2": (population(120, 128, 8.0, 6, duty=0.5, scenes=2), 2, 32, 16, False, None),
        "width_tx_plus_1": (population(1300, 2048, 4.0 * (tx + 1), 7, duty=0.2),
                            tx + 1, kv, ka, False, None),
        "width_13": (population(2700, 4096, 52.0, 8, duty=0.2, groups=2), 13, kv, ka,
                     False, None),
        "dense_boost_ceiling": (population(6000, 8192, 24.0, 9, clump=(0.0, 24.0), duty=0.3),
                                6, 128, 48, False, None),
        "chunk_planned": (population(2500, 4096, 12.0, 10, duty=0.5), 3, 1024, 1024,
                          False, None),
        "chunk_forced": (population(1500, 2048, 20.0, 11, duty=0.5, origin=5), 5, 100, 60,
                         False, forced),
        "origin": (population(600, 1024, 40.0, 12, duty=0.3, scenes=2, origin=12),
                   10, 16, 8, False, None),
        "unaligned": (population(600, 1024, 40.0, 13, duty=0.3, scenes=2, origin=6),
                      10, 16, 8, False, None),
    }
    results, timing = {}, None
    for name, (pop, w, k_v, k_a, timed, plans) in cases.items():
        c = cell if name.endswith("1m") else 4.0
        r = kernels_vs_plain(pop, c, w, k_v, k_a, radius, timed, plans,
                             unaligned=name == "unaligned")
        if timed:
            timing = r.pop("timing")
        results[name] = r
    check(results["siege"]["vic_dropped"] > 0, "the siege overflows its cell")
    check(results["overflow"]["vic_dropped"] > 0, "the overflow case drops rows")
    check(all(p[4] > 0 for p in results["chunk_planned"]["plans"]),
          "Kv = Ka = 1024 plans the chunk kernels")
    check(all(p[4] == 0 for p in results["dense_boost_ceiling"]["plans"]),
          "the boost ceiling runs tiled")
    for name in ("origin", "chunk_forced"):
        check(results[name]["empty_slot_hits"] > 0 and results[name]["empty_slot_nbr"] > 0,
              f"{name}: empty victim slots have non-trivial outputs")
    emit({"phase": "kernels_vs_plain", "tolerance": 0, "geometry": {
        "width": width, "kv": kv, "ka": ka, "capacity": cap}, "cases": results,
        "timing_1m": timing})
    max_err = {"combat_fold": max(r["err"][0] for r in results.values()),
               "fused_neighborhood": max(r["err"][1] for r in results.values())}
    return timing, max_err


# -- phase 2: the kernels' room axis --------------------------------------------


def room_population(rooms_n, cap, alive_n, extent, seed, *, duty, origin_rooms=0):
    """``rooms_n`` independent combat populations of ``cap`` rows (the first
    ``alive_n`` alive) as ``[R, cap, ...]`` tensors.  The first
    ``origin_rooms`` rooms put two attacking scene-0, group-0 entities
    within 3 units of (0, 0), within reach of empty victim slots."""
    rng = np.random.default_rng(seed)
    shape = (rooms_n, cap)
    pos = np.zeros(shape + (2,), np.float32)
    pos[:, :alive_n] = rng.uniform(0.0, extent, (rooms_n, alive_n, 2)).astype(np.float32)
    alive = np.zeros(shape, bool)
    alive[:, :alive_n] = True
    attacking = alive & (rng.random(shape) < duty)
    atk = rng.integers(1, 31, shape).astype(np.float32)
    camp = rng.integers(0, 2, shape).astype(np.float32)
    scene = np.ones(shape, np.float32)
    group = np.zeros(shape, np.float32)
    o = min(origin_rooms, rooms_n)
    if o:
        pos[:o, :2] = rng.uniform(0.0, 3.0, (o, 2, 2)).astype(np.float32)
        scene[:o, :2], camp[:o, :2] = 0.0, 1.0
        attacking[:o, :2] = True
    eff = np.where(attacking, atk, 0.0).astype(np.float32)
    rows = np.broadcast_to(np.arange(cap, dtype=np.float32), shape)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    return dict(
        pos=t(pos), alive=t(alive), attacking=t(attacking),
        vic=t(np.stack([pos[..., 0], pos[..., 1], camp, scene, group], -1)),
        att=t(np.stack([pos[..., 0], pos[..., 1], eff, camp, scene, group, rows], -1)),
        bank=t(np.stack([pos[..., 0], pos[..., 1], camp, scene, group, eff], -1)),
    )


def room_cell_counts(slot_of: torch.Tensor, width: int, bucket: int) -> torch.Tensor:
    """[R, H, W] occupied slots per cell of each room's slot assignment."""
    r, cells = slot_of.shape[0], width * width
    cell = torch.where(slot_of < cells * bucket, slot_of.long() // bucket, cells)
    flat = (torch.arange(r, device=slot_of.device)[:, None] * (cells + 1) + cell).reshape(-1)
    counts = torch.bincount(flat, minlength=r * (cells + 1)).reshape(r, cells + 1)
    return counts[:, :cells].reshape(r, width, width)


def room_nbhd_sum(c: torch.Tensor) -> torch.Tensor:
    """:func:`nbhd_sum` of each room's [H, W] counts."""
    h, w = c.shape[-2:]
    p = torch.nn.functional.pad(c, (1, 1, 1, 1))
    return sum(p[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3))


def room_kernels_vs_plain(pop, cell, width, kv, ka, radius, timed: bool):
    """Both kernels over R rooms in one batched launch each (the vmap rules
    of ``ops/stencil_cuda.py``), against a loop of one launch a room and
    against the vmapped plain versions, every output slot compared."""
    vmap = torch.func.vmap

    def build(pos, alive, attacking, vic, att):
        vt, at = sc.build_cell_table_pair(pos, alive, vic, attacking, att, cell, width, kv, ka)
        return vt.payload, at.payload, vt.slot_of, at.slot_of, vt.dropped

    def tables(v, a):
        return (sc.CellTable(v, None, None, width, cell, kv),
                sc.CellTable(a, None, None, width, cell, ka))

    def slots(v, a):
        return sc.CellSlots(v, None, width, cell, kv), sc.CellSlots(a, None, width, cell, ka)

    bank = pop["bank"]
    n_rooms = bank.shape[0]
    with rooms.no_vmap_fallback():
        vp, ap, vs, as_, vdrop = vmap(build)(pop["pos"], pop["alive"], pop["attacking"],
                                             pop["vic"], pop["att"])
        before = {k: c.launches for k, c in sck.KERNELS.items()}
        k1 = vmap(lambda v, a: sck.combat_fold(*tables(v, a), radius))(vp, ap)
        k2 = vmap(lambda b, v, a: sck.fused_neighborhood(b, *slots(v, a), radius))(bank, vs, as_)
        after = {k: c.launches for k, c in sck.KERNELS.items()}
        p1 = vmap(lambda v, a: sck.combat_fold_plain(*tables(v, a), radius))(vp, ap)
        p2 = vmap(lambda b, v, a: sck.fused_neighborhood_plain(b, *slots(v, a), radius))(
            bank, vs, as_)
    check(all(after[k] == before[k] + 1 for k in before),
          "one batched launch per kernel for all rooms")
    loop1 = [sck.combat_fold(*tables(vp[r], ap[r]), radius) for r in range(n_rooms)]
    loop2 = [sck.fused_neighborhood(bank[r], *slots(vs[r], as_[r]), radius)
             for r in range(n_rooms)]
    torch.cuda.synchronize()
    err1 = max(int((a.long() - b.long()).abs().max()) for a, b in zip(k1, p1))
    err2 = max(int((a.long() - b.long()).abs().max()) for a, b in zip(k2, p2))
    check(err1 == 0, "batched combat_fold equals the vmapped plain version")
    check(err2 == 0, "batched fused_neighborhood equals the vmapped plain version")
    check(all(torch.equal(k1[i], torch.stack([x[i] for x in loop1])) for i in range(2)),
          "batched combat_fold equals a loop of one launch a room")
    check(all(torch.equal(k2[i], torch.stack([x[i] for x in loop2])) for i in range(3)),
          "batched fused_neighborhood equals a loop of one launch a room")
    del loop1, loop2
    out = {"rooms": n_rooms, "width": width, "kv": kv, "ka": ka,
           "vic_dropped": int(vdrop.sum()), "hits": int((k1[0] > 0).sum()),
           "nbr_pairs": int(k2[2].sum()), "err": [err1, err2]}
    if not timed:
        return out
    cells = width * width
    plans = (sck.plan_fold("combat", width, kv, ka), sck.plan_fold("fused", width, kv, ka))
    occ_v = room_cell_counts(vs, width, kv)
    occ_a = room_cell_counts(as_, width, ka)
    pairs1 = int((occ_v * room_nbhd_sum(occ_a)).sum())
    pairs2 = pairs1 + int((occ_v * room_nbhd_sum(occ_v)).sum() - occ_v.sum())
    b1 = bound_ms(4 * n_rooms * cells * (kv * sck.V_FEATS + ka * sck.A_FEATS)
                  + 2 * n_rooms * cells * kv * 4, FLOPS_PER_PAIR * pairs1)
    b2 = bound_ms(bank.nbytes + vs.nbytes + as_.nbytes + 3 * n_rooms * cells * kv * 4,
                  FLOPS_PER_PAIR * pairs2)

    with rooms.no_vmap_fallback():
        def fold1():
            return vmap(lambda v, a: sck.combat_fold(*tables(v, a), radius))(vp, ap)

        def fold2():
            return vmap(lambda b, v, a: sck.fused_neighborhood(
                b, *slots(v, a), radius))(bank, vs, as_)

        ms1, eager1 = time_ms(fold1, graph=True), time_ms(fold1)
        ms2, eager2 = time_ms(fold2, graph=True), time_ms(fold2)
        rows_ms = time_ms(lambda: vmap(lambda v, a: sck.row_tables(
            *slots(v, a), bank.shape[1]))(vs, as_), graph=True)
        plain1 = time_ms(lambda: vmap(lambda v, a: sck.combat_fold_plain(
            *tables(v, a), radius))(vp, ap), reps=5)
        plain2 = time_ms(lambda: vmap(lambda b, v, a: sck.fused_neighborhood_plain(
            b, *slots(v, a), radius))(bank, vs, as_), reps=5)
    out["timing"] = {
        "combat_fold": dict(ms=ms1, eager_ms=eager1, plain_ms=plain1, bound_ms=b1[0], bound_by=b1[1],
                            pairs=pairs1, blocks=n_rooms * plans[0].blocks),
        "fused_neighborhood": dict(ms=ms2, eager_ms=eager2, plain_ms=plain2, bound_ms=b2[0], bound_by=b2[1],
                                   pairs=pairs2, blocks=n_rooms * plans[1].blocks,
                                   row_tables_ms=rows_ms),
    }
    return out


def phase_room_kernels():
    """The room axis at the rooms geometry (R = 16,384 rooms of 64 rows, 32
    alive, 10 x 10 cells of 6.0, Kv = 8, Ka = 6; the rooms recipe's attack
    duty, timed, and a dense variant with entities at the origin) and at R
    = 3 with width 13."""
    cell, radius, width, kv, ka = 6.0, 4.0, 10, 8, 6
    cases = {
        "rooms_16384": (room_population(ROOMS_MAIN, 64, 32, 64.0, 21, duty=1 / 30),
                        cell, width, True),
        "rooms_16384_dense": (room_population(ROOMS_MAIN, 64, 32, 64.0, 22, duty=0.3,
                                              origin_rooms=64), cell, width, False),
        "rooms_3_width_13": (room_population(3, 64, 48, 52.0, 23, duty=0.3, origin_rooms=1),
                             4.0, 13, False),
    }
    results, timing = {}, None
    for name, (pop, c, w, timed) in cases.items():
        r = room_kernels_vs_plain(pop, c, w, kv, ka, radius, timed)
        if timed:
            timing = r.pop("timing")
        results[name] = r
    check(results["rooms_16384_dense"]["hits"] > 0, "the dense rooms fight")
    emit({"phase": "room_kernels_vs_plain", "tolerance": 0, "cases": results,
          "timing_rooms_16384": timing})
    max_err = {"combat_fold": max(r["err"][0] for r in results.values()),
               "fused_neighborhood": max(r["err"][1] for r in results.values())}
    return timing, max_err


# -- phases 3-5 and (a)-(e) ---------------------------------------------------


def free() -> None:
    """Return the memory of dropped worlds to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def snapshot(state):
    """A copy of every leaf of a world state, and its structure."""
    leaves, spec, _ = tree.flatten(state)
    return [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves], spec


def fresh(snap):
    """A new state built from copies of a snapshot's leaves."""
    leaves, spec = snap
    return tree.unflatten(spec, [x.clone() if isinstance(x, torch.Tensor) else x
                                 for x in leaves])


def restore_inplace(kernel, snap) -> None:
    """Copy a snapshot into the kernel state's own tensors (those of a
    captured graph after a graph run), so the next replay binds nothing."""
    for dst, src in zip(tree.flatten(kernel.state)[0], snap[0]):
        if isinstance(dst, torch.Tensor):
            dst.copy_(src)


def digest(kernel) -> int:
    return int(km.state_digest(kernel.state, kernel.store.class_order)) & 0xFFFFFFFF


def profile_ticks(kernel, n: int, *, host_ops: bool, graph: bool) -> dict:
    """:func:`profile_run` over n ``run_device`` ticks."""
    out = profile_run(lambda: kernel.run_device(n, reconcile=False, graph=graph), n,
                      host_ops=host_ops)
    out["graph"] = graph
    return out


def profile_run(run, n: int, *, host_ops: bool) -> dict:
    """torch.profiler over ``run()`` (n ticks): the window's wall time, the
    summed device time of its kernels and copies, their ratio (the card's
    busy share in that window), launches per tick, the launches the
    profiler saw of each hand kernel (``kernel_launches``: a fold kernel
    or its chunk form) and the rows with the most device time (with
    ``host_ops``, the phases' ``nf.*`` ranges among them).  ``host_ops``
    also records the host's ATen calls, at a higher host cost per launch.  Device time 0 means the
    profiler recorded no CUDA activity on this machine."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.key.startswith("aten::"):
            continue  # an operator row repeats its kernels' device time
        dev_us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0) or 0)
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    out = {"ticks": n, "wall_ms": wall_ms, "device_ms": device_ms,
           "busy_share": device_ms / wall_ms if wall_ms else 0.0,
           "device_launches_per_tick": sum(r[2] for r in rows) / n,
           "kernel_launches": {name: sum(r[2] for r in rows if any(
               f"{name}_{form}" in r[1] for form in ("kernel", "chunk_kernel")))
               for name in sck.KERNELS},
           "top": [{"name": k[:80], "ms": us / 1e3, "calls": c} for us, k, c in rows[:14]]}
    if host_ops:
        out["aten_calls_per_tick"] = sum(
            e.count for e in prof.key_averages() if e.key.startswith("aten::")) / n
    return out


def timed_run(kernel, n: int, graph: bool) -> dict:
    """run_device(n) from the host: enqueue time, total time, the drain
    after the host's last launch, and the digest it lands on."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kernel.run_device(n, reconcile=False, graph=graph)
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    return {"ticks": n, "total_s": total_s, "host_enqueue_s": enqueue_s,
            "drain_after_enqueue_ms": (total_s - enqueue_s) * 1e3,
            "mean_tick_ms": total_s / n * 1e3, "digest": digest(kernel)}


def tick_times(kernel, n: int, graph: bool) -> list:
    """Device time of n single run_device ticks, by CUDA events."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    events[0].record()
    for i in range(n):
        kernel.run_device(1, reconcile=False, graph=graph)
        events[i + 1].record()
    events[-1].synchronize()
    return [events[i].elapsed_time(events[i + 1]) for i in range(n)]


def phase_main_path():
    """Phase 3 with (a): the main path (run_device, a CUDA graph by
    default) against the eager loop, 90 ticks each from the same state:
    equal digests, tick times, drain, launches per tick, busy share."""
    t0 = time.perf_counter()
    w = gw.build_benchmark_world(N_MAIN, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    k = w.kernel
    check(w.combat.resolved_engine() == 1, "engine 1 is the default on cuda")
    s0 = snapshot(k.state)

    k.state = fresh(s0)
    eager = timed_run(k, 90, graph=False)
    eager_ticks = tick_times(k, 30, graph=False)
    eager_prof = profile_ticks(k, 10, host_ops=False, graph=False)
    eager_prof_ops = profile_ticks(k, 10, host_ops=True, graph=False)

    t0 = time.perf_counter()
    k.run_device(1, reconcile=False)  # captures the graph, then one replay
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    restore_inplace(k, s0)
    torch.cuda.reset_peak_memory_stats()
    sck.reset_launch_counts()
    graph = timed_run(k, 90, graph=True)
    launches = {name: kk.launches for name, kk in sck.KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(graph["digest"] == eager["digest"], "graph and eager digests equal after 90 ticks")
    check(launches["combat_fold"] == 90, "kernel 1 ran once per tick of the main path")
    graph_ticks = tick_times(k, 30, graph=True)
    MAIN_TICK_MS.append(statistics.median(graph_ticks))
    graph_prof = profile_ticks(k, 10, host_ops=False, graph=True)
    check(graph_prof["device_ms"] > 0, "the profiler recorded the card's activity")
    check(graph_prof["kernel_launches"]["combat_fold"] == 10,
          "the profiler sees one combat_fold kernel per replayed tick")
    cs = k.state.classes["NPC"]
    spec = k.store.spec("NPC")
    hp = cs.i32[:, spec.slot("HP").col]
    pos = cs.vec[:, spec.slot("Position").col, :2]
    check(bool(torch.isfinite(pos).all()), "positions finite")
    check(bool(((hp >= 0) & (hp <= 100)).all()), "HP within [0, MAXHP]")
    book = k.costbook.entry("kernel.run")
    emit({
        "phase": "main_path", "entities": N_MAIN, "engine": 1, "world_build_s": build_s,
        "graph": {**graph, "median_tick_ms": statistics.median(graph_ticks),
                  "entity_ticks_per_s": N_MAIN * 90 / graph["total_s"],
                  "capture_and_first_tick_s": capture_s,
                  "launches_per_tick": k.costbook.launches_per_replay("kernel.run"),
                  "capture": book.last, "peak_mem_gb": peak_gb,
                  "profile_10_ticks": graph_prof},
        "eager": {**eager, "median_tick_ms": statistics.median(eager_ticks),
                  "entity_ticks_per_s": N_MAIN * 90 / eager["total_s"],
                  "profile_10_ticks_device_only": eager_prof,
                  "profile_10_ticks": eager_prof_ops},
        "digests_equal": True, "launches": launches, "hp_total": int(hp.sum()),
    })
    return w, s0, launches


def phase_binning(w, s0):
    """(b): NF_BINNING=count against sort at 1M, under engines 0, 1 and 2:
    30 graph ticks from the same state land on one digest; each knob
    setting's tick time (mean, and median of 10 single ticks)."""
    k = w.kernel
    out = {}
    for engine in (1, 0, 2):
        w.combat.use_pallas = engine
        for mode in ("sort", "count"):
            os.environ["NF_BINNING"] = mode
            k.run_device(1, reconcile=False)  # (re)captures under these knobs
            restore_inplace(k, s0)
            r = timed_run(k, 30, graph=True)
            r["median_tick_ms"] = statistics.median(tick_times(k, 10, graph=True))
            out[f"engine{engine}_{mode}"] = r
    os.environ.pop("NF_BINNING")
    w.combat.use_pallas = None
    check(len({r["digest"] for r in out.values()}) == 1,
          "every engine under count and sort binning lands on one digest after 30 ticks")
    causes = k.costbook.entry("kernel.run").causes
    check(causes.get("static:binning", 0) >= 1, "the binning change re-captured the tick")
    emit({"phase": "binning_count_vs_sort", "entities": N_MAIN, "ticks": 30,
          "digests_equal": True, "runs": out, "recapture_causes": causes})


def lanes_equal(a, b) -> bool:
    """Two TickOutputs' fired, diff, died and event masks are equal."""
    la, sa, _ = tree.flatten((a.fired, a.diff, a.died, [(e.mask, e.params) for e in a.events]))
    lb, sb, _ = tree.flatten((b.fired, b.diff, b.died, [(e.mask, e.params) for e in b.events]))
    return sa == sb and all(torch.equal(x, y) for x, y in zip(la, lb))


def phase_train(w):
    """(d): train(K=8) against tick(): per-tick counters and digests equal
    over 16 observed ticks at 1M, from the same state.  The world is first
    ticked 20 observed frames, so the overflow auto-resize has done its
    work: a resize lands on the next tick in tick() but only after the
    train in train(), and the two would part from there."""
    k = w.kernel
    k.enable_digest()
    boost0 = w.combat._bucket_boost
    w.run(20)
    boost = w.combat._bucket_boost
    s1 = snapshot(k.state)
    k.state = fresh(s1)
    t0 = time.perf_counter()
    tick_outs = [k.tick() for _ in range(16)]
    tick_s = time.perf_counter() - t0
    ticks = [o.counters for o in tick_outs]
    k.state = fresh(s1)
    torch.cuda.reset_peak_memory_stats()
    k.configure_train(8)
    t0 = time.perf_counter()
    first = k.train(8)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = k.train(8)
    train_s = time.perf_counter() - t0
    trained = [o.counters for o in first + second]
    check(w.combat._bucket_boost == boost, "no overflow resize inside the compared window")
    check(trained == ticks, "train(K=8) counters and digests equal tick()'s over 16 ticks")
    check(all(lanes_equal(a, b) for a, b in zip(first + second, tick_outs)),
          "both trains' fired, diff, died and event masks equal tick()'s, read after both ran")
    emit({"phase": "train_vs_tick", "entities": N_MAIN, "k": 8, "ticks": 16,
          "equal": True, "last_digest": trained[-1]["state_digest"] & 0xFFFFFFFF,
          "bucket_boost": [boost0, boost],
          "observed_tick_ms": tick_s / 16 * 1e3, "train_tick_ms": train_s / 8 * 1e3,
          "first_two_trains_s": capture_s, "dispatches": k.train_dispatches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "capture": k.costbook.entry("kernel.train").last})


def digest_stream(n, ticks, engine, device):
    w = gw.build_benchmark_world(n, seed=SEED, device=device)
    w.combat.use_pallas = engine
    w.kernel.enable_digest()
    sck.reset_launch_counts()
    stream, counters = [], []
    t0 = time.perf_counter()
    for _ in range(ticks):
        c = w.tick().counters
        stream.append(c["state_digest"] & 0xFFFFFFFF)
        counters.append({k: v for k, v in c.items() if k != "aoi_interest_pairs"})
    secs = time.perf_counter() - t0
    launches = {name: kk.launches for name, kk in sck.KERNELS.items()}
    del w
    free()
    return stream, counters, launches, secs


def phase_engines(w, s0):
    """Phase 4: 30 observed ticks at 1M under engines 0, 1 and 2 from the
    same state give identical digest streams and counter banks."""
    k = w.kernel
    runs = {}
    for e in (0, 1, 2):
        w.combat.use_pallas = e
        k.state = fresh(s0)
        sck.reset_launch_counts()
        stream, counters = [], []
        t0 = time.perf_counter()
        for _ in range(30):
            c = w.tick().counters
            stream.append(c["state_digest"] & 0xFFFFFFFF)
            counters.append({kk: v for kk, v in c.items() if kk != "aoi_interest_pairs"})
        runs[e] = (stream, counters, {n: kk.launches for n, kk in sck.KERNELS.items()},
                   time.perf_counter() - t0)
    w.combat.use_pallas = None
    s0_, c0 = runs[0][0], runs[0][1]
    for e in (1, 2):
        check(runs[e][0] == s0_, f"engine {e} digest stream equals engine 0's")
        check(runs[e][1] == c0, f"engine {e} counter bank equals engine 0's")
    check(runs[1][2]["combat_fold"] == 30, "engine 1 ran kernel 1 every tick")
    check(runs[2][2]["fused_neighborhood"] == 30, "engine 2 ran kernel 2 every tick")
    check(runs[0][2]["combat_fold"] == runs[0][2]["fused_neighborhood"] == 0,
          "engine 0 launched no kernel")
    emit({"phase": "engine_digest_parity", "entities": N_MAIN, "ticks": 30,
          "digests_equal": True, "last_digest": s0_[-1],
          "launches": {e: runs[e][2] for e in runs},
          "observed_tick_s": {e: runs[e][3] / 30 for e in runs}})


def phase_verlet():
    """(c): NF_VERLET_SKIN=2.0 at 1M under engines 1 and 2: graph and eager
    runs of 30 ticks from the same state land on equal digests with equal
    rebuild and reuse counts; the graph tick under count binning too.
    Returns kernel 2's launches (graph run)."""
    os.environ["NF_VERLET_SKIN"] = "2.0"
    w = gw.build_benchmark_world(N_MAIN, seed=SEED, device="cuda")
    os.environ.pop("NF_VERLET_SKIN")
    k = w.kernel
    check(w.combat.verlet_skin == 2.0 and w.combat.cell_size == 6.0, "the skin widens the cells")
    k.run_device(0, reconcile=False)  # primes the Verlet cache entry
    s0 = snapshot(k.state)
    out, fused_launches = {}, 0
    for e in (1, 2):
        w.combat.use_pallas = e
        name = "combat_fold" if e == 1 else "fused_neighborhood"
        arms = {}
        for arm in ("eager", "graph", "graph_count"):
            graph = arm != "eager"
            if arm == "graph_count":
                os.environ["NF_BINNING"] = "count"
            k.state = fresh(s0)
            if graph:
                k.run_device(1, reconcile=False)  # captures under these knobs
                restore_inplace(k, s0)
                sck.reset_launch_counts()
            r = timed_run(k, 30, graph=graph)
            if arm == "graph" and e == 2:
                fused_launches = sck.KERNELS["fused_neighborhood"].launches
            os.environ.pop("NF_BINNING", None)
            cache = k.state.aux[w.combat.aux_key]
            r.update(rebuilds=int(cache.rebuilds), reuses=int(cache.reuses))
            if arm == "graph":
                prof = profile_ticks(k, 10, host_ops=False, graph=True)
                r["profile_10_ticks"] = prof
                check(prof["kernel_launches"][name] == 10,
                      f"engine {e}: the profiler sees one {name} kernel per replayed tick")
            arms[arm] = r
        for arm in ("graph", "graph_count"):
            check(arms[arm]["digest"] == arms["eager"]["digest"],
                  f"engine {e}: {arm} and eager digests equal (skin 2.0)")
            check((arms[arm]["rebuilds"], arms[arm]["reuses"])
                  == (arms["eager"]["rebuilds"], arms["eager"]["reuses"]),
                  f"engine {e}: {arm} and eager rebuild/reuse counts equal")
        out[e] = arms
    check(fused_launches == 30, "kernel 2 ran once per replayed tick")
    emit({"phase": "verlet_skin_2", "entities": N_MAIN, "ticks": 30, "equal": True,
          "engines": out})
    return fused_launches


def phase_cpu_parity():
    """Phase 5: 60 observed ticks at 4096 on the card and on the CPU give
    equal digest streams and counter banks, without a skin and with
    NF_VERLET_SKIN=2.0 (the Verlet refresh the card runs)."""
    last = {}
    for skin in ("", "2.0"):
        os.environ["NF_VERLET_SKIN"] = skin
        gpu = digest_stream(4096, 60, None, "cuda")
        cpu = digest_stream(4096, 60, None, "cpu")
        check(gpu[0] == cpu[0], f"cuda and cpu digest streams equal at 4096 (skin {skin!r})")
        check(gpu[1] == cpu[1], f"cuda and cpu counter banks equal at 4096 (skin {skin!r})")
        check(gpu[2]["combat_fold"] == 60, "the cuda run went through kernel 1")
        last[skin or "0"] = gpu[0][-1]
    os.environ.pop("NF_VERLET_SKIN")
    emit({"phase": "cuda_cpu_parity", "entities": 4096, "ticks": 60,
          "digests_equal": True, "last_digest": last})


def phase_bench():
    """(e): the bench entry at 1M, as a user runs it (a subprocess)."""
    cmd = [sys.executable, "-m", "noahgameframe_tpu_torch.bench", "--entities", str(N_MAIN),
           "--ticks", "90", "--lat-k", "8", "--lat-budget-s", "2"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"the bench entry exits 0 ({proc.stderr[-2000:]})")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    d = line["detail"]
    check(d["graph"] is True and d["entities"] == N_MAIN, "the bench ran the graph at 1M")
    check(line["value"] > 0 and d["launches_per_tick"], "the bench measured its tick")
    emit({"phase": "bench_entry", "line": line})


# -- (f) many-worlds rooms ------------------------------------------------------


def rooms_recipe():
    """One room of the rooms recipe (the JAX package's ``run_rooms``): 64
    NPC rows, 32 seeded, extent 64, skin 2.0, combat, movement and regen;
    the digest on."""
    w = gw.GameWorld(gw.WorldConfig(npc_capacity=64, player_capacity=8, extent=64.0,
                                    seed=SEED, verlet_skin=2.0, middleware=False),
                     device=DEV)
    w.start()
    w.scene.create_scene(1, width=64.0)
    w.seed_npcs(32, rng=np.random.default_rng(SEED + 100))
    w.kernel.enable_digest()
    w.kernel._ensure_aux()
    return w


def restore_batch(batch, snap) -> None:
    """Copy a snapshot into the batch state's own tensors (those its graphs
    are bound to)."""
    for dst, src in zip(tree.flatten(batch.state)[0], snap[0]):
        dst.copy_(src)


def phase_rooms():
    """(f): R = 16,384 rooms on the card.  Returns each kernel's launches on
    the rooms path (engine 1 and engine 2 runs of 30 replayed ticks)."""
    w = rooms_recipe()
    k = w.kernel
    order = k.store.class_order
    batch = rooms.RoomBatch(k, ROOMS_MAIN)
    packer = rooms.RoomBinPacker(batch.capacity)

    def room_of(i):
        return k.state.replace(rng=prng_key(SEED + i, DEV))

    t0 = time.perf_counter()
    for i in range(ROOMS_MAIN):
        check(batch.admit(packer.alloc(), room_of(i)) == i, "rooms fill slots in order")
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t0
    state_bytes = sum(x.nbytes for x in tree.flatten(batch.state)[0])
    s0 = snapshot(batch.state)
    runs, launches = {}, {}
    for engine in (1, 0, 2):
        w.combat.use_pallas = engine
        restore_batch(batch, s0)
        t0 = time.perf_counter()
        batch.run(1)  # captures rooms.run under this engine
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        restore_batch(batch, s0)
        torch.cuda.reset_peak_memory_stats()
        sck.reset_launch_counts()
        t0 = time.perf_counter()
        batch.run(30)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[engine] = {n: kk.launches for n, kk in sck.KERNELS.items()}
        r = {"tick_ms": secs / 30 * 1e3, "room_ticks_per_s": ROOMS_MAIN * 30 / secs,
             "capture_and_first_tick_s": capture_s,
             "launches_per_tick": batch.costbook.launches_per_replay("rooms.run"),
             "pool_bytes": batch.costbook.entries["rooms.run"].last.get("pool_bytes"),
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "digests": batch.last_counters["state_digest"].astype(np.int64) & 0xFFFFFFFF,
             "ticks": batch.last_counters["tick"].copy(), "launches": launches[engine]}
        r["tick_ms_median_10"] = statistics.median(tick_times_rooms(batch, 10))
        if engine:
            r["profile_10_ticks"] = profile_run(lambda: batch.run(10), 10, host_ops=False)
        runs[engine] = r
    w.combat.use_pallas = None
    d1 = runs[1]["digests"]
    check(bool((runs[1]["ticks"] == 30).all()), "every room stamps tick 30")
    check(len(np.unique(d1)) == ROOMS_MAIN, "the rooms differ")
    for e in (0, 2):
        check(np.array_equal(runs[e]["digests"], d1), f"engine {e} digest lanes equal engine 1's")
    check(launches[1]["combat_fold"] == 30 and launches[1]["fused_neighborhood"] == 0,
          "engine 1: one combat_fold launch per rooms tick")
    check(launches[2]["fused_neighborhood"] == 30 and launches[2]["combat_fold"] == 0,
          "engine 2: one fused_neighborhood launch per rooms tick")
    check(launches[0]["combat_fold"] == launches[0]["fused_neighborhood"] == 0,
          "engine 0 launched no kernel")
    for e, name in ((1, "combat_fold"), (2, "fused_neighborhood")):
        seen = runs[e]["profile_10_ticks"]["kernel_launches"][name]
        check(seen == 10, f"the profiler sees one {name} kernel per replayed rooms tick "
              f"(saw {seen} in 10)")

    controls = {}
    for i in (0, ROOMS_MAIN // 2, ROOMS_MAIN - 1):
        cw = rooms_recipe()
        cw.combat.use_pallas = 1
        cw.kernel.state = cw.kernel.state.replace(rng=prng_key(SEED + i, DEV))
        cw.kernel.run_device(30, reconcile=False)
        controls[i] = rooms.room_digest(cw.kernel.state, order)
        check(controls[i] == int(d1[i]), f"room {i} equals its single-room control")
        del cw

    # train(K=8) against tick() over 16 ticks from the same state
    restore_batch(batch, s0)
    batch.configure_train(8)
    t0 = time.perf_counter()
    lanes = batch.train(16)
    first_trains_s = time.perf_counter() - t0
    restore_batch(batch, s0)
    ticked = []
    t0 = time.perf_counter()
    for _ in range(16):
        batch.tick()
        ticked.append(batch.last_summary.copy())
    tick_s = time.perf_counter() - t0
    check(all(np.array_equal(lanes[t], ticked[t]) for t in range(16)),
          "train(K=8) summaries, counters and digests equal tick()'s over 16 ticks")
    restore_batch(batch, s0)
    t0 = time.perf_counter()
    batch.train(16)
    train_s = time.perf_counter() - t0

    # churn: destroy, create into the recycled slot, re-home; nothing drops
    # and nothing re-captures (the run loop is captured anew first: the
    # engine runs above left it captured under engine 2)
    batch.run(1)
    mark = batch.costbook.mark()
    packer.free(1)
    new_slot = batch.admit(packer.alloc(), room_of(ROOMS_MAIN + 1))
    check(new_slot == 1, "create recycles the destroyed room's slot")
    packer.free(2)
    src = ROOMS_MAIN - 2
    rows_before = int(batch.state.classes["NPC"].alive[src].sum())
    digest_before = batch.digest(src)
    dst = packer.alloc()
    batch.rehome(src, dst)
    packer.free(src)
    dropped = rows_before - int(batch.state.classes["NPC"].alive[dst].sum())
    check(dropped == 0 and batch.digest(dst) == digest_before,
          "the re-homed room keeps every row and its digest")
    batch.run(10)
    batch.tick()
    unexplained = batch.costbook.unexplained_since(mark)
    check(unexplained == [] and batch.costbook.compiles_since(mark) == [],
          "churn re-captures nothing")
    for r in runs.values():
        r.pop("digests")
        r.pop("ticks")
    emit({"phase": "rooms", "rooms": ROOMS_MAIN, "npc_rows_per_room": 64, "seeded": 32,
          "state_bytes": state_bytes, "admit_s": admit_s,
          "admit_ms_per_room": admit_s / ROOMS_MAIN * 1e3, "digests_equal": True,
          "engines": runs, "controls": {str(i): d for i, d in controls.items()},
          "train_vs_tick": {"k": 8, "ticks": 16, "equal": True,
                            "first_two_trains_s": first_trains_s,
                            "train_tick_ms": train_s / 16 * 1e3,
                            "observed_tick_ms": tick_s / 16 * 1e3,
                            "capture": batch.costbook.entries["rooms.train"].last},
          "churn": {"destroyed": 1, "created": 1, "rehomed": 1, "dropped_rows": dropped,
                    "unexplained": len(unexplained)},
          "costbook": batch.costbook.summary()})
    del batch, s0, lanes, w, k
    return {"combat_fold": launches[1]["combat_fold"],
            "fused_neighborhood": launches[2]["fused_neighborhood"]}


def tick_times_rooms(batch, n: int) -> list:
    """Device time of n single ``run(1)`` rooms ticks, by CUDA events."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    events[0].record()
    for i in range(n):
        batch.run(1)
        events[i + 1].record()
    events[-1].synchronize()
    return [events[i].elapsed_time(events[i + 1]) for i in range(n)]


def phase_bench_rooms():
    """(f): the bench's rooms ladder, as a user runs it (a subprocess)."""
    cmd = [sys.executable, "-m", "noahgameframe_tpu_torch.bench", "--rooms"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"the rooms bench exits 0 ({proc.stderr[-2000:]})")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    d = line["detail"]
    check(line["metric"] == "rooms_room_ticks_per_sec" and line["value"] > 0,
          "the rooms bench measured its ticks")
    check(d["all_gates"] and all(p["graph"] for p in d["points"]),
          "the rooms bench's gates hold and its run loop is a graph")
    check([p["rooms"] for p in d["points"]] == [256, 4096, ROOMS_MAIN],
          "the rooms bench ran its ladder")
    emit({"phase": "bench_rooms", "line": line})


# -- (g) persistence at 1M ---------------------------------------------------------


def observed_stream(w, n: int) -> list:
    """The digests of n observed frames (``GameWorld.tick``)."""
    return [w.tick().counters["state_digest"] & 0xFFFFFFFF for _ in range(n)]


def captures(k) -> dict:
    """Captures so far of the tick's entries (a new signature captures)."""
    return {n: k.costbook.entry(n).compiles for n in ("kernel.step", "kernel.run")}


def synced(fn):
    """``fn()`` and its wall seconds up to a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def settled_world(n: int, device: str, ticks: int = 20):
    """The main path's world with the digest on, ticked ``ticks`` observed
    frames: the overflow auto-resize (``_bucket_boost``, host state that a
    checkpoint does not carry) has done its work."""
    w = gw.build_benchmark_world(n, seed=SEED, device=device)
    w.kernel.enable_digest()
    w.run(ticks)
    return w


def phase_persist(card: str):
    """(g): checkpoint and resume of the 1M world, engine 1, sort, no skin.

    A: 20 observed frames and 10 graph ticks, save, then 30 observed frames
    and a 30-tick graph run.  B: the same world rewound by ``load``, the
    same 60 ticks, equal digests and no new capture.  C and D: a second
    1M world of the recipe, settled 20 frames, loads the checkpoint and
    ticks 30 observed frames under engine 1, then (loaded again) engine 2;
    both equal A; loaded once more, a 30-tick graph run ends on C's last
    digest.  Then a checkpoint saved on the card at 4,096 NPCs resumes on
    the CPU with an equal stream, and the host plane's times at 1M: one
    create, one write, one destroy, and 32 players saved and reloaded
    through a PlayerDataAgent on FileKV.  Returns each kernel's launches
    in the resumed runs."""
    tmp = tempfile.mkdtemp(prefix="nf_persist_")
    try:
        ck = os.path.join(tmp, "world")
        w = settled_world(N_MAIN, DEV)
        k = w.kernel
        k.run_device(10)  # captures kernel.run: the rewind must keep it
        boost = w.combat._bucket_boost
        save, save_s = synced(lambda: w.save(ck))
        on_disk = sum(os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck))

        def run_a_b():
            stream = observed_stream(w, 30)
            k.run_device(30)
            return stream, digest(k)

        a_stream, a_end = run_a_b()
        check(w.combat._bucket_boost == boost, "no overflow resize in stream A")
        before = captures(k)
        sck.reset_launch_counts()
        load_b, load_b_s = synced(lambda: w.load(ck))
        b_stream, b_end = run_a_b()
        after = captures(k)
        launches_b = {n: kk.launches for n, kk in sck.KERNELS.items()}
        check(b_stream == a_stream and b_end == a_end,
              "the rewound world repeats stream A and its graph run")
        check(after == before, f"the rewind's load captured nothing anew ({before} -> {after})")
        check(launches_b["combat_fold"] == 60, "the rewound runs went through kernel 1")

        f = settled_world(N_MAIN, DEV)
        fk = f.kernel
        fk.run_device(1)  # captures kernel.run, so the resumed graph run replays it
        fresh_boost = f.combat._bucket_boost
        fresh_captures = captures(fk)
        resumed = {}
        sck.reset_launch_counts()
        load_c, load_c_s = synced(lambda: f.load(ck))
        c_stream = observed_stream(f, 30)
        resumed["c"] = {n: kk.launches for n, kk in sck.KERNELS.items()}
        f.combat.use_pallas = 2
        f.load(ck)
        sck.reset_launch_counts()
        d_stream = observed_stream(f, 30)
        resumed["d"] = {n: kk.launches for n, kk in sck.KERNELS.items()}
        f.combat.use_pallas = None
        f.load(ck)
        sck.reset_launch_counts()
        fk.run_device(30)
        resumed["graph"] = {n: kk.launches for n, kk in sck.KERNELS.items()}
        f_end = digest(fk)
        check(c_stream == a_stream, "the fresh world's resumed stream (engine 1) equals A")
        check(d_stream == a_stream, "the fresh world's resumed stream (engine 2) equals A")
        check(f_end == c_stream[-1], "the resumed graph run ends on stream C's last digest")
        check(resumed["c"]["combat_fold"] == 30 and resumed["d"]["fused_neighborhood"] == 30
              and resumed["graph"]["combat_fold"] == 30,
              f"the resumed runs went through each engine's kernel every tick ({resumed})")
        check(captures(fk)["kernel.run"] == fresh_captures["kernel.run"],
              "the fresh world's loads captured no run graph anew")
        del f, fk
        free()

        # across devices: saved on the card, resumed on the CPU
        small = os.path.join(tmp, "small")
        wc = settled_world(4096, DEV, ticks=10)
        wc.save(small)
        x = observed_stream(wc, 30)
        wh = settled_world(4096, "cpu", ticks=10)
        wh.load(small)
        y = observed_stream(wh, 30)
        check(x == y, "a checkpoint saved on cuda resumes on the cpu with an equal stream")
        del wc, wh

        # the host plane at 1M (functional writes: each replaces the banks
        # it touches, and the next graph replay copies them in)
        st = k.store
        npc = next(g for g in st._hosts["NPC"].row_guid if g is not None)
        victim = next(g for g in reversed(st._hosts["NPC"].row_guid) if g is not None)
        host = {}
        _, host["create_player_s"] = synced(lambda: k.create_object(
            "Player", {"Name": "P0", "Account": "acct0"}, scene=1))
        _, host["create_npc_s"] = synced(lambda: k.create_object("NPC", {"HP": 50}, scene=1))
        _, host["set_property_npc_s"] = synced(lambda: k.set_property(npc, "Gold", 7))
        _, host["destroy_npc_s"] = synced(lambda: k.destroy_object(victim))
        check(k.get_property(npc, "Gold") == 7 and victim not in st.guid_map,
              "the host writes landed")
        mark = captures(k)
        k.run_device(1)
        check(captures(k) == mark, "a graph tick after host writes captures nothing anew")
        agent = PlayerDataAgent(FileKV(os.path.join(tmp, "kv"))).bind(k)
        players = {}
        for i in range(32):
            vals = {"Name": f"Hero{i}", "Account": f"acct{i + 1}", "Gold": 100 + i,
                    "Level": i % 7, "Position": (float(i), 2.0 * i, 0.0)}
            players[f"acct{i + 1}:Hero{i}"] = (k.create_object("Player", vals, scene=1), vals)
        saved = {}

        def save_all():
            for key, (g, _vals) in players.items():
                saved[key] = {p: k.get_property(g, p) for p in ("Gold", "Level", "Name",
                                                                "Position")}
                k.destroy_object(g)  # BEFORE_DESTROY saves the blob

        def reload_all():
            return {key: k.create_object("Player", {"Name": vals["Name"],
                                                    "Account": vals["Account"]}, scene=1)
                    for key, (_g, vals) in players.items()}

        _, host["agent_save_32_s"] = synced(save_all)
        check(all(agent.exists(key) for key in players), "every player's blob was saved")
        back, host["agent_reload_32_s"] = synced(reload_all)
        for key, g in back.items():
            got = {p: k.get_property(g, p) for p in ("Gold", "Level", "Name", "Position")}
            check(got == saved[key], f"{key} reloads with its saved properties")
        resumed["b"] = launches_b
        emit({"phase": "persist_1m", "entities": N_MAIN, "engine": 1, "card": card,
              "state_bytes": save["raw_bytes"], "bytes_on_disk": on_disk,
              "save_s": save_s, "save_split": save, "load_rewind_s": load_b_s,
              "load_rewind_split": load_b, "load_fresh_s": load_c_s,
              "load_fresh_split": load_c,
              "streams_equal": {"rewind_B": True, "fresh_C": True, "fresh_D_engine2": True,
                                "graph_after_load": True, "cuda_to_cpu_4096": True},
              "new_captures_after_rewind": 0, "captures": after,
              "bucket_boost": {"saving_world": boost, "fresh_world_settled": fresh_boost},
              "a_last_digest": a_stream[-1], "a_graph_end": a_end,
              "resumed_launches": resumed, "host_plane": host})
        launches = {"combat_fold": sum(r["combat_fold"] for r in resumed.values()),
                    "fused_neighborhood": sum(r["fused_neighborhood"] for r in resumed.values())}
        del w, k, agent
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        free()


# -- (h) the scene and host layer at 1M -------------------------------------------

#: the 1M record-diff subscriber's record (~76% of the world's bytes)
BIG_RECORD = "CommPropertyValue"
H_BATCHES = 6
H_TICKS = 10  # graph ticks (one train dispatch) after each batch


class Idents:
    """A world-independent name for each guid, ``class:row:generation``
    (two worlds built from one seed mint different guids for the same
    rows); names of destroyed guids are remembered from their last sight."""

    def __init__(self, world):
        self.store = world.kernel.store
        self.seen = {}

    def __call__(self, g):
        st = self.store
        if g in st.guid_map:
            cname, row = st.row_of(g)
            self.seen[g] = f"{cname}:{row}:{int(st._hosts[cname].row_gen[row])}"
        return self.seen.get(g, "null" if g.is_null() else "unknown")


def _h(arr) -> str:
    """A short digest of an integer array's bytes (the 1M logs stay small)."""
    import hashlib
    a = np.ascontiguousarray(np.asarray(arr))
    return f"{a.shape}:{hashlib.sha1(a.tobytes()).hexdigest()[:16]}"


def host_layer_world(n: int, device: str, ticks: int = 20):
    """The main path's world (engine 1, sort, no skin), digest on, settled
    ``ticks`` observed frames, plus the host layer's set-up: the skill,
    seed and clone-scene elements, a linear job-0 level table (its freeze
    invalidates, before any capture) and pinned guids."""
    w = gw.build_benchmark_world(n, seed=SEED, device=device)
    w.kernel.enable_digest()
    w.run(ticks)
    k = w.kernel
    k.elements.add_element("Skill", "fireball", {"DamageValue": 10})
    k.elements.add_element("NPC", "grunt", {"HP": 60, "MAXHP": 60, "SeedID": "grunt"})
    k.elements.add_element("Scene", "7", {"SceneType": 1})
    w.property_config.fill_linear(
        0, {"MAXHP": 100, "MAXMP": 20, "MAXSP": 10, "HPREGEN": 2},
        {"MAXHP": 10, "MAXMP": 2, "MAXSP": 1}, max_exp_base=40, max_exp_per_level=15)
    w.property_config.freeze()
    k.store.guids.pin(10 ** 12)
    return w


def host_layer_script(w, ident, log, answers, times, sync):
    """The six batches of host operations (closures, applied in order
    between tick windows).  Every call is timed by kind (``sync`` around
    it); subscribers log into ``log``, queries into ``answers``."""
    k, sc, st = w.kernel, w.scene, w.kernel.store
    rng = np.random.default_rng(SEED + 7)
    ext = w.config.extent
    players = []
    state = {}

    def op(kind, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times.setdefault(kind, []).append(time.perf_counter() - t0)
        return out

    def npc_rows(count):
        alive = np.flatnonzero(st._hosts["NPC"].alloc_mask)
        return rng.choice(alive, count, replace=False)

    def npc(row):
        return st._hosts["NPC"].row_guid[int(row)]

    def record_answers(tag):
        groups = sorted(sc.scenes[2].groups)
        answers.append((tag, {g: [ident(x) for x in sc.objects_in_group(2, g, "NPC")]
                              for g in groups}))
        for p in players[::5]:
            if p in st.guid_map:
                answers.append((tag, ident(p),
                                op("broadcast_targets",
                                   lambda p=p: [ident(x) for x in sc.broadcast_targets(p, True)]),
                                op("objects_in_group", lambda p=p: [ident(x) for x in sc.objects_in_group(
                                    int(k.get_property(p, "SceneID")),
                                    int(k.get_property(p, "GroupID")), "Player")])))

    def subscribe():
        for name in ("before_enter_scene", "after_enter_scene", "before_leave_scene",
                     "after_leave_scene", "on_swap_group"):
            getattr(sc, name).append(
                lambda g, s, gr, name=name: log.append(("hook", name, ident(g), s, gr)))
        sc.on_group_created.append(lambda s, gr: log.append(("group", s, gr)))
        k.register_class_event(lambda g, c, ev: log.append(("class", ident(g), c, int(ev))))
        for cname, pname in (("Player", "SceneID"), ("Player", "GroupID"), ("Player", "Level")):
            k.register_property_event(cname, pname, lambda c, p_, rows: log.append(
                ("prop", c, p_, rows.tolist())))

    def batch0():
        subscribe()
        # 40 rows freed: 32 for the groups' seeds, 4 for the clone scene's
        dead = npc_rows(40)
        for row in dead:
            g = npc(row)
            op("destroy_object", lambda g=g: k.destroy_object(g))
        seeds = [gsc.SeedSpec("grunt", "NPC", (ext * fx, ext * fy, 0.0))
                 for fx, fy in ((0.21, 0.33), (0.47, 0.52), (0.66, 0.18), (0.83, 0.77))]
        op("create_scene", lambda: sc.create_scene(2, seeds=seeds, width=ext))
        op("create_scene", lambda: sc.create_scene(7, seeds=seeds[:2], width=ext))
        gids = [op("request_group", lambda: sc.request_group(2)) for _ in range(8)]
        seeded = sorted(st.row_of(g)[1] for gid in gids for g in sc.scenes[2].groups[gid].seeded)
        check(len(seeded) == 32 and set(seeded) <= {int(r) for r in dead},
              "the 32 seeded NPCs took recycled rows")
        for i in range(32):
            vals = {"Name": f"hero{i}", "Account": f"acct{i}", "Gold": 100 + i,
                    "Position": (ext * rng.random(), ext * rng.random(), 0.0)}
            players.append(op("create_object_player",
                              lambda vals=vals: k.create_object("Player", vals, scene=1)))
        answers.append(("groups", gids, seeded))
        record_answers("b0")

    def batch1():
        gids = sorted(g for g in sc.scenes[2].groups if g)
        for i, p in enumerate(players[:16]):
            op("enter_scene", lambda p=p, i=i: sc.enter_scene(p, 2, gids[i % len(gids)]))
        op("enter_scene", lambda: sc.enter_scene(players[0], 2, gids[3]))  # a same-scene swap
        for p in players[16:18]:
            answers.append(("clone", ident(p),
                            op("scene_process_enter", lambda p=p: w.scene_process.enter(p, 7))))
        op("force_diff_property", lambda: k.force_diff_property("NPC", "LastAttacker"))
        k.register_property_event("NPC", "LastAttacker", lambda c, p_, rows: log.append(
            ("forced", c, p_, _h(rows))))
        record_answers("b1")

    def batch2():
        for i in range(64):
            g = npc(npc_rows(1)[0])
            answers.append(("skill", op("use_skill", lambda g=g, i=i: w.skills.use_skill(
                players[i % 32], "fireball" if i % 9 else "nope", g))))
        for p in players[20:24]:
            op("set_timer", lambda p=p: setattr(k, "state", k.schedule.set_timer(
                k.state, st, p, "Regen", 0.5, 3, 0.1)))
        for p in players[20:22]:
            op("cancel_timer", lambda p=p: setattr(k, "state", k.schedule.cancel_timer(
                k.state, st, p, "Regen")))
        for p in players[24:28]:
            op("regen_arm", lambda p=p: w.regen.arm(p))

        def codes(c, r, arr):
            nz = np.flatnonzero(arr)
            log.append(("rec_diff", c, r, nz.tolist()[:64], _h(nz), _h(arr.reshape(-1)[nz])))

        op("register_record_diff", lambda: k.register_record_diff("NPC", BIG_RECORD, codes))
        state["codes"] = codes
        op("subscribe_record_host", lambda: k.subscribe_record_host(
            lambda c, r, o, rows, rr, tags: log.append(
                ("rec_host", c, r, int(o), rows.tolist(), rr, tags))))

    def batch3():
        # the players' record too (its own first subscription), so the
        # device level-up below shows in the codes
        op("register_record_diff", lambda: k.register_record_diff(
            "Player", BIG_RECORD, state["codes"]))
        before = int(k.get_property(players[0], "Level"))
        level = op("add_exp", lambda: w.level.add_exp(players[0], 200))
        check(level >= before + 2, f"add_exp crossed two level-ups ({before} -> {level})")
        op("add_exp", lambda: w.level.add_exp(players[1], 30))
        # a device level-up: the level phase rewrites the JOBLEVEL row,
        # which the host marks used first, so the codes report it
        row2 = st.row_of(players[2])[1]
        op("record_write_rows", lambda: setattr(k, "state", st.record_write_rows(
            k.state, "Player", np.asarray([row2]), BIG_RECORD, int(PropertyGroup.JOBLEVEL),
            {"MAXHP": [100]})))
        op("set_property", lambda: k.set_property(players[2], "EXP", 500))
        props = w.properties
        for p in players[:8]:
            answers.append(("stat", ident(p),
                            op("add_hp", lambda p=p: props.add_hp(p, 15)),
                            op("consume_money", lambda p=p: props.consume_money(p, 30)),
                            op("enough_sp", lambda p=p: props.enough_sp(p, 1))))
        answers.append(("levels", [(k.get_property(p, "Level"), k.get_property(p, "EXP"),
                                    k.get_property(p, "MAXHP")) for p in players[:4]]))

    def batch4():
        gids = sorted(g for g in sc.scenes[2].groups if g)
        for gid in gids[:2]:
            answers.append(("release", gid, op("release_group", lambda gid=gid: sc.release_group(2, gid))))
        op("arm_all", lambda: w.combat.arm_all(stagger=False))
        record_answers("b4")

    def batch5():
        for p in players[16:24]:
            if p in st.guid_map:
                op("enter_scene", lambda p=p: sc.enter_scene(p, 1, 0))
        live = [p for p in players if p in st.guid_map]  # releases took some
        for i in range(32):
            g = npc(npc_rows(1)[0])
            answers.append(("skill", op("use_skill", lambda g=g, i=i: w.skills.use_skill(
                live[i % len(live)], "fireball", g))))
        record_answers("b5")

    return [batch0, batch1, batch2, batch3, batch4, batch5]


def run_host_script(w, advance, sync):
    """The script on one world, ``advance(n)`` ticking n observed frames
    after each batch.  Returns the digest stream, the subscriber log, the
    answers and the host times of each op kind."""
    ident = Idents(w)
    log, answers, times, stream = [], [], {}, []
    for batch in host_layer_script(w, ident, log, answers, times, sync):
        batch()
        outs = advance(H_TICKS)
        stream += [o.counters["state_digest"] & 0xFFFFFFFF for o in outs]
        log.append(("tick", len(stream)))
    return {"stream": stream, "log": log, "answers": answers, "times": times}


def observed_graph_ticks(k, n: int) -> list:
    """Device time of n observed graph ticks (``train`` with K = 1): CUDA
    events around each dispatch, its host fan-out outside the window."""
    k.configure_train(1)
    k.train(1)  # captures
    out = []
    for _ in range(n):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        raw = k.train_begin()
        e1.record()
        k.train_finish(raw)
        out.append(e0.elapsed_time(e1))
    return out


def _stats(xs) -> dict:
    return {"mean_ms": statistics.fmean(xs), "median_ms": statistics.median(xs)}


def phase_host_layer(card: str):
    """(h).1 and (h).2: the script of host operations on the 1M world, as
    graph trains (world A) and as eager observed ticks (world B, the same
    recipe and seed, so the same snapshot); then engine 2 on the script's
    end state, and the script at 4,096 NPCs on cuda and cpu.  Returns each
    kernel's launches on the host-layer path."""
    sync = torch.cuda.synchronize
    a = host_layer_world(N_MAIN, DEV)
    b = host_layer_world(N_MAIN, DEV)
    ka, kb = a.kernel, b.kernel
    # the main path's graph tick and the observed graph tick, no subscribers
    # (each window's graph captured before it is timed)
    ka.run_device(1)
    before_run = tick_times(ka, 30, graph=True)
    before_obs = observed_graph_ticks(ka, 30)
    ka.configure_train(H_TICKS)
    ka.train(H_TICKS)  # the script's train graph, captured before the script
    kb.run_device(31, graph=False)
    for _ in range(31 + H_TICKS):  # observed, as A's trains are
        kb.tick()
    check(digest(ka) == digest(kb), "the graph and eager worlds start from the same state")
    entry = ka.costbook.entry("kernel.train")
    captures0, events0 = entry.compiles, len(ka.costbook.events)
    gens0 = len(ka.costbook.gen_events)
    sck.reset_launch_counts()
    ra = run_host_script(a, ka.train, sync)
    launches = {n: kk.launches for n, kk in sck.KERNELS.items()}
    rb = run_host_script(b, lambda n: [kb.tick() for _ in range(n)], sync)
    recaptures = entry.compiles - captures0
    causes = [e["cause"] for e in ka.costbook.events[events0:] if e["entry"] == "kernel.train"]
    gen_causes = [e["cause"] for e in ka.costbook.gen_events[gens0:]]
    n_ticks = H_BATCHES * H_TICKS
    check(ra["stream"] == rb["stream"] and len(ra["stream"]) == n_ticks,
          "graph and eager digest streams equal over the script")
    check(ra["log"] == rb["log"], "graph and eager subscriber logs equal")
    check(ra["answers"] == rb["answers"], "graph and eager scene answers equal")
    kinds = {e[0] for e in ra["log"]}
    check({"hook", "group", "class", "prop", "forced", "rec_diff", "rec_host"} <= kinds,
          f"every subscriber heard something ({sorted(kinds)})")
    check(recaptures == 4 and gen_causes == ["invalidate"] * 4,
          f"one re-capture per invalidating op ({recaptures}, {causes}, {gen_causes})")
    check(causes == ["static:forced_diff", "static:rec_diff", "static:rec_diff",
                     "static:att_bucket"], f"the re-captures name their causes ({causes})")
    # each re-capture first runs the train eagerly WARMUP_RUNS times
    warm = WARMUP_RUNS * H_TICKS * recaptures
    per_replay = entry.last["kernel_launches_per_replay"]["combat_fold"]
    check(launches["combat_fold"] == n_ticks + warm and per_replay == H_TICKS,
          f"one combat_fold a replayed tick ({launches}, {warm} in warm-ups, {per_replay})")

    # engine 2 on the script's end state (graph trains) against engine 1
    # (eager ticks): equal streams, one fused_neighborhood a tick
    a.combat.use_pallas = 2
    sck.reset_launch_counts()
    e2 = [o.counters["state_digest"] & 0xFFFFFFFF for o in ka.train(30)]
    fused = sck.KERNELS["fused_neighborhood"].launches
    e1 = [kb.tick().counters["state_digest"] & 0xFFFFFFFF for _ in range(30)]
    check(e2 == e1, "engine 2 (graph) equals engine 1 (eager) on the host-layer world")
    check(fused == 30 + WARMUP_RUNS * H_TICKS,
          f"one fused_neighborhood a replayed tick ({fused}, warm-ups included)")
    a.combat.use_pallas = None

    # the same ticks with the NPC record-diff subscriber and the forced column
    after_obs = observed_graph_ticks(ka, 30)
    ka.run_device(1)
    after_run = tick_times(ka, 30, graph=True)
    rec_bytes = 0
    for cname in ("NPC", "Player"):
        rec = ka.state.classes[cname].records[BIG_RECORD]
        # old and new banks read once, the int8 codes written once
        rec_bytes += 2 * (rec.i32.nbytes + rec.f32.nbytes + rec.vec.nbytes + rec.used.nbytes) \
            + rec.used.numel()
    host_ms = {kind: _stats([t * 1e3 for t in ts]) for kind, ts in sorted(ra["times"].items())}
    del a, b, ka, kb
    free()

    # (h).2: cuda against cpu at 4,096
    small = []
    for dev in (DEV, "cpu"):
        sw = host_layer_world(4096, dev)
        sw.kernel.configure_train(H_TICKS)
        small.append(run_host_script(sw, sw.kernel.train, sync if dev != "cpu" else (lambda: None)))
        del sw
    check(small[0]["stream"] == small[1]["stream"], "cuda and cpu digest streams equal at 4,096")
    check(small[0]["log"] == small[1]["log"], "cuda and cpu subscriber logs equal at 4,096")
    check(small[0]["answers"] == small[1]["answers"], "cuda and cpu answers equal at 4,096")
    emit({"phase": "host_layer_1m", "entities": N_MAIN, "card": card, "ticks": n_ticks,
          "streams_equal": {"graph_vs_eager_1m": True, "cuda_vs_cpu_4096": True,
                            "engine2_graph_vs_engine1_eager": True},
          "last_digest": ra["stream"][-1], "log_entries": len(ra["log"]),
          "log_kinds": sorted(kinds), "recaptures": recaptures, "recapture_causes": causes,
          "invalidations": gen_causes,
          "combat_fold_launches": launches["combat_fold"], "warmup_launches": warm,
          "combat_fold_per_replayed_tick": (launches["combat_fold"] - warm) / n_ticks,
          "fused_neighborhood_engine2_window": fused,
          "graph_tick_no_subscribers": _stats(before_run),
          "graph_tick_after_script": _stats(after_run),
          "observed_graph_tick_no_subscribers": _stats(before_obs),
          "observed_graph_tick_with_subscribers": _stats(after_obs),
          "record_diff_bytes": rec_bytes,
          "record_diff_bound_ms": rec_bytes / PEAK_BYTES_PER_S * 1e3,
          "host_op_ms": host_ms,
          "host_op_calls": {kind: len(ts) for kind, ts in sorted(ra["times"].items())}})
    return {"combat_fold": launches["combat_fold"], "fused_neighborhood": fused}


def phase_aoi_interest(card: str):
    """(h).3 and (h).4: BASELINE config 3's AOI scan (``neighbor_counts``
    over the alive NPCs of ``build_benchmark_world(500_000)``, radius and
    cell 4.0, partitioned by ``cell_key``) and the interest query of 4,096
    observers at radius 8.0 over the 1M world's NPCs (fresh and Verlet
    cached, skin 2.0, ``moved`` = the movers of the last frame), each equal
    to the same call on the CPU (tolerance 0) and timed (mean of 20 by
    CUDA events)."""
    from noahgameframe_tpu_torch.ops import aoi, interest
    from noahgameframe_tpu_torch.ops.verlet import init_cache

    out = {}
    w = gw.build_benchmark_world(N_AOI, seed=SEED, device=DEV)
    k = w.kernel
    spec = k.store.spec("NPC")
    cs = k.state.classes["NPC"]
    pos = cs.vec[:, spec.slot("Position").col, :2].contiguous()
    alive = cs.alive.clone()
    part = w.scene.cell_key(k.state, "NPC")
    width = int(w.config.extent / 4.0)
    bucket = sc.auto_bucket(pos.shape[0], width)
    args = (pos, alive, 4.0, 4.0, width, bucket, part)
    got = aoi.neighbor_counts(*args)
    want = aoi.neighbor_counts(*(x.cpu() if isinstance(x, torch.Tensor) else x for x in args))
    check(torch.equal(got.cpu(), want) and got.dtype == torch.int32,
          "neighbor_counts at 500k equals the CPU")
    check(int(got.sum()) > 0, "the AOI scan found neighbours")
    # the least work of the scan on its cell table, from this run's data:
    # the inputs read and the counts written once, the [H, W, K, 6] float32
    # table written once and read for each of the nine shifts, and 5
    # float32 operations for each slot pair of a 3x3 neighbourhood tested
    table = sc.build_cell_table(pos, alive, torch.zeros(pos.shape[0], 5, device=DEV),
                                4.0, width, bucket)
    occ = cell_counts(table.slot_of, width, bucket)
    tests = int((occ * nbhd_sum(occ)).sum())
    io_bytes = pos.nbytes + alive.nbytes + part.nbytes + got.nbytes
    table_bytes = table.payload.nbytes
    bound, by = bound_ms(io_bytes + 10 * table_bytes, 5 * tests)
    out["neighbor_counts_500k"] = {
        "entities": int(alive.sum()), "width": width, "bucket": bucket,
        "pairs": int(got.sum()), "pair_tests": tests, "io_bytes": io_bytes,
        "table_bytes": table_bytes, "ms": time_ms(lambda: aoi.neighbor_counts(*args)),
        "bound_ms": bound, "bound_by": by}
    del w, k, cs, pos, alive, part, got, want, table
    free()

    w = gw.build_benchmark_world(N_MAIN, seed=SEED, device=DEV)
    k = w.kernel
    spec = k.store.spec("NPC")
    col = spec.slot("Position").col
    k.run_device(1, graph=False)  # the first tick sets MOVE_SPEED (recompute)
    p0 = k.state.classes["NPC"].vec[:, col, :2].clone()
    k.run_device(1, graph=False)
    cs = k.state.classes["NPC"]
    pos = cs.vec[:, col, :2].contiguous()
    moved = (pos != p0).any(-1) & cs.alive
    scene = cs.i32[:, spec.slot("SceneID").col].float()
    group = cs.i32[:, spec.slot("GroupID").col].float()
    rng = np.random.default_rng(SEED + 11)
    obs_rows = torch.from_numpy(rng.choice(np.flatnonzero(cs.alive.cpu().numpy()), 4096,
                                           replace=False)).to(DEV)
    obs = (pos[obs_rows].contiguous(), scene[obs_rows], group[obs_rows])
    ext, radius, skin = w.config.extent, 8.0, 2.0
    cap = pos.shape[0]
    fresh_geo = (radius, radius, int(np.ceil(ext / radius)),
                 sc.auto_bucket(cap, int(np.ceil(ext / radius))))
    cell_c = radius + skin
    cached_geo = (radius, cell_c, int(np.ceil(ext / cell_c)),
                  sc.auto_bucket(cap, int(np.ceil(ext / cell_c))), skin)

    def fresh(dev):
        t = [x.to(dev) for x in (pos, moved, scene, group, *obs)]
        return interest.visible_candidates(*t, *fresh_geo)

    def cached(dev, cache=None):
        t = [x.to(dev) for x in (pos, moved, cs.alive, scene, group, *obs)]
        cache = init_cache(cap, dev) if cache is None else cache
        return interest.visible_candidates_cached(cache, *t, *cached_geo)

    for name, fn in (("visible_candidates", lambda d: fresh(d)),
                     ("visible_candidates_cached", lambda d: cached(d)[0])):
        g, c = fn(DEV), fn("cpu")
        ok = g.ok.cpu()
        check(torch.equal(ok, c.ok) and bool(ok.any()), f"{name}: ok equals the CPU")
        check(torch.equal(torch.where(ok, g.rows.cpu(), 0), torch.where(c.ok, c.rows, 0)),
              f"{name}: rows where ok equal the CPU")
        out[name] = {"observers": 4096, "candidates": int(ok.sum()), "moved": int(moved.sum()),
                     "slots": list(g.ok.shape), "ms": time_ms(lambda: fn(DEV))}
    # the cached form with a warm cache (a reuse, no sort)
    warm = cached(DEV)[1]
    out["visible_candidates_cached"]["warm_ms"] = time_ms(lambda: cached(DEV, warm))
    emit({"phase": "aoi_interest", "card": card, **out})
    del w, k
    free()


# -- (i) the served path -----------------------------------------------------------
SERVED_N = 100_000
SERVED_1M = N_MAIN
SERVED_SESSIONS = 500
SERVED_FRAMES = 30
SERVED_WARMUP = 3
SERVED_RADIUS = 8.0
FRAME_LIMIT_MS = 1000.0 / 30.0
PARITY_N, PARITY_SESSIONS, PARITY_FRAMES = 4096, 32, 30
JOURNAL_FRAMES = 60
ENGINES = {
    "legacy": {"serve_batch": False},
    "batch": {"serve_batch": True},
    "overlap": {"serve_overlap": True},
    "train8": {"serve_batch": True, "tick_train": 8},
}


def served_role(n: int, sessions: int, device: str, *, seat_rng=None, world=None, **kw):
    """The bench's served role (``bench.build_served_role``: one live Player
    avatar a session, seated as bench.py seats them, or at random spots
    when ``seat_rng`` is given) over ``world`` (``pinned_world`` unless
    given), its transport writes hashed and counted: returns (role, sink)
    with ``sink`` = {"msgs", "bytes", "sha"}."""
    import hashlib

    from noahgameframe_tpu_torch import bench

    role, _sent = bench.build_served_role(
        n, sessions, torch.device(device), seed=SEED, interest_radius=SERVED_RADIUS,
        world=world if world is not None else pinned_world(n, sessions + 8, device), **kw)
    if seat_rng is not None:
        ext = role.game_world.config.extent
        for sess in role.sessions.values():
            x, y = seat_rng.uniform(1.0, ext - 1.0, 2)
            role.kernel.set_property(sess.guid, "Position", (float(x), float(y), 0.0))
    from noahgameframe_tpu_torch.net.defines import TRACE_MSG_IDS

    sink = {"msgs": 0, "bytes": 0, "sha": hashlib.sha256()}

    def send(conn_id: int, msg_id: int, body: bytes) -> bool:
        sink["msgs"] += 1
        sink["bytes"] += len(body)
        # frame-trace sidecars carry wall-clock stamps (observability, not
        # state; the journal leaves them out too)
        if msg_id not in TRACE_MSG_IDS:
            sink["sha"].update(b"%d %d %d|" % (conn_id, msg_id, len(body)))
            sink["sha"].update(body)
        return True

    role.server.send_raw = send
    return role, sink


def count_syncs(fn) -> int:
    """Run ``fn()`` with CUDA's sync debug mode on; the number of host
    syncs it made (each implicit synchronization raises one warning)."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum(1 for r in rec if "synchroniz" in str(r.message))


def serve_run(role, frames: int, now: float, *, digests=None, stages=None):
    """``frames`` frames of ``role.execute``, each ended by a device sync;
    returns (per-frame ms, clock).  ``digests`` collects each frame's
    ``state_digest``, ``stages`` each frame's exclusive stage times (the
    StageClock waterfall, which sums to the frame's wall time)."""
    from noahgameframe_tpu_torch import bench

    def sync():
        torch.cuda.synchronize() if DEV == "cuda" else None
        if digests is not None:
            digests.append(role.kernel.last_counters.get("state_digest", 0) & 0xFFFFFFFF)
        if stages is not None:
            stages.append(dict(role.stage_clock.last))

    return bench.serve_frames(role, frames, now, sync)


def pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q))


def settle(role, now: float = 1000.0) -> float:
    """SERVED_WARMUP frames, then more until a frame re-captures nothing
    (the combat tables' overflow auto-resize re-captures the tick a few
    times in the first frames; a re-capture's eager warm-up runs launch
    the fold kernels too)."""
    book = role.kernel.costbook
    _ms, now = serve_run(role, SERVED_WARMUP, now)
    for _ in range(20):
        c0 = book.total_compiles
        _ms, now = serve_run(role, 1, now)
        if book.total_compiles == c0:
            return now
    raise RuntimeError("check failed: the served role kept re-capturing after 23 frames")


def served_engine(name: str, n: int, frames: int, fold: str = "combat_fold", **kw) -> dict:
    """One engine at n NPCs and SERVED_SESSIONS sessions: warm-up, timed
    frames, the waterfall, host syncs a frame, fold launches against ticks
    served, re-captures and their causes, and the stream's hash."""
    role, sink = served_role(n, SERVED_SESSIONS, DEV, **kw)
    k = role.kernel
    book = k.costbook
    now = settle(role)
    sink["msgs"] = sink["bytes"] = 0
    recompiles0, seq0 = book.total_recompiles, book._seq
    sck.reset_launch_counts()
    t0_tick = k.tick_count
    t0 = time.perf_counter()
    stages = []
    frame_ms, now = serve_run(role, frames, now, stages=stages)
    elapsed = time.perf_counter() - t0
    ticks = k.tick_count - t0_tick
    launches = {nm: kk.launches for nm, kk in sck.KERNELS.items()}
    msgs, nbytes = sink["msgs"], sink["bytes"]
    # a re-capture in the window (the overflow auto-resize can grow a
    # bucket at any frame) first runs the step WARMUP_RUNS times eagerly,
    # which launches the fold too: those launches are counted apart
    warm = WARMUP_RUNS * sum(
        role.tick_train if r["entry"] == "kernel.train" else 1
        for r in book.compile_log if r["seq"] >= seq0
        and r["entry"] in ("kernel.step", "kernel.train"))
    sync_frames = 3
    syncs = count_syncs(lambda: serve_run(role, sync_frames, now)) if DEV == "cuda" else None
    names = sorted({st for fr in stages for st in fr})
    per_stage = {st: [fr.get(st, 0) / 1e6 for fr in stages] for st in names}
    out = {
        "engine": name, "entities": n, "sessions": SERVED_SESSIONS, "frames": frames,
        "ticks": ticks, "tick_train": role.tick_train, "serve_batch": role.serve_batch,
        "serve_overlap": role.serve_overlap, "graph_tick": k.graph_tick,
        "frame_ms_p50": pct(frame_ms, 50), "frame_ms_p95": pct(frame_ms, 95),
        "frame_ms_p99": pct(frame_ms, 99), "frame_ms_mean": statistics.fmean(frame_ms),
        "served_entity_ticks_per_s": n * ticks / elapsed,
        "sync_msgs": msgs, "sync_bytes": nbytes,
        "waterfall_p50_ms": {st: pct(v, 50) for st, v in per_stage.items()},
        "waterfall_mean_ms": {st: statistics.fmean(v) for st, v in per_stage.items()},
        "host_syncs_per_frame": None if syncs is None else syncs / sync_frames,
        "launches": launches, "warmup_launches": warm,
        "recaptures": book.total_recompiles - recompiles0,
        "recapture_causes": {nm: dict(e.causes) for nm, e in sorted(book.entries.items())
                             if e.causes},
        "serve_dispatches": role._serve_dispatches.value(),
    }
    check(launches[fold] == ticks + warm,
          f"{name}: {fold} launched once per tick served ({launches} vs {ticks} + {warm})")
    check(msgs > 0 and all(np.isfinite(frame_ms)), f"{name}: frames served")
    role.shut()
    del role
    free()
    return out


def stream_run(n: int, sessions: int, device: str, frames: int, **kw):
    """(sha256 of the send stream, digest stream) of ``frames`` frames on
    ``device``, sessions seated at seeded random spots."""
    role, sink = served_role(n, sessions, device, seat_rng=np.random.default_rng(5), **kw)
    role.kernel.enable_digest()
    digests = []
    serve_run(role, frames, 1000.0, digests=digests)
    out = (sink["sha"].hexdigest(), digests, sink["msgs"])
    role.shut()
    del role
    return out


def journal_run(root, device: str):
    """60 frames of a journaled served role at PARITY_N (a checkpoint at its
    start, client events through the dispatch table): (journal, checkpoint)."""
    from noahgameframe_tpu_torch.net import transport as tr
    from noahgameframe_tpu_torch.net import wire
    from noahgameframe_tpu_torch.net.defines import MsgID
    from noahgameframe_tpu_torch.net.roles.base import RoleConfig
    from noahgameframe_tpu_torch.net.roles.game import GameRole

    jdir, cdir = os.path.join(root, "journal"), os.path.join(root, "ckpt")
    w = journal_world(device)
    role = GameRole(RoleConfig(6, 0, "Rec", "127.0.0.1", 0), backend="py", world=w,
                    cross_server_sync=False, interest_radius=SERVED_RADIUS,
                    serve_batch=True, journal_dir=jdir, checkpoint_dir=cdir,
                    checkpoint_seconds=1e9)
    role.server.send_raw = lambda c, m, b: True
    role.checkpoint_now()
    now, dt = 1000.0, w.config.dt * 1.0001
    for f in range(JOURNAL_FRAMES):
        me = wire.Ident(svrid=99, index=1 + f % 4)
        if f < 4:
            msg = wire.ReqEnterGameServer(account=b"a%d" % f, name=b"P%d" % f)
            mid = MsgID.REQ_ENTER_GAME
        else:
            msg = wire.ReqAckPlayerMove(target_pos=[wire.Position(
                x=float(5 + f % 50), y=float(7 + (3 * f) % 50), z=0.0)])
            mid = MsgID.REQ_MOVE
        role.server.dispatch.feed([tr.NetEvent(tr.EV_MSG, 1001, int(mid),
                                               wire.wrap(msg, player_id=me))])
        now += dt
        role.execute(now)
    role.shut()
    return jdir, cdir


def pinned_world(n: int, players: int, device: str, guid_base: int = 7_000_000, *,
                 middleware: bool = False, teams: int | None = None):
    """``build_benchmark_world(n)``'s recipe with a Player bank for
    ``players`` and the guid allocator pinned (at ``guid_base``) before the
    NPCs are seeded, so two builds (two devices, two engines) mint the same
    guids and send the same bytes.  ``middleware`` adds the gameplay stack,
    ``teams`` sizes its Team bank."""
    extent = max(64.0, float(np.sqrt(n / 0.4)))
    w = gw.GameWorld(gw.WorldConfig(
        npc_capacity=1 << int(np.ceil(np.log2(max(n, 64)))), extent=extent, seed=SEED,
        player_capacity=1 << int(np.ceil(np.log2(max(players, 64)))),
        middleware=middleware), device=device)
    if teams is not None:
        w.kernel.store_config.capacities["Team"] = teams  # read when start() builds
    w.start()
    w.kernel.store.guids.pin(guid_base)
    w.scene.create_scene(1, width=extent)
    w.seed_npcs(n)
    return w


def journal_world(device: str):
    return pinned_world(PARITY_N, 64, device)


def phase_served(card: str):
    """(i): the game role's served frame at 100,000 NPCs and 500 sessions
    (radius 8, combat on, engine 1, sort) under each serve engine, batch at
    1M, cuda against cpu and graph against eager at 4,096 NPCs, a journal
    replayed on both devices, and the bench's --served line."""
    from noahgameframe_tpu_torch.replay.bisect import bisect_divergence
    from noahgameframe_tpu_torch.replay.replayer import make_offline_role, replay_journal

    t_phase = time.perf_counter()
    engines = {}
    for name, kw in ENGINES.items():
        engines[name] = served_engine(name, SERVED_N, SERVED_FRAMES, **kw)
    SERVED_BATCH.update(engines["batch"])
    # the same world and frames under legacy and batch: equal wire streams
    sha = {}
    for name in ("legacy", "batch"):
        sha[name] = stream_run(SERVED_N, SERVED_SESSIONS, DEV, 12, **ENGINES[name])
    check(sha["legacy"][0] == sha["batch"][0] and sha["legacy"][1] == sha["batch"][1],
          "legacy and batch send streams are byte-equal at 100k / 500 sessions")
    # engine 2 (the fused kernel) serves too
    os.environ["NF_PALLAS"] = "2"
    try:
        engine2 = served_engine("batch_engine2", SERVED_N, 10, fold="fused_neighborhood",
                                **ENGINES["batch"])
    finally:
        os.environ.pop("NF_PALLAS")
    big = served_engine("batch_1m", SERVED_1M, SERVED_FRAMES, **ENGINES["batch"])
    # parity on the card: cuda against cpu, graph against eager
    par_kw = dict(ENGINES["batch"])
    cuda_run = stream_run(PARITY_N, PARITY_SESSIONS, DEV, PARITY_FRAMES, **par_kw)
    cpu_run = stream_run(PARITY_N, PARITY_SESSIONS, "cpu", PARITY_FRAMES, **par_kw)
    eager_run = stream_run(PARITY_N, PARITY_SESSIONS, DEV, PARITY_FRAMES, graph_tick=False,
                           **par_kw)
    check(cuda_run[0] == cpu_run[0] and cuda_run[1] == cpu_run[1],
          "cuda and cpu send streams and digests equal at 4,096 / 32 sessions")
    check(cuda_run[0] == eager_run[0] and cuda_run[1] == eager_run[1],
          "graph and eager ticks give equal send streams and digests")
    # the overlap engine serves the pre-tick snapshot around the graph
    # tick's in-place replay; the train fans 8 stacked frames out
    for name, frames in (("overlap", 6), ("train8", 2)):
        on_card = stream_run(PARITY_N, PARITY_SESSIONS, DEV, frames, **ENGINES[name])
        on_cpu = stream_run(PARITY_N, PARITY_SESSIONS, "cpu", frames, **ENGINES[name])
        check(on_card[:2] == on_cpu[:2] and on_card[2] > 0,
              f"{name}: cuda and cpu send streams and digests equal at 4,096")
    # journal: record on the card, replay on the card and on the CPU
    root = tempfile.mkdtemp(prefix="nf_served_")
    try:
        jdir, cdir = journal_run(root, DEV)
        reps = {}
        for dev in (DEV, "cpu"):
            role = make_offline_role(journal_world(dev), backend="py")
            rep = replay_journal(jdir, checkpoint=cdir, role=role)
            role.shut()
            check(rep.ok and rep.ticks_replayed == JOURNAL_FRAMES,
                  f"journal replays digest-clean on {dev}: {rep.summary()}")
            reps[dev] = rep
        injected = 37

        def perturb(role, tick):
            if tick == injected:
                g = role.kernel.store._hosts["NPC"].row_guid[11]
                role.kernel.set_property(g, "HP", 3)

        role = make_offline_role(journal_world(DEV), backend="py")
        bad = replay_journal(jdir, checkpoint=cdir, role=role, perturb=perturb)
        role.shut()
        named = bisect_divergence(bad.expected, bad.digests)
        check(named == injected and bad.first_divergence == injected,
              f"bisect names the injected tick ({named} vs {injected})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free()
    # the bench line, as a user runs it
    cmd = [sys.executable, "-m", "noahgameframe_tpu_torch.bench", "--served", "--entities",
           str(SERVED_N), "--sessions", str(SERVED_SESSIONS), "--interest-radius",
           str(SERVED_RADIUS), "--serve-batch", "--device", DEV]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"the served bench exits 0 ({proc.stderr[-2000:]})")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    d = line["detail"]
    for key in ("frame_ms_p50", "frame_ms_p95", "frame_ms_p99", "sync_msgs", "sync_bytes",
                "serve_batch", "serve_overlap", "pipeline", "device_name", "power_limit_w"):
        check(key in d, f"the served bench line has {key}")
    check(line["metric"] == "served_entity_ticks_per_sec" and line["value"] > 0,
          "the served bench measured its frames")
    emit({"phase": "served", "card": card, "frame_limit_ms": FRAME_LIMIT_MS,
          "engines": engines, "engine2": engine2, "batch_1m": big,
          "batch_1m_within_limit": {"p50": big["frame_ms_p50"] <= FRAME_LIMIT_MS,
                                    "p99": big["frame_ms_p99"] <= FRAME_LIMIT_MS},
          "legacy_batch_equal": True, "stream_sha": sha["batch"][0],
          "cuda_cpu_equal": ["batch", "overlap", "train8"], "graph_eager_equal": True,
          "parity": {"entities": PARITY_N, "sessions": PARITY_SESSIONS,
                     "frames": PARITY_FRAMES, "msgs": cuda_run[2],
                     "last_digest": cuda_run[1][-1]},
          "journal": {"frames": JOURNAL_FRAMES, "events": reps[DEV].events_fed,
                      "clean_on": sorted(reps), "bisect_tick": injected},
          "seconds": time.perf_counter() - t_phase})
    emit({"phase": "bench_served", "line": line})
    served_launches = {nm: sum(e["launches"][nm] for e in (*engines.values(), engine2, big))
                       for nm in sck.KERNELS}
    return served_launches


# -- (j) the five-role cluster ---------------------------------------------------------
CLUSTER_N = 100_000
CLUSTER_CLIENTS = 64
CLUSTER_PLAYERS = 128  # each game's Player bank: its clients, the switched and the re-homed
CLUSTER_KW = {"interest_radius": SERVED_RADIUS, "serve_batch": True}
# lease cadence for the card run (see phase_cluster's docstring): keepalive
# reports every KEEPALIVE_S, SUSPECT after LEASE_SUSPECT_S and DOWN after
# LEASE_DOWN_S of silence, sized above the longest pump stall measured
KEEPALIVE_S, LEASE_SUSPECT_S, LEASE_DOWN_S = 0.25, 3.0, 6.0
GUID_BASE = {"Game1": 7_000_000, "Game2": 9_000_000}
SWITCHES = 8
AFTER_CHATS = 5  # numbered chats each orphaned client sends into the outage
EXTRA_TICKS = 20  # revived-world ticks before the control comparison
LOCKSTEP_N, LOCKSTEP_CLIENTS = 4096, 8


def cluster_package(name: str = "noahgameframe_tpu_torch"):
    """The modules a cluster script needs, taken from one package by name:
    the same script drives the port's cluster here and, in the CPU tests,
    the JAX package's."""
    import importlib
    from types import SimpleNamespace

    def m(sub):
        return importlib.import_module(f"{name}.{sub}")

    return SimpleNamespace(name=name, client=m("client"), roles=m("net.roles"),
                           wire=m("net.wire"), defines=m("net.defines"),
                           transport=m("net.transport"), datatypes=m("core.datatypes"),
                           world=m("game.world"), chaos=m("net.chaos"),
                           codec=m("persist.codec"), writebehind=m("persist.writebehind"),
                           persist=m("persist"), checkpoint=m("persist.checkpoint"),
                           gdefines=m("game.defines"))


def recording_client(P, account: str):
    """A ``GameClient`` whose every received frame, ``(msg id, envelope
    bytes)``, is appended to ``client.log`` across its dials (login, then
    the proxy)."""
    cli = P.client.GameClient(account)
    cli.log = []
    dial = cli.connect

    def connect(host, port):
        dial(host, port)
        conn, poll = cli._conn, cli._conn.poll

        def recorded():
            evs = poll()
            cli.log.extend((int(ev.msg_id), bytes(ev.body)) for ev in evs
                           if ev.kind == P.transport.EV_MSG)
            return evs

        conn.poll = recorded

    cli.connect = connect
    return cli


def canonical_log(P, log) -> dict:
    """A client log with what differs between two equal runs masked:
    frame-trace sidecars (wall-clock stamps) are left out, and the connect
    grant's proxy port and connect key (random, ``WorldRole._mint_key``)
    are zeroed.  The rest is grouped by message id and each group sorted:
    arrival order across links (the world's cross-game relay) is not part
    of a run's result."""
    wire, MsgID = P.wire, P.defines.MsgID
    out: dict = {}
    for mid, body in log:
        if mid in P.defines.TRACE_MSG_IDS:
            continue
        if mid == int(MsgID.ACK_CONNECT_WORLD):
            base, ack = wire.unwrap(body, wire.AckConnectWorldResult)
            ack.world_port, ack.world_key = 0, b""
            base.msg_data = ack.encode()
            body = base.encode()
        out.setdefault(mid, []).append(bytes(body).hex())
    return {m: sorted(v) for m, v in sorted(out.items())}


def mirror_view(cli) -> dict:
    """A client's mirror as plain values (idents as pairs)."""
    def plain(v):
        if hasattr(v, "svrid"):
            return (v.svrid, v.index)
        if isinstance(v, (list, tuple)):
            return tuple(plain(x) for x in v)
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        return v

    return {k: (plain(o.ident), o.class_id, o.config_id, o.scene_id, plain(o.position),
                plain(o.properties), plain(o.records)) for k, o in sorted(cli.objects.items())}


LOGIN_STEPS = ("login connect", "login ack", "world list", "world grant", "proxy connect",
               "key verify", "server select", "role list", "enter game")


class ClusterDriver:
    """One script's hold on a LocalCluster: its clients (pumped with every
    cluster round), login through the full chain, and waits that fail with
    what they waited for.

    With ``lockstep`` the game roles tick only in :meth:`tick`: between
    calls their frames see no tick due (``_last_tick`` held in the
    future), so every client action lands between the same two ticks in
    any run, and two runs of one script (two packages, two devices) send
    the same frames.  Build the driver before ``cluster.start()``, which
    pumps the games.  Without it the games tick on the wall clock, as
    deployed."""

    def __init__(self, P, cluster, timeout: float = 30.0, lockstep: bool = False) -> None:
        self.P, self.c, self.timeout = P, cluster, timeout
        self.lockstep = lockstep
        self.clients: dict = {}
        self.live: list = []  # clients pumped with the cluster
        self.max_round_s = 0.0  # the longest pump round seen (leases must outlast it)
        self._t_round = None
        if lockstep:
            self.hold()

    def hold(self) -> None:
        """Lockstep: no game ticks until :meth:`tick` (call again after a
        revive adds a role)."""
        for g in self.c.games:
            g._last_tick = math.inf

    def tick(self, n: int = 1) -> None:
        """Advance every game ``n`` frames: in lockstep each frame is one
        explicit ``execute`` with a tick due; otherwise wait for the wall
        clock's frames."""
        if self.lockstep:
            for _ in range(n):
                for g in self.c.games:
                    g._last_tick = -math.inf
                    g.execute()
                    g._last_tick = math.inf
            return
        goal = [(g, g.kernel.tick_count + n) for g in self.c.games]
        self.wait(lambda: all(g.kernel.tick_count >= t for g, t in goal), f"{n} frames")

    def synced(self, pairs, props=("MAXEXP",)) -> None:
        """Wait until each ``(watcher, owner, game)``'s mirror of the owner
        holds the game's values of ``props`` (a tick's derived diffs, such
        as MAXEXP after a level change, reach clients after the tick)."""
        def ok():
            for watcher, owner, game in pairs:
                o = watcher.objects.get(self.key(owner))
                if o is None:
                    return False
                for p in props:
                    if o.properties.get(p) != game.kernel.get_property(self.guid(owner), p):
                        return False
            return True

        self.wait(ok, f"the mirrors caught up on {props}")

    def _stir(self) -> None:
        now = time.perf_counter()
        if self._t_round is not None:
            self.max_round_s = max(self.max_round_s, now - self._t_round)
        self._t_round = now
        for cli in self.live:
            cli.execute()

    def pump_until(self, cond, timeout=None) -> bool:
        self._t_round = None
        return self.c.pump_until(cond, extra=self._stir, timeout=timeout or self.timeout)

    def wait(self, cond, what: str, timeout=None) -> None:
        check(self.pump_until(cond, timeout), f"cluster: {what}")

    def pump(self, rounds: int) -> None:
        self._t_round = None
        self.c.pump(extra=self._stir, rounds=rounds)

    def client(self, account: str):
        cli = recording_client(self.P, account)
        self.clients[account] = cli
        self.live.append(cli)
        return cli

    def login_all(self, specs, timeout=None):
        """Log each ``(account, role name, game id)`` in through login,
        world, proxy and game, all at once (each client advances as soon
        as its own answer arrives); returns each client's login-to-entered
        seconds."""
        c = self.c
        fsm = []
        for account, name, game_id in specs:
            cli = self.client(account)
            steps = [
                (lambda cli=cli: cli.connect("127.0.0.1", c.login.config.port),
                 lambda cli=cli: cli.connected),
                (cli.login, lambda cli=cli: cli.logged_in),
                (cli.request_world_list, lambda cli=cli: cli.worlds),
                (lambda cli=cli: cli.connect_world(cli.worlds[0].server_id),
                 lambda cli=cli: cli.world_grant is not None),
                (cli.connect_proxy, lambda cli=cli: cli.connected),
                (cli.verify_key, lambda cli=cli: cli.key_verified),
                (lambda cli=cli, g=game_id: cli.select_server(g),
                 lambda cli=cli: cli.server_selected),
                (lambda cli=cli, n=name: cli.create_role(n), lambda cli=cli: cli.roles),
                (lambda cli=cli, n=name: cli.enter_game(n), lambda cli=cli: cli.entered),
            ]
            steps[0][0]()
            fsm.append([cli, steps, 0, time.perf_counter(), None])

        def advance():
            for st in fsm:
                cli, steps, i, _t0, done = st
                if done is None and steps[i][1]():
                    if i + 1 == len(steps):
                        st[4] = time.perf_counter()
                    else:
                        st[2] = i + 1
                        steps[i + 1][0]()
            return all(st[4] is not None for st in fsm)

        ok = self.pump_until(advance, timeout)
        stuck = [(st[0].account, LOGIN_STEPS[st[2]]) for st in fsm if st[4] is None]
        check(ok, f"cluster: every client entered (stalled: {stuck[:8]})")
        return [st[4] - st[3] for st in fsm]

    def guid(self, cli):
        return self.P.datatypes.Guid(cli.player_guid.svrid, cli.player_guid.index)

    @staticmethod
    def key(cli):
        return (cli.player_guid.svrid, cli.player_guid.index)

    @staticmethod
    def session(game, account: str):
        return next((s for s in game.sessions.values()
                     if s.account == account and s.guid is not None), None)

    def close(self, cli, game=None) -> None:
        """Close a client; with ``game``, wait until its session left it."""
        cli.close()
        if cli in self.live:
            self.live.remove(cli)
        if game is not None:
            self.wait(lambda: self.session(game, cli.account) is None,
                      f"{cli.account}'s session left {game.config.name}")


def pair_flows(d, a, b, game, move=(3.0, 4.0, 0.0)) -> None:
    """tests/test_roles.py's two-client flows on one game: ``a`` and ``b``
    see each other, a move reaches ``b``'s mirror through the diff (or
    interest) stream, a chat echoes, a skill drops ``b``'s HP by the
    role's damage on the server and in ``b``'s mirror, and a bag record
    row added, updated and removed on the server reaches ``a``'s mirror."""
    ak, bk = d.key(a), d.key(b)
    d.wait(lambda: bk in a.objects and ak in b.objects, "the two clients see each other")
    a.move_to(*move)
    d.wait(lambda: b.moves, "the move multicast")
    check(abs(b.moves[-1].target_pos[0].x - move[0]) < 1e-5, "the move's target")
    d.wait(lambda: ak in b.objects and abs(
        b.objects[ak].properties.get("Position", (0.0, 0.0, 0.0))[0] - move[0]) < 0.05,
        "the mover's Position reached the other mirror")
    n0 = len(b.chat_log)
    a.chat("hello")
    d.wait(lambda: len(b.chat_log) > n0 and b.chat_log[-1][1] == "hello", "the chat echo")
    k, gb = game.kernel, d.guid(b)
    hp0 = int(k.get_property(gb, "HP"))
    n0 = len(b.skills)
    a.use_skill(b.player_guid)
    d.wait(lambda: len(b.skills) > n0, "the skill multicast")
    hp1 = int(k.get_property(gb, "HP"))
    check(hp1 == hp0 - game.skill_damage, f"the skill dropped HP by {game.skill_damage}")
    d.wait(lambda: b.objects[bk].properties.get("HP") == hp1, "the HP drop reached the mirror")
    ga = d.guid(a)
    k.state, row = k.store.record_add_row(k.state, ga, "BagItemList",
                                          {"ConfigID": "potion_small", "ItemCount": 3})
    cells = lambda: a.objects[ak].records.get("BagItemList", {})  # noqa: E731
    d.wait(lambda: cells().get((row, 0)) == "potion_small" and cells().get((row, 1)) == 3,
           "the added bag row reached the mirror")
    k.state = k.store.record_set(k.state, ga, "BagItemList", row, "ItemCount", 5)
    d.wait(lambda: cells().get((row, 1)) == 5, "the bag row's count update")
    k.state = k.store.record_remove_row(k.state, ga, "BagItemList", row)
    d.wait(lambda: (row, 0) not in cells(), "the bag row's removal")



def failover_plan(P, seed: int):
    """scripts/failover_smoke.py's fault plan: dups and delays on the dying
    game's links, dups on the survivor's, and a wedged store flusher under
    Game1, so its last saves live only in the WAL."""
    ch = P.chaos
    return ch.FaultPlan(seed=seed, links={
        "proxy5.games->6": ch.LinkFaults(dup=0.05, delay=0.05, delay_polls=2),
        "proxy5.games->16": ch.LinkFaults(dup=0.02),
        "game6.world": ch.LinkFaults(dup=0.02),
    }, stores={"game6.store": ch.StoreFaults(fail_first=1_000_000)})


def failover_kill(d, game1, game2, clients, kv, wal_dir, after_chats: int = AFTER_CHATS):
    """scripts/failover_smoke.run's kill and re-home, for ``clients``
    entered on ``game1`` (a LocalCluster with per-game WAL and checkpoint
    dirs over the store ``kv``, under :func:`failover_plan`): distinct
    saves staged to the WAL, a checkpoint, a hard kill, numbered chats
    into the outage, and the world's re-home of every session onto
    ``game2``.  Returns ``(checks, info)``: each check by name, and the
    blip (kill to last re-home), the parked frames and the bases."""
    P, c = d.P, d.c
    proxy, world = c.proxy, c.world
    checks: dict = {}
    sess = {cl.account: d.session(game1, cl.account) for cl in clients}
    selfids = {(s.guid.head, s.guid.data) for s in sess.values() if s is not None}
    checks["sessions bound on the dying game"] = all(s is not None for s in sess.values())
    check(checks["sessions bound on the dying game"], "failover: sessions bound")
    k1, agent1 = game1.kernel, game1.data_agent
    pre, pre_blob, keys = {}, {}, {}
    for i, cl in enumerate(clients):
        s = sess[cl.account]
        k1.set_property(s.guid, "Gold", 1000 + 37 * i)
        k1.set_property(s.guid, "Level", 9)
        pre[cl.account] = {p: k1.get_property(s.guid, p) for p in ("Name", "Level", "Gold")}
        pre_blob[cl.account] = P.codec.snapshot_object(k1.store, k1.state, s.guid, agent1.flags)
        agent1.save(s.guid)
        keys[cl.account] = agent1._key_of(s.guid)
    game1.checkpoint_now()  # checkpoint + WAL barrier
    view = P.writebehind.read_peer_wal(wal_dir)
    checks["WAL holds bit-identical pre-kill blobs"] = all(
        view.pending.get(keys[a]) == pre_blob[a] for a in keys)
    checks["store never saw the final saves"] = all(kv.get(keys[a]) != pre_blob[a] for a in keys)
    done0 = len(world.failover.completed)
    n = len(clients)
    t = {"rehomed": None, "max_pending": 0}

    def watch():
        t["max_pending"] = max(t["max_pending"], world.failover.pending_count())
        if t["rehomed"] is None and sum(
                1 for e in world.failover.completed[done0:] if tuple(e["selfid"]) in selfids) >= n:
            t["rehomed"] = time.perf_counter()

    dead = game1.config.server_id
    t_kill = time.perf_counter()
    c.kill_role(game1, hard=True)
    checks["proxy saw the link drop"] = d.pump_until(
        lambda: watch() or dead not in proxy.games.connected_servers(), timeout=10.0)
    # the first chat goes out before the next pump round, so it reaches
    # the proxy while the binding is dead and parks
    for cl in clients:
        cl.chat(f"after-{cl.account}-0")
    for cl in clients:
        cl.execute()
    sent = [1]

    def mine(cl):
        pre_ = f"after-{cl.account}-"
        return [x for _w, x in cl.chat_log if x.startswith(pre_)]

    def settled():
        watch()
        if sent[0] < after_chats:
            for cl in clients:
                cl.chat(f"after-{cl.account}-{sent[0]}")
            sent[0] += 1
            return False
        return (all(d.session(game2, cl.account) is not None for cl in clients)
                and world.failover.pending_count() == 0 and proxy.parking.depth() == 0
                and all(len(set(mine(cl))) >= after_chats for cl in clients))

    checks["sessions re-homed to the survivor"] = d.pump_until(settled, timeout=60.0)
    checks["failover was observable while pending"] = t["max_pending"] > 0
    for cl in clients:
        first_seen = list(dict.fromkeys(mine(cl)))  # the chaos link dups frames
        checks[f"{cl.account} chat replayed complete and in order"] = (
            first_seen == [f"after-{cl.account}-{i}" for i in range(after_chats)])
    checks["frames were actually parked"] = proxy.parking.parked_total > 0
    checks["nf_failover_dropped_total == 0"] = proxy.parking.dropped_total == 0
    k2 = game2.kernel
    for cl in clients:
        s2 = d.session(game2, cl.account)
        got = None if s2 is None else {p: k2.get_property(s2.guid, p)
                                       for p in ("Name", "Level", "Gold")}
        checks[f"{cl.account} state recovered on the survivor"] = got == pre[cl.account]
        checks[f"{cl.account} rebound to the survivor"] = (
            s2 is not None
            and int(k2.get_property(s2.guid, "GameID")) == game2.config.server_id)
    new = [e for e in world.failover.completed[done0:] if tuple(e["selfid"]) in selfids]
    # the world also re-homes a player that switched away from the dead
    # game earlier (a ghost: the origin never sends an offline notice for
    # a switched player, so its bind info stays; the JAX package does the
    # same, ROADMAP.md section 3)
    ghosts = len(world.failover.completed) - done0 - len(new)
    bases = sorted({e["basis"] for e in new})
    checks["recovery basis was the WAL suffix"] = len(new) == n and bases == ["wal"]
    reg = world.telemetry.registry
    checks["failover counters balanced"] = (
        reg.value("nf_failover_initiated_total") == reg.value("nf_failover_completed_total")
        >= n + ghosts)
    checks["clients got the REHOMING notice"] = all(
        any(int(x.code) == int(P.defines.SwitchNoticeCode.REHOMING) for x in cl.switch_notices)
        for cl in clients)
    checks["zero session drops"] = (all(cl.entered for cl in clients)
                                    and proxy.parking.dropped_disconnect == 0)

    def fo_settled():
        fo = c.master.servers_status().get("failover", {})
        return bool(fo) and all(v.get("pending") == 0 for v in fo.values() if "pending" in v)

    checks["master /json failover block"] = d.pump_until(fo_settled, timeout=10.0)
    page = json.loads(http_get(c, c.master.http.port, "/json", d._stir))
    checks["/json serves the failover block over HTTP"] = "failover" in page
    info = {"sessions": n, "blip_ms": None if t["rehomed"] is None
            else (t["rehomed"] - t_kill) * 1e3,
            "parked_frames": proxy.parking.parked_total, "bases": bases,
            "max_pending": t["max_pending"], "ghost_rehomes": ghosts}
    return checks, info


def chaos_plan(P, seed: int, partition=(200, 400), dial_refusals: int = 0):
    """scripts/chaos_smoke.py's fault plan: refusals, drops and dups on the
    game's world link, a refusal budget with drops, dups and delays on
    the proxy's world link, dups, corruption and truncation on the proxy's
    game links, and a timed both-way login-master partition (``partition``
    in polls of that link).  ``dial_refusals`` adds a refusal budget to the
    game's world link and the proxy's game links, for a plan applied to a
    running cluster (whose live links dial nothing until a revive)."""
    ch = P.chaos
    return ch.FaultPlan(seed=seed, links={
        "game6.world": ch.LinkFaults(refuse=0.25, drop=0.05, dup=0.05,
                                     refuse_first=dial_refusals),
        "proxy5.world": ch.LinkFaults(refuse_first=2, drop=0.05, dup=0.1, delay=0.1,
                                      delay_polls=5),
        "proxy5.games": ch.LinkFaults(dup=0.1, corrupt=0.05, truncate=0.05,
                                      refuse_first=dial_refusals),
        "login4.master": ch.LinkFaults(partitions=((partition[0], partition[1], "both"),)),
    })


def lease_of(cluster, role: str, sid: int):
    for e in cluster.master.servers_status()["servers"].get(role, []):
        if e["server_id"] == sid:
            return e["lease"]
    return None


def drive_control(world, ticks: int) -> None:
    """Tick a world that serves no role to ``ticks`` in GameRole.execute's
    per-tick module order."""
    pm, k = world.pm, world.kernel
    while k.tick_count < ticks:
        for m in pm.modules.values():
            if m is not k:
                m.execute()
        k.execute()
        k.tick()
        pm.frame += 1


def kill_revive(d, name: str, ckpt, world, *, hard: bool, extra_ticks: int = EXTRA_TICKS,
                timeout: float = 60.0, on_down=None, on_revived=None):
    """scripts/chaos_smoke.run's kill and revive of the game role ``name``
    (its checkpoint in ``ckpt``): wait for the checkpoint, kill it, watch
    the master's lease turn DOWN (then ``on_down()``), revive it with
    ``resume=True`` over ``world`` (then ``on_revived(role)``, before it
    ticks), watch the lease turn UP with the cluster wired, and let it
    tick ``extra_ticks``.  Returns ``(revived role, checks, info)``."""
    import pathlib

    c = d.c
    sid = c.role_by_name(name).config.server_id
    checks: dict = {}
    checks["checkpoint written"] = d.pump_until(
        lambda: (pathlib.Path(ckpt) / "meta.json").exists(), timeout)
    t0 = time.perf_counter()
    c.kill_role(name, hard=hard)
    checks["master marks game DOWN"] = d.pump_until(
        lambda: lease_of(c, "game", sid) == "DOWN", timeout)
    t_down = time.perf_counter() - t0
    if on_down is not None:
        on_down()
    t1 = time.perf_counter()
    revived = c.revive_role(name, world=world, resume=True)
    t_revive = time.perf_counter() - t1
    if on_revived is not None:
        on_revived(revived)
    if d.lockstep:
        d.hold()
    checks["resume restored checkpoint"] = (
        revived.telemetry.registry.value("nf_recoveries_total") == 1)
    checks["master marks game UP"] = d.pump_until(
        lambda: lease_of(c, "game", sid) == "UP" and c.wired(), timeout)
    target = revived.kernel.tick_count + extra_ticks
    checks["revived world ticking"] = d.pump_until(
        lambda: revived.kernel.tick_count >= target, timeout)
    return revived, checks, {"down_s": t_down, "revive_s": t_revive,
                             "resumed_tick": target - extra_ticks}


def banks_equal(P, a_state, b_flat) -> bool:
    """The revived world's NPC banks, tick and rng against a control's
    (``b_flat``: a ``_flatten_state`` dict, from either package)."""
    a = P.checkpoint._flatten_state(a_state)
    keys = [key for key in b_flat if key.startswith("c/NPC/")]
    return (bool(keys) and int(a["tick"]) == int(b_flat["tick"])
            and np.array_equal(np.asarray(a["rng"]), np.asarray(b_flat["rng"]))
            and all(np.array_equal(np.asarray(a[key]), np.asarray(b_flat[key])) for key in keys))


def chaos_counters(d, revived) -> tuple:
    """chaos_smoke's counter checks, in-process and over real ``/metrics``
    scrapes of the master, the revived game and the proxy.  Returns
    ``(checks, the revived game's nf_chaos_faults_total lines)``."""
    c = d.c
    checks = {"faults injected": c.chaos.total() > 0}
    checks["retries counted"] = sum(
        sum(p.retries_total.values()) for r in c.roles for p in r.clients.values()) > 0
    checks["lease expiry counted"] = c.master.telemetry.registry.value(
        "nf_lease_expirations_total", role="game") >= 1
    checks["partition healed"] = (c.chaos.total("partition_out") > 0
                                  and lease_of(c, "login", 4) == "UP")

    def lines(port):
        return http_get(c, port, "/metrics", d._stir).decode().splitlines()

    master = lines(c.master.http.port)
    checks["/metrics lease counters"] = any(
        ln.startswith('nf_lease_expirations_total{role="game"}') and float(ln.split()[-1]) >= 1
        for ln in master)
    game = lines(revived.serve_metrics(0).port)
    chaos = [ln for ln in game if ln.startswith("nf_chaos_faults_total{")]
    checks["/metrics chaos counters"] = any(float(ln.split()[-1]) > 0 for ln in chaos)
    checks["/metrics recovery counter"] = any(
        ln.startswith("nf_recoveries_total ") and float(ln.split()[-1]) == 1 for ln in game)
    proxy = lines(c.proxy.serve_metrics(0).port)
    checks["/metrics retry counters"] = any(
        ln.startswith("nf_reconnects_total{") and float(ln.split()[-1]) > 0 for ln in proxy)
    return checks, chaos


def http_get(cluster, port: int, path: str, extra=None) -> bytes:
    """GET ``path`` from an HttpServer of the cluster while a thread pumps
    the cluster (and ``extra``) for it."""
    import threading
    import urllib.request

    stop = threading.Event()

    def pump():
        while not stop.is_set():
            cluster.execute()
            if extra is not None:
                extra()
            time.sleep(0.002)

    th = threading.Thread(target=pump, daemon=True)
    th.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.read()
    finally:
        stop.set()
        th.join(timeout=30)


class FrameTimer:
    """Wall time of each frame (an ``execute`` pass that ticked) of the
    game roles it wraps, in ms by role name."""

    def __init__(self) -> None:
        self.ms: dict = {}

    def wrap(self, role) -> None:
        inner, k = role.execute, role.kernel
        ms = self.ms.setdefault(role.config.name, [])

        def execute(now=None):
            t0, tick0 = time.perf_counter(), k.tick_count
            inner(now)
            if k.tick_count != tick0:
                ms.append((time.perf_counter() - t0) * 1e3)

        role.execute = execute

    def take(self) -> dict:
        """Each role's frame count, p50 and p99 since the last take."""
        out = {name: {"frames": len(v), "p50_ms": pct(v, 50), "p99_ms": pct(v, 99)}
               for name, v in self.ms.items() if v}
        for v in self.ms.values():
            v.clear()
        return out


class LaunchWindow:
    """The fold launches a window of frames must make: each world's ticks
    in the window, plus ``WARMUP_RUNS`` eager runs of a step for each
    capture its cost book logged in the window (a re-capture's warm-up
    launches the fold too).  ``drop`` books a killed world's share and
    lets go of it."""

    def __init__(self) -> None:
        self.live: dict = {}
        self.booked = 0

    def add(self, kernel) -> None:
        self.live[id(kernel)] = (kernel, kernel.tick_count, kernel.costbook._seq)

    @staticmethod
    def _share(kernel, tick0: int, seq0: int) -> int:
        caps = sum(1 for r in kernel.costbook.compile_log
                   if r["seq"] >= seq0 and r["entry"] == "kernel.step")
        return kernel.tick_count - tick0 + WARMUP_RUNS * caps

    def drop(self, kernel) -> None:
        k, tick0, seq0 = self.live.pop(id(kernel))
        self.booked += self._share(k, tick0, seq0)

    def expected(self) -> int:
        return self.booked + sum(self._share(*v) for v in self.live.values())


def lease_expiries(c) -> dict:
    """Every lease expiry the master and the world counted, by role."""
    out = {}
    for where, role in (("master", c.master), ("world", c.world)):
        reg = role.telemetry.registry
        for r in ("world", "login", "proxy", "game"):
            v = reg.value("nf_lease_expirations_total", role=r)
            if v:
                out[f"{r}_at_{where}"] = v
    return out


def cluster_memory() -> dict:
    free()
    if DEV != "cuda":
        return {"allocated": 0, "reserved": 0}
    return {"allocated": torch.cuda.memory_allocated(), "reserved": torch.cuda.memory_reserved()}


def state_bytes(state) -> int:
    return sum(x.numel() * x.element_size() for x in tree.flatten(state)[0]
               if isinstance(x, torch.Tensor))


def recaptures(kernel, seq0: int) -> list:
    return [{"entry": r["entry"], "seq": r["seq"], "cause": r.get("cause")}
            for r in kernel.costbook.compile_log if r["seq"] >= seq0]


def lockstep_run(device: str) -> dict:
    """The scripted cluster run at LOCKSTEP_N NPCs and LOCKSTEP_CLIENTS
    clients (two games on ``device``, radius 8, batched serving), in
    lockstep: logins one at a time with two frames after each, a seeded
    move a client with a frame after each, a chat round, a skill, a bag
    record row, a switch from Game1 to Game2, twenty frames, and a final
    chat barrier.  Returns each game's last ``state_digest`` and each
    client's canonical log and mirror."""
    P = cluster_package()
    worlds = {n: pinned_world(LOCKSTEP_N, 64, device, GUID_BASE[n]) for n in ("Game1", "Game2")}
    for w in worlds.values():
        w.kernel.enable_digest()
    c = P.roles.LocalCluster(backend="auto", n_games=2, device=device, game_kwargs=CLUSTER_KW,
                             game_kwargs_by_name={n: {"world": w} for n, w in worlds.items()})
    del worlds
    try:
        d = ClusterDriver(P, c, timeout=120.0, lockstep=True)
        c.start(timeout=120.0)
        g1, g2 = c.games
        gid = {6: g1, 16: g2}
        clients = []
        for i in range(LOCKSTEP_CLIENTS):
            sid = 6 if i % 2 == 0 else 16
            d.login_all([(f"l{i}", f"L{i}", sid)])
            clients.append(d.clients[f"l{i}"])
            d.tick(2)
        rng = np.random.default_rng(11)
        for i, cl in enumerate(clients):
            x, y = (float(v) for v in rng.uniform(1.0, 7.0, 2))
            cl.move_to(x, y)
            game = gid[6 if i % 2 == 0 else 16]
            d.wait(lambda cl=cl, game=game, x=x: abs(
                game.kernel.get_property(d.guid(cl), "Position")[0] - x) < 1e-4,
                f"{cl.account}'s move landed")
            d.tick(1)
        for cl in clients:
            n0 = len(cl.chat_log)
            cl.chat(f"hi from {cl.account}")
            d.wait(lambda cl=cl, n0=n0: any(t == f"hi from {cl.account}"
                                            for _w, t in cl.chat_log[n0:]), "a chat echo")
        d.tick(1)
        a, b = clients[0], clients[2]
        a.use_skill(b.player_guid)
        d.wait(lambda: b.skills, "the skill multicast")
        d.tick(1)
        k1 = g1.kernel
        k1.state, row = k1.store.record_add_row(k1.state, d.guid(a), "BagItemList",
                                                {"ConfigID": "potion_small", "ItemCount": 2})
        d.wait(lambda: a.objects[d.key(a)].records.get("BagItemList", {}).get((row, 1)) == 2,
               "the bag row")
        d.tick(1)
        mover = clients[4]
        g_old = d.guid(mover)
        mover.switch_server(16)
        d.wait(lambda: d.session(g2, mover.account) is not None
               and g_old not in k1.store.guid_map, "the switch to Game2")
        d.tick(20)
        for cl in clients:
            cl.chat(f"end {cl.account}")
        d.wait(lambda: all(any(t == f"end {cl.account}" for _w, t in cl.chat_log)
                           for cl in clients), "the end barrier")
        d.pump(40)
        return {"digests": {g.config.name: g.kernel.last_counters["state_digest"] & 0xFFFFFFFF
                            for g in (g1, g2)},
                "ticks": {g.config.name: g.kernel.tick_count for g in (g1, g2)},
                "logs": {a: canonical_log(P, x.log) for a, x in d.clients.items()},
                "mirrors": {a: mirror_view(x) for a, x in d.clients.items()}}
    finally:
        c.shut()


def phase_cluster(card: str):
    """(j): the five-role cluster on the card (run after (i)).

    ``LocalCluster(backend="auto", http_port=0, n_games=2, device="cuda")``
    over two worlds of ``build_benchmark_world(100_000)``'s recipe (combat
    on, engine 1, sort, no skin; 128 Player rows; each game's guids pinned
    at its own base), radius 8 and batched serving, every frame's tick a
    CUDA graph; per-game WAL and checkpoint dirs over one store.  Every
    other world the phase needs is built before the cluster starts: a
    build inside the pump would stall every lease.  The lease cadence
    (``KEEPALIVE_S``, ``LEASE_SUSPECT_S``, ``LEASE_DOWN_S``) is passed
    explicitly and sized above the longest pump round, which a world's
    checkpoint, a re-capture or a revive's load can stretch to seconds;
    any lease that expires outside the two kills fails the phase.

    1. 64 clients log in through login, world, proxy and game (32 a game);
       the master's ``/json`` lists all five roles; login latency.
    2. tests/test_roles.py's flows on Game1 (``pair_flows``); the round
       trip of 64 chats; each game's frame p50/p99.
    3. 8 players switch from Game1 to Game2 (``switch_server``): Level,
       Gold and Name arrive, Game1 frees its copies, Game2 serves their
       chat; switch latency.
    4. The failover of scripts/failover_smoke.run at this width
       (``failover_kill``: 24 sessions, WAL basis); the blip, Game2's
       re-captures and their causes.
    5. Chaos and revive as scripts/chaos_smoke.run: Game1 revived fresh
       and client-free, the seeded plan, a checkpoint, a hard kill, DOWN,
       a revive into a fresh world (its bucket boost, host state no
       checkpoint carries, set to the killed world's), UP; the NPC banks,
       tick and rng equal a control world ticked as far; the chaos,
       retry, lease and recovery counters over real ``/metrics``; device
       memory around the kill and two revives.
    6. Login and chat again under ``NF_PALLAS=2``: ``fused_neighborhood``
       launches once a tick.  In steps 1-5 ``combat_fold`` launched once
       a tick plus each re-capture's warm-ups, on every world.
    7. The lockstep script (``lockstep_run``) at 4,096 NPCs and 8 clients
       on the card and on the CPU: equal digests and client logs."""
    import pathlib

    from noahgameframe_tpu_torch.replay.replayer import make_offline_role

    P = cluster_package()
    t_phase = time.perf_counter()
    root = pathlib.Path(tempfile.mkdtemp(prefix="nf_cluster_"))
    out = {"phase": "cluster", "card": card, "entities": CLUSTER_N, "clients": CLUSTER_CLIENTS,
           "keepalive_s": KEEPALIVE_S, "lease_suspect_s": LEASE_SUSPECT_S,
           "lease_down_s": LEASE_DOWN_S}
    c = None
    try:
        t0 = time.perf_counter()
        worlds = {k: pinned_world(CLUSTER_N, CLUSTER_PLAYERS, DEV, GUID_BASE[g])
                  for k, g in (("Game1", "Game1"), ("Game2", "Game2"), ("fresh", "Game1"),
                               ("resume", "Game1"), ("resume2", "Game1"), ("control", "Game1"))}
        out["world_build_s"] = time.perf_counter() - t0
        world_bytes = state_bytes(worlds["Game1"].kernel.state)
        kv = P.persist.MemoryKV()
        per_game = {n: {"data_agent": P.persist.PlayerDataAgent(kv), "persist_store": kv,
                        "persist_wal_dir": root / f"wal{i}", "checkpoint_dir": root / f"ckpt{i}"}
                    for i, n in ((1, "Game1"), (2, "Game2"))}
        for n in per_game:
            per_game[n]["world"] = worlds.pop(n)
        c = P.roles.LocalCluster(
            backend="auto", http_port=0, n_games=2, device=DEV, keepalive_seconds=KEEPALIVE_S,
            lease_suspect_seconds=LEASE_SUSPECT_S, lease_down_seconds=LEASE_DOWN_S,
            game_kwargs={**CLUSTER_KW, "autosave_seconds": 3600.0, "checkpoint_seconds": 3600.0,
                         "persist_drain_timeout": 0.3},
            game_kwargs_by_name=per_game, world_kwargs={"recover_store": kv})
        for n in per_game:
            per_game[n].pop("world")  # revive_role must not reuse a killed world
        timer = FrameTimer()
        for g in c.games:
            timer.wrap(g)
        c.start(timeout=120.0)
        out["frames_start"] = timer.take()  # the first frames capture the tick
        out["backends"] = {r.config.name: type(r.server.transport).__name__ for r in c.roles}
        d = ClusterDriver(P, c, timeout=120.0)
        game1, game2 = c.games
        window = LaunchWindow()
        for g in (game1, game2):
            window.add(g.kernel)
        seq2 = game2.kernel.costbook._seq
        sck.reset_launch_counts()

        # 1. 64 clients through the whole chain
        specs = [(f"p{i:02d}", f"P{i:02d}", 6 if i < CLUSTER_CLIENTS // 2 else 16)
                 for i in range(CLUSTER_CLIENTS)]
        lat = d.login_all(specs, timeout=600.0)
        status = json.loads(http_get(c, c.master.http.port, "/json", d._stir))
        roles = sorted(status["servers"])
        check(roles == ["game", "login", "proxy", "world"] and status["master"]["server_id"] == 1
              and len(status["servers"]["game"]) == 2, f"/json lists all five roles ({roles})")
        check(len(game1.sessions) >= CLUSTER_CLIENTS // 2
              and len(game2.sessions) >= CLUSTER_CLIENTS // 2, "every client has a session")
        out["login_s"] = {"p50": pct(lat, 50), "p99": pct(lat, 99), "max": max(lat)}
        cl = [d.clients[s[0]] for s in specs]

        # 2. the flows of tests/test_roles.py, on the card
        pair_flows(d, cl[0], cl[1], game1)
        sent_at, rtt = {}, {}
        for x in cl:
            sent_at[x.account] = time.perf_counter()
            x.chat(f"rtt {x.account}")

        def echoed():
            now = time.perf_counter()
            for x in cl:
                if x.account not in rtt and any(t == f"rtt {x.account}" for _w, t in x.chat_log):
                    rtt[x.account] = now - sent_at[x.account]
            return len(rtt) == len(cl)

        d.wait(echoed, "64 chat echoes")
        out["chat_rtt_ms"] = {"n": len(rtt), "p50": pct(list(rtt.values()), 50) * 1e3,
                              "p99": pct(list(rtt.values()), 99) * 1e3}
        out["flows"] = ["see each other", "move", "chat", "skill -10 HP", "bag row"]
        out["frames_steps_1_2"] = timer.take()

        # 3. eight switches from Game1 to Game2
        movers = cl[2:2 + SWITCHES]
        k1, k2 = game1.kernel, game2.kernel
        props, old, t_sw, t_done = {}, {}, {}, {}
        for i, x in enumerate(movers):
            g = d.guid(x)
            k1.set_property(g, "Level", 5 + i)
            k1.set_property(g, "Gold", 100 + 7 * i)
            props[x.account] = (5 + i, 100 + 7 * i, x.account.upper())
            old[x.account] = g
        for x in movers:
            t_sw[x.account] = time.perf_counter()
            x.switch_server(16)

        def switched():
            now = time.perf_counter()
            for x in movers:
                if x.account not in t_done and d.session(game2, x.account) is not None:
                    t_done[x.account] = now
            return len(t_done) == len(movers) and all(
                old[a] not in k1.store.guid_map and d.session(game1, a) is None for a in old)

        d.wait(switched, "8 switches landed and Game1 freed its copies")
        for x in movers:
            g = d.session(game2, x.account).guid
            got = (int(k2.get_property(g, "Level")), int(k2.get_property(g, "Gold")),
                   str(k2.get_property(g, "Name")))
            check(got == props[x.account], f"{x.account}'s Level, Gold, Name arrived ({got})")
        chats0 = game2.server.counters.in_msgs.get(int(P.defines.MsgID.REQ_CHAT), 0)
        for x in movers:
            x.chat(f"moved {x.account}")
        d.wait(lambda: all(any(t == f"moved {x.account}" for _w, t in x.chat_log)
                           for x in movers), "chat after the switch")
        check(game2.server.counters.in_msgs.get(int(P.defines.MsgID.REQ_CHAT), 0) - chats0
              >= SWITCHES, "Game2 served the switched players' chat")
        out["switch_ms"] = {"n": len(t_done), "p50": pct(
            [(t_done[a] - t_sw[a]) * 1e3 for a in t_done], 50)}
        # the fault-free part ends here: no lease may have expired, and
        # every lease the master keeps is UP
        leases = {e["name"]: e["lease"] for es in c.master.servers_status()["servers"].values()
                  for e in es}
        check(not lease_expiries(c) and set(leases.values()) == {"UP"},
              f"no lease expired in the fault-free part ({lease_expiries(c)}, {leases})")
        out["max_pump_round_s_fault_free"] = d.max_round_s

        # 4. the failover, at this width
        c.apply_chaos(failover_plan(P, SEED + 7))
        orphans = [x for x in cl[:CLUSTER_CLIENTS // 2] if x not in movers]
        w1 = game1.kernel
        checks, info = failover_kill(d, game1, game2, orphans, kv, root / "wal1")
        failed = [k for k, ok in checks.items() if not ok]
        check(not failed, f"failover: {failed}")
        window.drop(w1)  # ticks stopped at the kill
        del game1, w1, k1
        check(set(lease_expiries(c)) <= {"game_at_master"},
              f"only the killed game's lease expired ({lease_expiries(c)})")
        out["failover"] = {**info, "checks": len(checks),
                           "game2_recaptures": recaptures(k2, seq2)}
        out["frames_steps_3_4"] = timer.take()

        # 5. chaos and revive: Game1 revived fresh and client-free; the
        # clients stay on Game2 unread (the plan corrupts frames on their
        # way to the proxy) until step 6 closes them
        c.chaos.heal()
        paused, d.live = d.live, []
        fresh = worlds.pop("fresh")
        g1 = c.revive_role("Game1", world=fresh, resume=False)
        del fresh
        timer.wrap(g1)
        window.add(g1.kernel)
        d.wait(lambda: lease_of(c, "game", 6) == "UP" and c.wired(), "the fresh Game1 is UP")
        c.apply_chaos(chaos_plan(P, SEED, partition=(20, 120), dial_refusals=2))
        d.tick(10)
        g1.checkpoint_now()
        boost = g1.game_world.combat._bucket_boost
        resume = worlds.pop("resume")
        resume.combat._bucket_boost = boost
        mem = {"before_kill": cluster_memory()}
        hold = {"kernel": g1.kernel}
        del g1

        def on_down():
            window.drop(hold.pop("kernel"))
            mem["after_kill"] = cluster_memory()

        def on_revived(role):
            window.add(role.kernel)
            timer.wrap(role)

        revived, checks, info = kill_revive(d, "Game1", root / "ckpt1", resume, hard=True,
                                            timeout=120.0, on_down=on_down,
                                            on_revived=on_revived)
        del resume
        mem["after_revive"] = cluster_memory()
        failed = [k for k, ok in checks.items() if not ok]
        check(not failed, f"kill and revive: {failed}")
        control = worlds.pop("control")
        offline = make_offline_role(control, backend="py", device=DEV)
        window.add(control.kernel)
        drive_control(control, revived.kernel.tick_count)
        check(banks_equal(P, revived.kernel.state, P.checkpoint._flatten_state(
            control.kernel.state)), "the revived NPC banks, tick and rng equal the control's")
        window.drop(control.kernel)
        offline.shut()
        del offline, control
        counters, chaos_lines = chaos_counters(d, revived)
        failed = [k for k, ok in counters.items() if not ok]
        check(not failed, f"chaos counters: {failed}")
        out["revive"] = {**info, "boost": boost, "checks": len(checks) + len(counters) + 1,
                         "chaos_faults": c.chaos.total(), "chaos_samples": len(chaos_lines)}
        # a second kill and revive grows the card's memory by at most a world
        revived.checkpoint_now()
        resume2 = worlds.pop("resume2")
        resume2.combat._bucket_boost = revived.game_world.combat._bucket_boost
        window.drop(revived.kernel)
        c.kill_role("Game1", hard=True)
        del revived
        mem["after_second_kill"] = cluster_memory()
        t1 = time.perf_counter()
        revived = c.revive_role("Game1", world=resume2, resume=True)
        out["revive"]["second_revive_s"] = time.perf_counter() - t1
        del resume2
        timer.wrap(revived)
        window.add(revived.kernel)
        d.wait(lambda: lease_of(c, "game", 6) == "UP" and c.wired(), "the second revive is UP")
        mem["after_second_revive"] = cluster_memory()
        grow = mem["after_second_revive"]["allocated"] - mem["after_revive"]["allocated"]
        check(grow <= world_bytes, f"a second kill and revive grew memory by {grow} bytes "
              f"(a world holds {world_bytes})")
        out["memory"] = {**mem, "world_state_bytes": world_bytes, "second_cycle_growth": grow}
        c.chaos.heal()
        # under the plan only the killed game and the partitioned login
        # may have expired
        out["lease_expirations"] = lease_expiries(c)
        check(set(out["lease_expirations"]) <= {"game_at_master", "login_at_master"},
              f"no lease expired but the killed game's and the partitioned login's "
              f"({out['lease_expirations']})")
        out["max_pump_round_s"] = d.max_round_s
        launches = {n: kk.launches for n, kk in sck.KERNELS.items()}
        expect = window.expected()
        check(launches["combat_fold"] == expect,
              f"combat_fold launched once a tick plus warm-ups on every world "
              f"({launches['combat_fold']} vs {expect})")
        out["launches"] = {**launches, "expected_combat_fold": expect}
        out["frames_step_5"] = timer.take()

        # 6. login and chat again under NF_PALLAS=2
        for x in paused:
            x.close()
        os.environ["NF_PALLAS"] = "2"
        try:
            window = LaunchWindow()
            for g in c.games:
                window.add(g.kernel)
            sck.reset_launch_counts()
            specs2 = [(f"q{i}", f"Q{i}", g.config.server_id)
                      for i, g in enumerate(c.games * 4)]
            d.login_all(specs2, timeout=300.0)
            qs = [d.clients[s[0]] for s in specs2]
            for x in qs:
                x.chat(f"fused {x.account}")
            d.wait(lambda: all(any(t == f"fused {x.account}" for _w, t in x.chat_log)
                               for x in qs), "chat under engine 2")
            fl = {n: kk.launches for n, kk in sck.KERNELS.items()}
            expect2 = window.expected()
            check(fl["fused_neighborhood"] == expect2 and fl["combat_fold"] == 0,
                  f"fused_neighborhood launched once a tick plus warm-ups ({fl} vs {expect2})")
            out["engine2"] = {"launches": fl, "expected": expect2, "clients": len(qs)}
        finally:
            os.environ.pop("NF_PALLAS")
        c.shut()
        c = None
        free()

        # 7. the card against the CPU, in lockstep
        t7 = time.perf_counter()
        on_card, on_cpu = lockstep_run(DEV), lockstep_run("cpu")
        check(on_card["digests"] == on_cpu["digests"] and on_card["ticks"] == on_cpu["ticks"],
              f"cuda and cpu digests ({on_card['digests']} vs {on_cpu['digests']})")
        check(on_card["logs"] == on_cpu["logs"], "cuda and cpu canonical client logs")
        check(on_card["mirrors"] == on_cpu["mirrors"], "cuda and cpu client mirrors")
        out["lockstep"] = {"entities": LOCKSTEP_N, "clients": LOCKSTEP_CLIENTS,
                           "digests": on_card["digests"], "ticks": on_card["ticks"],
                           "messages": sum(len(v) for lg in on_card["logs"].values()
                                           for v in lg.values()),
                           "seconds": time.perf_counter() - t7}
    finally:
        if c is not None:
            c.shut()
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    free()
    return {"combat_fold": out["launches"]["combat_fold"],
            "fused_neighborhood": out["engine2"]["launches"]["fused_neighborhood"]}


# -- (k) the gameplay middleware ----------------------------------------------------
MW_N = SERVED_N  # the served recipe's 100,000 NPCs
MW_SESSIONS = 500
MW_PLAYERS = 512  # the Player bank
MW_TEAMS = 128  # Team objects: 500 players in teams of five need 100
MW_WAIT = 34  # frames after the scripted steps: the 1 s upgrades and buffs run out
MW_CKPT_TICKS = 30
MW_PARITY_N, MW_PARITY_SESSIONS = 4096, 32
MW_ENGINE2_SESSIONS = 100  # the NF_PALLAS=2 rerun of the script
SERVED_BATCH: dict = {}  # phase (i)'s batched engine, printed beside (k)
MAIN_TICK_MS: list = []  # phase 3's median graph tick at 1M


def mw_catalogue(w) -> None:
    """Item, shop, building, skill, task and buff definitions of the
    middleware script (config, not checkpointed: every world defines them)."""
    from noahgameframe_tpu_torch.game import EShopType, ItemSubType, ItemType, TaskDef

    e = w.kernel.elements
    e.add_element("Item", "potion", {"ItemType": int(ItemType.ITEM),
                                     "ItemSubType": int(ItemSubType.HP), "AwardValue": 20})
    e.add_element("Item", "token", {"ItemType": int(ItemType.TOKEN),
                                    "ItemSubType": int(ItemSubType.CURRENCY),
                                    "AwardValue": 100})
    e.add_element("Item", "blade", {"ItemType": int(ItemType.EQUIP), "ATK_VALUE": 9})
    e.add_element("Item", "ruby", {"ItemType": int(ItemType.GEM), "ATK_VALUE": 3})
    e.add_element("Item", "hero_mage", {"ItemType": int(ItemType.CARD), "ATK_VALUE": 4,
                                        "MAXHP": 10})
    e.add_element("Skill", "slash", {"DamageValue": 1000})
    e.add_element("Building", "farm", {"Type": 3, "UpgradeTime": 1})
    for item, kind in (("potion", EShopType.GOLD), ("token", EShopType.GOLD),
                       ("ruby", EShopType.GOLD), ("hero_mage", EShopType.GOLD),
                       ("blade", EShopType.EQUIP), ("farm", EShopType.BUILDING)):
        e.add_element("Shop", f"shop_{item}", {"Type": int(kind), "Level": 1, "Gold": 5,
                                               "ItemID": item})
    w.tasks.define_task(TaskDef("t_hunt", count=1, award_gold=7))
    w.buffs.define_buff("swift", 0.5, {"MOVE_SPEED": 50, "ATK_VALUE": 2})
    w.buffs.define_buff("ward", 1.0, {"DEF_VALUE": 6, "MAXHP": 30})
    w.slg_building.collect_interval_s = 1.0
    w.skills.skill_damage = 1000


def mw_world(n: int, players: int, device: str):
    """The served recipe (``pinned_world``) with the middleware, a Team bank
    for MW_TEAMS teams and its catalogue defined."""
    w = pinned_world(n, players, device, middleware=True, teams=MW_TEAMS)
    mw_catalogue(w)
    return w


def mw_role(n: int, sessions: int, device: str, **kw):
    """``served_role`` (radius 8, batched serving, a graph tick on a card)
    over ``mw_world(n)``, its ``sessions`` seated at seeded spots, each
    avatar at Level 1 with 10,000 Gold.  Returns (role, sink, seats,
    credited): ``seats`` lists (ident, conn, guid, account) in seat order,
    ``credited`` collects the kills whose killer is a Player."""
    from noahgameframe_tpu_torch.core.store import HANDLE_ROW_BITS
    from noahgameframe_tpu_torch.game import GameEvent

    w = mw_world(n, max(sessions + 12, MW_PLAYERS), device)
    role, sink = served_role(n, sessions, device, seat_rng=np.random.default_rng(11),
                             world=w, serve_batch=True, **kw)
    k = role.kernel
    seats = [(s.ident, s.conn_id, s.guid, s.account) for s in role.sessions.values()]
    for _ident, _conn, g, _acct in seats:
        k.set_property(g, "Level", 1)
        k.set_property(g, "Gold", 10_000)
    player_ci = k.store.class_index["Player"]
    credited = []

    def on_kills(cname, mask, params):
        handles = params["killer"][mask]
        for h in handles[(handles >= 0) & ((handles >> HANDLE_ROW_BITS) == player_ci)]:
            credited.append(k.store.guid_of_handle(int(h)))

    k.events.subscribe_batch(int(GameEvent.ON_OBJECT_BE_KILLED), on_kills)
    return role, sink, seats, credited


def mw_steps(w, seats):
    """The script, one step a frame: a step is ``("wire", make)``, where
    ``make(i, guid)`` gives session i's client message ``(MsgID, msg)`` or
    None, all fed through the role's dispatch; ``("host", fn)``, a call of
    the middleware API for every session (buffs, mail and rank have no
    client message in either package); or ``("kill", None)``, every avatar
    casting ``slash`` (SkillModule.use_skill, which stamps the killer) on
    an NPC that NPC kills then count."""
    from noahgameframe_tpu_torch.net import wire
    from noahgameframe_tpu_torch.net import wire_families as fam
    from noahgameframe_tpu_torch.net.defines import MsgID

    def buy(item):
        return ("wire", lambda i, g: (MsgID.REQ_BUY_FORM_SHOP, fam.ReqAckBuyObjectFormShop(
            config_id=f"shop_{item}".encode(), x=float(i % 50), y=float(i // 50))))

    def use(item, target=None):
        return ("wire", lambda i, g: (MsgID.REQ_ITEM_OBJECT, wire.ReqAckUseItem(
            item=wire.ItemStruct(item_id=item.encode(), item_count=1), targetid=target)))

    lead = [s[2] for s in seats]
    zero = wire.Ident(svrid=0, index=0)
    mails = {}

    def join_team(i):
        if i % 5 == 0:
            return None
        tid = w.team.team_of(lead[(i // 5) * 5]).team_id
        return MsgID.REQ_JOIN_TEAM, wire.ReqAckJoinTeam(
            team_id=wire.Ident(svrid=tid.head, index=tid.data))

    return [
        buy("potion"), buy("token"), buy("blade"), buy("ruby"), buy("hero_mage"),
        use("potion"),
        ("host", lambda i, g: (w.buffs.apply_buff(g, "swift"), w.buffs.apply_buff(g, "ward"))),
        use("token"),
        ("host", lambda i, g: mails.__setitem__(i, w.mail.send(
            f"bot{i}", "system", "Supplies", items={"potion": 1}))),
        ("host", lambda i, g: w.mail.draw(f"bot{i}", mails[i], g)),
        use("ruby", wire.Ident(svrid=1, index=0)),
        ("wire", lambda i, g: (MsgID.WEAR_EQUIP, wire.ReqWearEquip(equipid=zero))),
        use("hero_mage"),
        ("wire", lambda i, g: (MsgID.REQ_SET_FIGHT_HERO,
                               wire.ReqSetFightHero(heroid=zero, fight_pos=0))),
        ("wire", lambda i, g: (MsgID.REQ_ACCEPT_TASK, wire.ReqAcceptTask(task_id=b"t_hunt"))),
        ("host", lambda i, g: w.rank.update("level", f"bot{i}", 1000 - i)),
        ("wire", lambda i, g: (MsgID.REQ_CREATE_TEAM, wire.ReqAckCreateTeam())
         if i % 5 == 0 else None),
        ("wire", lambda i, g: join_team(i)),
        ("wire", lambda i, g: (MsgID.REQ_CREATE_GUILD, wire.ReqAckCreateGuild(
            guild_name=f"G{i}".encode())) if i < 10 else None),
        ("wire", lambda i, g: None if i < 10 else (MsgID.REQ_JOIN_GUILD, wire.ReqAckJoinGuild(
            guild_name=f"G{i % 10}".encode()))),
        buy("farm"),
        ("wire", lambda i, g: (MsgID.REQ_UP_BUILD_LVL, fam.ReqUpBuildLv(row=0))),
        ("kill", None),
        ("wire", lambda i, g: (MsgID.TAKEOFF_EQUIP, wire.TakeOffEquip(equipid=zero))),
    ] + [None] * MW_WAIT + [
        ("wire", lambda i, g: (MsgID.REQ_COMPLETE_TASK,
                               wire.ReqCompeleteTask(task_id=b"t_hunt"))),
        ("wire", lambda i, g: (MsgID.REQ_BUILD_OPERATE, fam.ReqBuildOperate(
            row=0, functype=int(fam.SLGFuncType.COLLECT_GOLD)))),
    ]


def mw_run(role, seats, *, device: str, now: float = 1000.0, digests=None):
    """Drive the script through ``role`` (one step a frame, then
    ``role.execute``, ended by a device sync): per-frame ms (the step's
    handlers plus the frame), the handlers' ms, each frame's exclusive
    stage times, the Player BuffList rows in use after each frame, and
    the clock (``now``, continued from the frames before)."""
    from noahgameframe_tpu_torch.net import transport as tr
    from noahgameframe_tpu_torch.net import wire

    w, k = role.game_world, role.kernel
    steps = mw_steps(w, seats)
    npcs = [g for g in k.store._hosts["NPC"].row_guid if g is not None]
    dt = w.config.dt * 1.0001
    out = {"frame_ms": [], "handler_ms": [], "stages": [], "buff_rows": []}
    for f, step in enumerate(steps):
        t0 = time.perf_counter()
        if step is not None:
            kind, make = step
            if kind == "wire":
                evs = []
                for i, (ident, conn, g, _acct) in enumerate(seats):
                    m = make(i, g)
                    if m is not None:
                        evs.append(tr.NetEvent(tr.EV_MSG, conn, int(m[0]),
                                               wire.wrap(m[1], player_id=ident)))
                role.server.dispatch.feed(evs)
            elif kind == "host":
                for i, (_ident, _conn, g, _acct) in enumerate(seats):
                    make(i, g)
            else:
                for i, (_ident, _conn, g, _acct) in enumerate(seats):
                    w.skills.use_skill(g, "slash", npcs[(7919 * i) % len(npcs)])
        t1 = time.perf_counter()
        now += dt
        role.execute(now)
        if device == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        out["frame_ms"].append((t2 - t0) * 1e3)
        out["handler_ms"].append((t1 - t0) * 1e3)
        out["stages"].append(dict(role.stage_clock.last))
        out["buff_rows"].append(int(k.state.classes["Player"].records["BuffList"].used.sum()))
        if digests is not None:
            digests.append(k.last_counters.get("state_digest", 0) & 0xFFFFFFFF)
    out["now"] = now
    return out


def mw_outcome(role, seats, credited) -> dict:
    """What the script left in the middleware, checked: each avatar's
    bag, equip (gem socketed, taken off), hero at fight position 0, task
    (finished where an avatar's kill was credited to it), buffs (expired),
    team of five, guild of 50, drawn mail, rank, and SLG farm at level 2
    with gold collected."""
    from noahgameframe_tpu_torch.game.defines import PropertyGroup, SLGBuildingState, TaskState

    w = role.game_world
    n = len(seats)
    guids = [s[2] for s in seats]
    credited_set = set(credited)
    bad = []
    for i, g in enumerate(guids):
        finished = w.tasks.status(g, "t_hunt")
        want_task = TaskState.FINISH if g in credited_set else TaskState.IN_PROCESS
        row = {
            "potion": w.pack.item_count(g, "potion"), "token": w.pack.item_count(g, "token"),
            "gems": w.items.gems_of(g, 0), "worn": w.equip.worn(g),
            "equip_atk": w.properties.get_group_value(g, "ATK_VALUE", PropertyGroup.EQUIP),
            "hero": w.heroes.fight_hero(g, 0),
            "hero_atk": w.properties.get_group_value(g, "ATK_VALUE",
                                                     PropertyGroup.FIGHTING_HERO),
            "task": finished, "buffs": w.buffs.active_buffs(g),
            "farm": w.slg_building.building_level(g, 0),
            "farm_state": w.slg_building.building_state(g, 0),
        }
        want = {"potion": 1, "token": 0, "gems": ["ruby"], "worn": {}, "equip_atk": 0,
                "hero": 0, "hero_atk": 4, "task": want_task, "buffs": [], "farm": 2,
                "farm_state": int(SLGBuildingState.IDLE)}
        if row != want:
            bad.append((i, row))
    check(not bad, f"every avatar's middleware state is the script's ({bad[:3]})")
    teams = sorted(len(t.members) for t in w.team.teams.values())
    guilds = sorted(len(gd.members) for gd in w.guilds.guilds.values())
    check(teams == sorted([5] * (n // 5) + ([n % 5] if n % 5 else [])),
          f"teams of five ({teams})")
    check(len(guilds) == min(10, n) and sum(guilds) == n, f"10 guilds hold everyone ({guilds})")
    check(all(m.drawn for i in range(n) for m in w.mail.mailbox(f"bot{i}")),
          "every mail drawn")
    check(len(w.rank.top("level", n + 1)) == n, "everyone ranked")
    collected = [int(w.kernel.get_property(g, "Gold")) for g in guids]
    return {"credited_kills": len(credited), "finished_tasks": len(credited_set),
            "teams": len(teams), "guilds": len(guilds), "gold_total": sum(collected)}


def buff_phase_ms(w) -> dict:
    """The buff phase alone on the world's state, by CUDA events (the mean
    of 10 eager calls), with its bytes: the least a pass must move (the
    BuffList ConfigIdx, ExpireTick and used cells read, the RUNTIME_BUFF
    row and used written) and the functional copy of the stat record this
    implementation adds."""
    from types import SimpleNamespace

    k = w.kernel
    ctx = SimpleNamespace(tick=k.state.tick, store=k.store)
    ms = time_ms(lambda: w.buffs._buff_phase(k.state, ctx), reps=10, warmup=2)
    least = copy = 0
    for cname in w.buffs._rec_cols:
        recs = k.state.classes[cname].records
        c, r = recs["BuffList"].used.shape
        least += c * r * (4 + 4 + 1) + c * len(STAT_NAMES) * 4 + c * r
        copy += 2 * recs["CommPropertyValue"].i32.numel() * 4
    bound = least / PEAK_BYTES_PER_S * 1e3
    return {"ms": ms, "least_bytes": least, "bound_ms": bound, "stat_copy_bytes": copy,
            "stat_copy_ms_at_peak": copy / PEAK_BYTES_PER_S * 1e3}


def graph_tick_ms(w, ticks: int = 30) -> float:
    """Median device time of ``ticks`` single graph ticks (run_device), after
    one that captures."""
    w.kernel.run_device(1, reconcile=False)
    torch.cuda.synchronize()
    return statistics.median(tick_times(w.kernel, ticks, graph=True))


def states_equal(a, b) -> bool:
    la, lb = tree.flatten(a)[0], tree.flatten(b)[0]
    return len(la) == len(lb) and all(
        (torch.equal(x, y.to(x.device)) if isinstance(x, torch.Tensor) else x == y)
        for x, y in zip(la, lb))


def module_states(w) -> str:
    return json.dumps({m.name: m.checkpoint_state() for m in w.all_modules},
                      sort_keys=True, default=str)


def timed_kills(role) -> dict:
    """Put a timed wrapper in place of ``TaskModule._on_kills`` among the
    role's batch subscribers to ON_OBJECT_BE_KILLED; the dict it returns
    accumulates the calls and their host seconds."""
    from noahgameframe_tpu_torch.game import GameEvent

    on_kills = role.game_world.tasks._on_kills
    subs = role.kernel.events._batch_subs[int(GameEvent.ON_OBJECT_BE_KILLED)]
    acc = {"calls": 0, "s": 0.0}

    def timed(cname, mask, params):
        t0 = time.perf_counter()
        try:
            on_kills(cname, mask, params)
        finally:
            acc["calls"] += 1
            acc["s"] += time.perf_counter() - t0

    subs[subs.index(on_kills)] = timed
    return acc


def mw_engine(n: int, sessions: int, *, fold: str) -> tuple:
    """The script at ``n`` NPCs and ``sessions`` sessions on the card, after
    warm-up frames that settle the captures: its timings, the kill walk's
    host ms, fold launches against ticks served plus warm-ups, re-captures
    and their causes, and the checked outcome.  Returns (line, role)."""
    role, sink, seats, credited = mw_role(n, sessions, DEV)
    k = role.kernel
    book = k.costbook
    kills = timed_kills(role)
    now = settle(role)
    recompiles0, seq0 = book.total_recompiles, book._seq
    sck.reset_launch_counts()
    t0_tick = k.tick_count
    calls0, secs0 = kills["calls"], kills["s"]
    sink["msgs"] = sink["bytes"] = 0
    run = mw_run(role, seats, device=DEV, now=now)
    ticks = k.tick_count - t0_tick
    frames = len(run["frame_ms"])
    launches = {nm: kk.launches for nm, kk in sck.KERNELS.items()}
    warm = WARMUP_RUNS * sum(1 for r in book.compile_log
                             if r["seq"] >= seq0 and r["entry"] == "kernel.step")
    check(launches[fold] == ticks + warm,
          f"(k): {fold} launched once per tick served ({launches} vs {ticks} + {warm})")
    outcome = mw_outcome(role, seats, credited)
    check(kills["calls"] > calls0, "(k): NPC kills reached TaskModule._on_kills")
    check(max(run["buff_rows"]) == 2 * sessions and run["buff_rows"][-1] == 0,
          f"buffs applied, then expired on the card ({run['buff_rows']})")
    names = sorted({st for fr in run["stages"] for st in fr})
    per_stage = {st: [fr.get(st, 0) / 1e6 for fr in run["stages"]] for st in names}
    line = {
        "entities": n, "sessions": sessions, "frames": frames, "ticks": ticks,
        "fold": fold, "frame_ms_p50": pct(run["frame_ms"], 50),
        "frame_ms_p99": pct(run["frame_ms"], 99), "frame_ms_max": max(run["frame_ms"]),
        "handler_ms_p50": pct(run["handler_ms"], 50),
        "handler_ms_max": max(run["handler_ms"]),
        "quiet_frame_ms_p50": pct(run["frame_ms"][-MW_WAIT - 2:-2], 50),
        "waterfall_p50_ms": {st: pct(v, 50) for st, v in per_stage.items()},
        "on_kills_calls": kills["calls"] - calls0,
        "on_kills_ms_per_frame": (kills["s"] - secs0) * 1e3 / frames,
        "on_kills_ms_per_call": (kills["s"] - secs0) * 1e3 / (kills["calls"] - calls0),
        "sync_msgs": sink["msgs"], "sync_bytes": sink["bytes"],
        "launches": launches, "warmup_launches": warm,
        "recaptures": book.total_recompiles - recompiles0,
        "recapture_causes": {nm: dict(e.causes) for nm, e in sorted(book.entries.items())
                             if e.causes},
        "outcome": outcome,
    }
    return line, role


def mw_parity(device: str):
    """The script at MW_PARITY_N NPCs and MW_PARITY_SESSIONS sessions on
    ``device`` with the digest on: (send-stream sha, digests, module state,
    credited killers)."""
    role, sink, seats, credited = mw_role(MW_PARITY_N, MW_PARITY_SESSIONS, device)
    role.kernel.enable_digest()
    digests = []
    mw_run(role, seats, device=device, digests=digests)
    mw_outcome(role, seats, credited)
    out = (sink["sha"].hexdigest(), digests, module_states(role.game_world),
           [str(g) for g in credited])
    role.shut()
    return out


def phase_middleware(card: str):
    """(k): the middleware world on the card (see the module docstring)."""
    t_phase = time.perf_counter()
    line, role = mw_engine(MW_N, MW_SESSIONS, fold="combat_fold")
    w = role.game_world
    buff_100k = buff_phase_ms(w)
    # checkpoint: save, load into a fresh world of the recipe, compare
    root = tempfile.mkdtemp(prefix="nf_mw_")
    try:
        save_split = w.save(os.path.join(root, "ckpt"))
        # a fresh world of the recipe under a fresh role (which fills the
        # same default stat table: config, which no checkpoint carries)
        role2 = mw_role(MW_N, 0, DEV)[0]
        w2 = role2.game_world
        # host state the checkpoint does not carry, in either package
        w2.combat._bucket_boost = w.combat._bucket_boost
        load_split = w2.load(os.path.join(root, "ckpt"))
        check(states_equal(w.kernel.state, w2.kernel.state), "loaded banks equal the saved")
        check(module_states(w) == module_states(w2), "loaded module state equals the saved")
        for x in (w, w2):
            x.kernel.enable_digest()
        da = [w.tick().counters["state_digest"] for _ in range(MW_CKPT_TICKS)]
        db = [w2.tick().counters["state_digest"] for _ in range(MW_CKPT_TICKS)]
        check(da == db, f"the next {MW_CKPT_TICKS} digests equal after the load")
        check(states_equal(w.kernel.state, w2.kernel.state), "banks equal after 30 ticks")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    role.shut()
    role2.shut()
    del role, role2, w, w2
    free()
    # the same script under NF_PALLAS=2
    os.environ["NF_PALLAS"] = "2"
    try:
        line2, role2 = mw_engine(MW_N, MW_ENGINE2_SESSIONS, fold="fused_neighborhood")
    finally:
        os.environ.pop("NF_PALLAS")
    role2.shut()
    del role2
    free()
    # cuda against cpu at 4,096
    on_card, on_cpu = mw_parity(DEV), mw_parity("cpu")
    check(on_card == on_cpu and len(set(on_card[1])) > 1,
          "the middleware script's sends, digests, module state and killers equal on "
          "cuda and cpu at 4,096")
    free()
    # 1M: the graph tick with the stack (phase 3 timed it without), and
    # the buff phase
    t0 = time.perf_counter()
    big = mw_world(N_MAIN, 64, DEV)
    build_s = time.perf_counter() - t0
    tick_mw = graph_tick_ms(big)
    prof_mw = profile_ticks(big.kernel, 5, host_ops=False, graph=True)
    buff_1m = buff_phase_ms(big)
    del big
    free()
    emit({"phase": "middleware", "card": card, "frame_limit_ms": FRAME_LIMIT_MS,
          "batch_100k": line, "batch_100k_engine2": line2,
          "served_batch_beside": {k2: SERVED_BATCH.get(k2) for k2 in (
              "frame_ms_p50", "frame_ms_p99", "waterfall_p50_ms")},
          "buff_phase_100k": buff_100k, "buff_phase_1m": buff_1m,
          "graph_tick_1m_ms": {"middleware": tick_mw,
                               "phase3_no_middleware": MAIN_TICK_MS[0] if MAIN_TICK_MS
                               else None},
          "graph_tick_1m_profile": {k2: prof_mw[k2] for k2 in ("busy_share", "top")},
          "world_build_1m_s": build_s,
          "checkpoint": {"ticks_compared": MW_CKPT_TICKS, **save_split, **load_split},
          "cuda_cpu_equal": {"entities": MW_PARITY_N, "sessions": MW_PARITY_SESSIONS,
                             "frames": len(on_card[1]), "last_digest": on_card[1][-1]},
          "seconds": time.perf_counter() - t_phase})
    return {nm: line["launches"][nm] + line2["launches"][nm] for nm in sck.KERNELS}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t_start = t0 = time.perf_counter()
    sck.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in (sck.BUILD_LOG or "").splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln]})

    timing, max_err = phase_kernels()
    room_timing, room_err = phase_room_kernels()
    free()
    w, s0, main_launches = phase_main_path()
    phase_binning(w, s0)
    phase_train(w)
    phase_engines(w, s0)
    del w, s0
    free()
    fused_launches = phase_verlet()
    free()
    phase_cpu_parity()
    persist_launches = phase_persist(card)
    phase_bench()
    rooms_launches = phase_rooms()
    free()
    phase_bench_rooms()
    host_launches = phase_host_layer(card)
    phase_aoi_interest(card)
    free()
    served_launches = phase_served(card)
    free()
    middleware_launches = phase_middleware(card)
    free()
    cluster_launches = phase_cluster(card)

    emit({"phase": "elapsed", "seconds": time.perf_counter() - t_start})
    src = "noahgameframe_tpu_torch/csrc/stencil.cu"
    launches = {"combat_fold": main_launches["combat_fold"],
                "fused_neighborhood": fused_launches}
    # each kernel at the 1M world geometry (its main path) and, as rooms_*,
    # at the rooms geometry (R = 16,384 rooms, 10 x 10 cells, Kv = 8, Ka = 6)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": sck.KERNELS[name].replaces,
         "launches": launches[name], "max_abs_err": max(max_err[name], room_err[name]),
         "ms": timing[name]["ms"], "eager_ms": timing[name]["eager_ms"],
         "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"], "bound_by": timing[name]["bound_by"],
         "library_ms": None,
         "resumed_launches": persist_launches[name],
         "host_layer_launches": host_launches[name],
         "served_launches": served_launches[name],
         "middleware_launches": middleware_launches[name],
         "cluster_launches": cluster_launches[name],
         "rooms_launches": rooms_launches[name], "rooms_ms": room_timing[name]["ms"],
         "rooms_eager_ms": room_timing[name]["eager_ms"],
         "rooms_plain_ms": room_timing[name]["plain_ms"],
         "rooms_bound_ms": room_timing[name]["bound_ms"],
         "rooms_bound_by": room_timing[name]["bound_by"]}
        for name in ("combat_fold", "fused_neighborhood")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
