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
   origin, inputs at a 4-byte offset), with times; the buff fold
   (csrc/buff.cu, built at its first call) at the main path's shapes
   (2^20 NPC and 64 Player rows, the middleware configuration's 16 kinds)
   and occupancies 1/8, 1/2 and 1, with its time against its bound;
3. the main path, with (a): ``build_benchmark_world(1_000_000)`` on
   ``cuda`` under the default engine 1; ``run_device(90)`` as a CUDA
   graph (the default) and as the eager loop from the same state land on
   the same ``state_digest``; tick times (median and mean), the drain
   after the host's last launch, launches per tick, busy share, and each
   kernel's launches in the graph run (counted per replay);
(b) ``NF_BINNING=count`` against ``sort`` under engines 0, 1 and 2, and
   engine 1's sort under ``NF_RADIX=2`` (the radix argsort in the tick's
   graph): one digest after 30 graph ticks from the same state, and each
   setting's tick time;
(d) ``train(K=8)`` against ``tick()``: equal counters and digests over 16
   observed ticks (after 20 that settle the overflow auto-resize), and
   the train's peak memory;
4. 30 observed ticks at 1M under engines 0, 1 and 2 from the same state
   give identical ``state_digest`` streams (the engine-2 run is kernel
   2's path);
(c) ``NF_VERLET_SKIN=2.0`` at 1M under engines 1 and 2: graph (sort and
   count binning) and eager runs of 30 ticks give equal digests and equal
   rebuild/reuse counts;
5. ``build_benchmark_world(4096)`` gives the same digest stream for 30
   ticks on ``cuda`` and on ``cpu``;
(e) one run of the bench entry (``python -m noahgameframe_tpu_torch.bench``)
   at 1M, its JSON line printed on a line of its own;
(f) many-worlds rooms at R = 4,096 (parallel/rooms.py ``RoomBatch``, the
   rooms recipe of the JAX package's bench: 64 NPC rows, 32 seeded, skin
   2.0): all rooms admitted into one batch; 30 ticks as the CUDA graph of
   the vmapped step under engines 1, 0 and 2 from the same state land on
   equal ``[R]`` digest lanes, which equal single-room control worlds
   ticked with ``run_device`` (first, middle and last room); the profiler
   sees exactly one fold-kernel launch per replayed rooms tick (engines 1
   and 2); ``train(K=8)`` equals ``tick()`` over 16 ticks; a churn
   (destroy, create into the recycled slot, re-home) drops no row and
   re-captures nothing; then the bench's rooms ladder at 256 and 4,096
   rooms (``--rooms --rooms-count 256``), its
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
   and train engines), and the graph and the eager tick (8 frames), send
   equal streams with equal digests; a journal of 45
   frames recorded on the card replays digest-clean on the card and on
   the CPU, and a perturbed replay is bisected to the injected tick; then
   the bench's ``--served`` line at 100k and 500 sessions (30 frames).  The overlap
   and train engines serve 6 and 8 frames, the others 12.  The kernel
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
   plus warm-ups; the buff fold once per class a tick); the benchmark's
   middleware world (``build_benchmark_world(1M, middleware=True,
   buffs=...)``) at BuffList occupancies 1/8, 1/2 and 1 and with short
   expiries: its graph tick and entity rate, its buff phase and its buff
   fold against the fold's bound, one fold launch a class a replayed
   tick.  Held: a checkpoint of the 100k middleware world loads
   into a fresh one with equal banks, module state and next 30 digests;
   the script under ``NF_PALLAS=2`` (100 sessions) launches
   ``fused_neighborhood``; at
   4,096 NPCs and 32 sessions the card and the CPU send equal streams
   with equal digests, module state and credited killers.  The kernel
   table gains each kernel's launches on this path
   (``middleware_launches``);
(l) the multi-device layer (run after (k); every mesh a virtual mesh of
   ``cuda:0``, ``make_mesh(n, device="cuda:0", virtual=True)``): the 1M
   world of phase 3, settled 20 frames, on 4 shards: 16 observed ticks
   under ``NF_PALLAS=1`` and under ``NF_PALLAS=2``, ``run_device(16)``
   and ``train(K=8)`` on the mesh all give the single-device graph
   tick's digest stream; the sharded tick's ms, its collective bytes and
   each fold's launches a shard, and one tick with every shard's launch
   held against its plain version.  The elastic mesh (the 1M recipe's
   extent and cells, 524,288 NPCs in a 1,572,864-row bank, combat and
   movement off, a spatial placement): grow 2 -> 4 and drain shard 3
   under ticks, each op's seconds, the canonical digest pinned to a
   one-shard control's after each; migrated, overflow and dropped (0).
   The spatial preset at 4,194,304 entities (the JAX bench's geometry)
   on 4 shards against 1, at skin 0 and 2.0: HP by gid equal every tick,
   ticks/s, rows migrated.  16,384 rooms of the rooms recipe on 4 shards
   against the unsharded batch: equal digest lanes every tick.  Two
   processes of this script (``--mesh-worker``) in a gloo group, 2 shards
   of ``cuda:0`` each: one sharded tick at 65,536 rows, both checksums
   equal the local tick's.  A 4,096-row world on 4 shards gives equal
   digests on cpu and cuda.  The kernel table gains each kernel's
   launches on the sharded 1M path (``sharded_launches``);
(m) the game-day drill (run last, ``phase_drill``): the flagship campaign
   of scripts/torch_gameday_smoke.py (a hard store outage, Game1
   hard-killed during it and during a 40-session surge, heal, revive from
   checkpoint and WAL) at the JAX script's size on ``cuda``, then at a real
   size over phase (j)'s 100,000-NPC recipe and lease cadence (zero
   dropped sessions, every invariant clean every pump, the revived banks
   equal a control's, Game2's journal replays digest-clean; the re-home
   time, longest pump round, checkpoint save and load seconds; one tick's
   fold held against its plain version), and the elastic-mesh campaign of
   scripts/torch_reshard_smoke.py (2 -> 4 -> 3 virtual shards of
   ``cuda:0`` against a 1-shard control).  The kernel table gains each
   kernel's launches in the real-size campaign (``drill_launches``);
(n) the tools and the examples (run last, ``phase_examples``): the port's
   emitters (``noahgameframe_tpu_torch/tools``) reproduce the committed
   clients/unity/ files byte for byte, the C++ header compiles with
   ``-Wall -Werror`` and round-trips every golden vector, and the codegen
   pipeline's XML builds a world on the card that ticks; every tutorial
   (examples/torch_*.py) on ``cuda`` prints its ``cpu`` run's value lines
   (tutorials 5 and 8 on 4-shard virtual meshes of ``cuda:0``, 5 under both
   kernels); the plugin template loaded by manifest into BASELINE config
   4's world (1M NPCs, 4,096 players): every live player loses exactly 30
   MP in 30 graph ticks (floored at 0, dead rows kept), the graph digest
   stream equals eager ticks', one ``combat_fold`` a replayed tick, its
   graph tick beside phase 3's; five scripts/torch_run_role.py processes
   (the game's world on ``cuda``, a journal, a checkpoint dir): the
   master's ``/json`` lists the five roles, a client logs in, enters and
   chats, and the journal replays digest-clean on ``cuda`` and on ``cpu``.
   The kernel table gains each kernel's launches in the in-process runs
   (``examples_launches``);
(o) the script drivers (run last, ``phase_scripts``), each on ``cuda`` at
   the JAX script's size: scripts/torch_{chaos,persist,replay,pipeline}_
   smoke.py and the failover smoke's ``run`` and ``surge``, each script's
   checks (all true) and seconds; scripts/torch_costbook_smoke.py with the
   served ``kernel.step``'s counted flops, bytes and temp bytes;
   scripts/torch_roofline_report.py (20,000 entities, 32 sessions, 120
   ticks, ``NF_STAGE_TIMING=1``) with each stage's achieved fractions of
   the card's peaks; scripts/torch_telemetry_smoke.py; and
   scripts/torch_{export,capture}_trace.py under engines 1 and 2 (1,024
   entities and 30 ticks; 1M and 3 graph ticks), each profile naming its
   engine's kernel.  The kernel table gains each kernel's launches there
   (``scripts_launches``);
(p) nf-lint of the port (run last, ``phase_lint``): ``run_lint`` over
   ``noahgameframe_tpu_torch/`` against ``nf_lint_torch_baseline.json``
   on the card's host (0 open findings; counts, rules and seconds
   printed); the ``CUSTOM_OP_PARITY_TESTS`` keys of ``ops/stencil_cuda.py``
   and ``ops/buff_cuda.py`` are exactly the ``nf::`` ops behind the hand
   kernels, which phase 2 held at ``max_abs_err`` 0; and the dynamic twin of ``capture-safety``:
   a ``.item()`` injected in memory into ``Kernel._pack_summary`` is
   flagged by the lint (``overrides=``) from the graph-captured tick's
   root, and in a child process (``--capture-probe``) a 4,096-row config-4
   world's captured tick raises on it instead of running eagerly.

Then the kernel table line and, last, the result line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this file, it fails before printing any result.
"""

from __future__ import annotations

import contextlib
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
from noahgameframe_tpu_torch.lint import run_lint
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
# phase (f)'s batch: 4,096 rooms, a depth cut (16,384 before phase (o),
# 8,192 before phase (p)); the kernels' room axis (phase 2) and (l)'s
# sharded rooms keep 16,384
ROOMS_F = 4_096
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
    rng_timing, rng_err = threefry_vs_plain()
    buff_timing, buff_err = buff_fold_vs_plain()
    return {**timing, **rng_timing, **buff_timing}, {**max_err, **rng_err, **buff_err}


# -- phase 2: the tick's threefry stream -----------------------------------------


def wander_population(n, spec, extent, seed, dev=None):
    """A movement population on banks of the NPC class's widths: random
    walkers, forced arrivals (TargetPos = Position), walkers beside the
    walls seeking beyond them, dead rows beyond the walls, gates and HP at
    0 or below.  (alive, i32, vec) on ``dev``."""
    rng = np.random.default_rng(seed)
    q = n // 8
    vec = rng.uniform(0.0, extent, (n, spec.n_vec, 3)).astype(np.float32)
    p, g = spec.slot("Position").col, spec.slot("TargetPos").col
    vec[:q, g, :2] = vec[:q, p, :2]
    vec[q:2 * q, p, :2] = rng.uniform(0.0, 0.05, (q, 2))
    vec[q:2 * q, g, :2] = rng.uniform(-50.0, -1.0, (q, 2))
    vec[2 * q:3 * q, p, :2] = extent - rng.uniform(0.0, 0.05, (q, 2))
    vec[2 * q:3 * q, g, :2] = extent + rng.uniform(1.0, 50.0, (q, 2))
    vec[3 * q:4 * q, p, :2] = rng.choice([-3.0, extent + 3.0], (q, 2))
    i32 = rng.integers(-1000, 1000, (n, spec.n_i32)).astype(np.int32)
    i32[:, spec.slot("MOVE_SPEED").col] = rng.integers(0, 300_000, n)
    i32[:, spec.slot("MOVE_GATE").col] = np.where(rng.random(n) < 0.15, 1, 0)
    i32[:, spec.slot("HP").col] = np.where(rng.random(n) < 0.15, 0, 100)
    alive = rng.random(n) < 0.9
    alive[3 * q:4 * q] = False
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev or DEV)  # noqa: E731
    return t(alive), t(i32), t(vec)


def threefry_vs_plain():
    """nf::wander on the 1M world's 2^20 NPC rows (its bank widths, columns,
    extent and dt) at shard offsets 0, 1,555,554 and 2^32 - 2,000 (across
    the counter's high word), and nf::fold_in over keys and data words 0,
    2^31 and 2^32 - 1 among others, each against its plain version
    (wander's on the card and on the CPU) bit for bit.  Times: mean of 20
    launches in a graph (CUDA events); wander's bound: each row's alive
    byte, three i32 columns and its vec row read, the vec row written."""
    from noahgameframe_tpu_torch.game.movement import SPEED_UNIT
    from noahgameframe_tpu_torch.core.prng import prng_key
    from noahgameframe_tpu_torch.core.rounding import recip32

    small = gw.build_benchmark_world(1024, seed=SEED, device="cpu")
    spec = small.kernel.store.spec("NPC")
    cap = 1 << int(np.ceil(np.log2(N_MAIN)))
    extent = float(np.sqrt(N_MAIN / 0.4))  # the 1M world's
    args = dict(pos_col=spec.slot("Position").col, tgt_col=spec.slot("TargetPos").col,
                speed_col=spec.slot("MOVE_SPEED").col, gate_col=spec.slot("MOVE_GATE").col,
                hp_col=spec.slot("HP").col, speed_scale=recip32(SPEED_UNIT),
                dt=float(np.float32(small.kernel.schedule.dt)), extent=extent)
    alive, i32, vec = wander_population(cap, spec, float(np.float32(extent)), 21)
    key = sck.fold_in(prng_key(SEED + 21, DEV), 5)
    cases, err = {}, 0
    for offset in (0, 2 * 777_777, 2**32 - 2 * 1000):
        got = sck.wander(alive, i32, vec, key, **args, offset=offset)
        card = sck.wander_plain(alive, i32, vec, key, **args, offset=offset)
        bad = int((got.view(torch.int32) != card.view(torch.int32)).sum())
        if offset == 0:
            cpu = sck.wander_plain(alive.cpu(), i32.cpu(), vec.cpu(), key.cpu(), **args,
                                   offset=offset)
            bad += int((got.cpu().view(torch.int32) != cpu.view(torch.int32)).sum())
        drew = (got[:, args["tgt_col"], :2] != vec[:, args["tgt_col"], :2]).any(-1)
        pos = got[:, args["pos_col"], :2]
        cases[offset] = {"words_off": bad, "drew": int(drew.sum()),
                         "at_zero": int((pos == 0.0).sum()),
                         "at_extent": int((pos == float(np.float32(extent))).sum())}
        check(bad == 0, f"nf::wander equals its plain version at offset {offset}")
        check(cases[offset]["drew"] > 1000 and cases[offset]["at_zero"] > 100
              and cases[offset]["at_extent"] > 100, "the wander cases draw and clamp")
        err = max(err, bad)
    top, half = 2**32 - 1, 2**31
    keys = [(0, 0), (0, half), (top, top), (12345, 67890)]
    words = [0, 1, half, top, 977]
    fold_bad = 0
    for kw in keys:
        kc = torch.tensor(kw, dtype=torch.int64)
        for d in words:
            want = sck.fold_in_plain(kc, d)
            as32 = torch.tensor(int(np.uint32(d).view(np.int32)), dtype=torch.int32, device=DEV)
            for data in (d, as32):
                fold_bad += int(not torch.equal(sck.fold_in(kc.to(DEV), data).cpu(), want))
    check(fold_bad == 0, "nf::fold_in equals its plain version")
    tick = torch.tensor(977, dtype=torch.int32, device=DEV)
    row_bytes = 1 + 3 * 4 + 2 * vec.shape[1] * 3 * 4
    b = bound_ms(cap * row_bytes, 0)
    timing = {
        "wander": dict(
            ms=time_ms(lambda: sck.wander(alive, i32, vec, key, **args), graph=True),
            eager_ms=time_ms(lambda: sck.wander(alive, i32, vec, key, **args)),
            plain_ms=time_ms(lambda: sck.wander_plain(alive, i32, vec, key, **args), reps=5),
            bound_ms=b[0], bound_by=b[1], bytes=cap * row_bytes, rows=cap),
        "fold_in": dict(
            ms=time_ms(lambda: sck.fold_in(key, tick), graph=True),
            eager_ms=time_ms(lambda: sck.fold_in(key, tick)),
            plain_ms=time_ms(lambda: sck.fold_in_plain(key, tick), reps=5),
            bound_ms=None, bound_by="launch"),
    }
    emit({"phase": "threefry_vs_plain", "tolerance": 0, "rows": cap,
          "vec_columns": int(vec.shape[1]), "i32_columns": int(i32.shape[1]),
          "wander_cases": cases, "fold_in_cases": len(keys) * len(words) * 2,
          "timing": timing})
    return timing, {"wander": err, "fold_in": fold_bad}


# -- phase 2: the buff fold ----------------------------------------------------

#: the benchmark's middleware configuration (its buff recipe)
MIDDLEWARE_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "nfbench",
                                 "configs", "world_1m_middleware.json")


def middleware_recipe(**over) -> dict:
    """The buff recipe of ``world_1m_middleware``, keys in ``over`` replaced."""
    with open(MIDDLEWARE_CONFIG) as f:
        return {**json.load(f)["buffs"], **over}


def buff_population(c, recipe, tick, seed):
    """A class's ``BuffList`` at ``c`` rows drawn as the recipe draws them
    (each of 8 slots used with its probability, a kind, an expiry in its
    range), with kinds below 0 and beyond the table (clamped) and expiries
    at the tick in the first 64 rows; (buf [C, 8, 2], used, table [K, 29],
    tick) on the card, columns ConfigIdx then ExpireTick."""
    rng = np.random.default_rng(seed)
    kinds = recipe["kinds"]
    lo, hi = recipe["expire_ticks"]
    buf = np.stack([rng.integers(0, len(kinds), (c, 8)),
                    rng.integers(lo, hi + 1, (c, 8))], axis=-1).astype(np.int32)
    used = rng.random((c, 8)) < recipe["slots_used"]
    e = min(c, 64)
    buf[:e, :, 0] = rng.integers(-3, len(kinds) + 3, (e, 8))
    buf[:e, :4, 1] = tick
    used[:e] = True
    table = np.asarray([[k.get(n, 0) for n in STAT_NAMES] for k in kinds], np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    return t(buf), t(used), t(table), torch.tensor(tick, dtype=torch.int32, device=DEV)


def buff_fold_vs_plain():
    """nf::buff_fold at the main path's shapes (2^20 NPC rows and 64 Player
    rows, 8 BuffList slots, the configuration's 16 kinds of 29 stats) and
    at occupancies 1/8, 1/2 and 1, against its plain version on the card
    and on the CPU bit for bit.  Times at 2^20 rows and occupancy 1/2:
    mean of 20 launches in a graph (CUDA events); its bound: each row's
    ConfigIdx, ExpireTick and used flags read, 29 contributions and the
    used flags written."""
    from noahgameframe_tpu_torch.ops import buff_cuda

    cap = 1 << int(np.ceil(np.log2(N_MAIN)))
    tick = 9000
    cases, err = {}, 0
    for rows, occupancy in ((cap, 0.125), (cap, 0.5), (cap, 1.0), (64, 0.5)):
        buf, used, table, t = buff_population(rows, middleware_recipe(slots_used=occupancy),
                                              tick, 30 + rows % 7)
        before = sck.KERNELS["buff_fold"].launches
        got = buff_cuda.buff_fold(buf, used, table, t, 0, 1)
        check(sck.KERNELS["buff_fold"].launches == before + 1, "nf::buff_fold is one launch")
        card = buff_cuda.buff_fold_plain(buf, used, table, t, 0, 1)
        cpu = buff_cuda.buff_fold_plain(buf.cpu(), used.cpu(), table.cpu(), t.cpu(), 0, 1)
        bad = sum(int((a != b).sum()) + int((a.cpu() != c).sum())
                  for a, b, c in zip(got, card, cpu))
        name = f"{rows}x{occupancy}"
        cases[name] = {"cells_off": bad, "active": int(got[1].sum()),
                       "expired": int((used & ~got[1]).sum()), "used": int(used.sum())}
        check(bad == 0, f"nf::buff_fold equals its plain version at {name}")
        check(cases[name]["expired"] > 0 and cases[name]["active"] > 0,
              f"the buff fold case {name} has active and expiring rows")
        err = max(err, bad)
    buf, used, table, t = buff_population(cap, middleware_recipe(), tick, 30)
    c, r, nc = buf.shape
    nbytes = c * (r * nc * 4 + r + table.shape[1] * 4 + r)
    b = bound_ms(nbytes, 0)
    timing = {"buff_fold": dict(
        ms=time_ms(lambda: buff_cuda.buff_fold(buf, used, table, t, 0, 1), graph=True),
        eager_ms=time_ms(lambda: buff_cuda.buff_fold(buf, used, table, t, 0, 1)),
        plain_ms=time_ms(lambda: buff_cuda.buff_fold_plain(buf, used, table, t, 0, 1), reps=5),
        bound_ms=b[0], bound_by=b[1], bytes=nbytes, rows=cap)}
    timing["buff_fold"]["roofline_pct"] = 100.0 * b[0] / timing["buff_fold"]["ms"]
    emit({"phase": "buff_fold_vs_plain", "tolerance": 0, "kinds": int(table.shape[0]),
          "stats": int(table.shape[1]), "tick": tick, "cases": cases, "timing": timing})
    return timing, {"buff_fold": err}


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
    check(all(after[k] == before[k] + 1 for k in ("combat_fold", "fused_neighborhood")),
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
    check(launches["wander"] == 90 and launches["fold_in"] == 180,
          "the wander kernel ran once per tick, fold_in twice (tick key, ctx.rng())")
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
    """(b): NF_BINNING=count against sort at 1M, under engines 0, 1 and 2,
    and engine 1's sort under NF_RADIX=2: 30 graph ticks from the same
    state land on one digest; each knob setting's tick time (mean, and
    median of 10 single ticks)."""
    k = w.kernel
    out = {}
    # engine 1 also sorts under NF_RADIX=2: the sort engine's radix argsort
    # (4-way digits), captured in the tick's graph in place of the argsort
    settings = [(1, "sort", ""), (1, "sort", "2"), (1, "count", ""),
                (0, "sort", ""), (0, "count", ""), (2, "sort", ""), (2, "count", "")]
    for engine, mode, radix in settings:
        w.combat.use_pallas = engine
        os.environ["NF_BINNING"] = mode
        os.environ["NF_RADIX"] = radix
        k.run_device(1, reconcile=False)  # (re)captures under these knobs
        restore_inplace(k, s0)
        r = timed_run(k, 30, graph=True)
        r["median_tick_ms"] = statistics.median(tick_times(k, 10, graph=True))
        out[f"engine{engine}_{mode}" + (f"_radix{radix}" if radix else "")] = r
    os.environ.pop("NF_BINNING")
    os.environ.pop("NF_RADIX")
    w.combat.use_pallas = None
    check(len({r["digest"] for r in out.values()}) == 1,
          "every engine under count and sort binning, and NF_RADIX=2, lands on one "
          "digest after 30 ticks")
    causes = k.costbook.entry("kernel.run").causes
    check(causes.get("static:binning", 0) >= 1, "the binning change re-captured the tick")
    check(causes.get("static:radix", 0) >= 1, "NF_RADIX re-captured the tick")
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


CPU_PARITY_TICKS = 30  # 60 before the cuts for (p)


def phase_cpu_parity():
    """Phase 5: CPU_PARITY_TICKS observed ticks at 4096 on the card and on
    the CPU give equal digest streams and counter banks, without a skin
    and with NF_VERLET_SKIN=2.0 (the Verlet refresh the card runs)."""
    last = {}
    n = CPU_PARITY_TICKS
    for skin in ("", "2.0"):
        os.environ["NF_VERLET_SKIN"] = skin
        gpu = digest_stream(4096, n, None, "cuda")
        cpu = digest_stream(4096, n, None, "cpu")
        check(gpu[0] == cpu[0], f"cuda and cpu digest streams equal at 4096 (skin {skin!r})")
        check(gpu[1] == cpu[1], f"cuda and cpu counter banks equal at 4096 (skin {skin!r})")
        check(gpu[2]["combat_fold"] == n, "the cuda run went through kernel 1")
        last[skin or "0"] = gpu[0][-1]
    os.environ.pop("NF_VERLET_SKIN")
    emit({"phase": "cuda_cpu_parity", "entities": 4096, "ticks": n,
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
    """(f): R = ROOMS_F rooms on the card.  Returns each kernel's launches on
    the rooms path (engine 1 and engine 2 runs of 30 replayed ticks)."""
    w = rooms_recipe()
    k = w.kernel
    order = k.store.class_order
    batch = rooms.RoomBatch(k, ROOMS_F)
    packer = rooms.RoomBinPacker(batch.capacity)

    def room_of(i):
        return k.state.replace(rng=prng_key(SEED + i, DEV))

    t0 = time.perf_counter()
    for i in range(ROOMS_F):
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
        r = {"tick_ms": secs / 30 * 1e3, "room_ticks_per_s": ROOMS_F * 30 / secs,
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
    check(len(np.unique(d1)) == ROOMS_F, "the rooms differ")
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
    for i in (0, ROOMS_F // 2, ROOMS_F - 1):
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
    new_slot = batch.admit(packer.alloc(), room_of(ROOMS_F + 1))
    check(new_slot == 1, "create recycles the destroyed room's slot")
    packer.free(2)
    src = ROOMS_F - 2
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
    emit({"phase": "rooms", "rooms": ROOMS_F, "npc_rows_per_room": 64, "seeded": 32,
          "state_bytes": state_bytes, "admit_s": admit_s,
          "admit_ms_per_room": admit_s / ROOMS_F * 1e3, "digests_equal": True,
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
    """(f): the bench's rooms ladder, as a user runs it (a subprocess), at
    256 rooms: phase (f) itself ticks a ROOMS_F-room batch (the 4,096 rung
    is a depth cut that makes room for phase (o))."""
    cmd = [sys.executable, "-m", "noahgameframe_tpu_torch.bench", "--rooms",
           "--rooms-count", "256"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"the rooms bench exits 0 ({proc.stderr[-2000:]})")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    d = line["detail"]
    check(line["metric"] == "rooms_room_ticks_per_sec" and line["value"] > 0,
          "the rooms bench measured its ticks")
    check(d["all_gates"] and all(p["graph"] for p in d["points"]),
          "the rooms bench's gates hold and its run loop is a graph")
    check([p["rooms"] for p in d["points"]] == [256],
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
SERVED_FRAMES = 12
# the engines after batched serve fewer frames (the cuts that make room
# for phases (l) and (m) in the time limit); train8 keeps whole trains
SERVED_FRAMES_OF = {"overlap": 6, "train8": 8}
SERVED_WARMUP = 3
SERVED_BENCH_FRAMES = 30  # the bench line's frames (its default, 90, before the cuts for (o))
SERVED_RADIUS = 8.0
FRAME_LIMIT_MS = 1000.0 / 30.0
# 30 frames before the cuts for (o), 15 before those for (p)
PARITY_N, PARITY_SESSIONS, PARITY_FRAMES = 4096, 32, 8
JOURNAL_FRAMES = 45
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
    """JOURNAL_FRAMES frames of a journaled served role at PARITY_N (a checkpoint at its
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
                 middleware: bool = False, teams: int | None = None, seed: int = SEED):
    """``build_benchmark_world(n)``'s recipe with a Player bank for
    ``players`` and the guid allocator pinned (at ``guid_base``) before the
    NPCs are seeded, so two builds (two devices, two engines) mint the same
    guids and send the same bytes.  ``middleware`` adds the gameplay stack,
    ``teams`` sizes its Team bank."""
    extent = max(64.0, float(np.sqrt(n / 0.4)))
    w = gw.GameWorld(gw.WorldConfig(
        npc_capacity=1 << int(np.ceil(np.log2(max(n, 64)))), extent=extent, seed=seed,
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
        engines[name] = served_engine(name, SERVED_N, SERVED_FRAMES_OF.get(name, SERVED_FRAMES),
                                      **kw)
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
           str(SERVED_RADIUS), "--serve-batch", "--ticks", str(SERVED_BENCH_FRAMES),
           "--device", DEV]
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


RESELECT_S = 0.5  # the beat before a refused server select is sent again
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
        seconds.  A server select that the proxy refused (the game is not
        NORMAL in its pool yet, as between a revived game's registration
        and the world's next game list) is sent again after a beat, as a
        client does; a select that succeeded is never sent twice."""
        c = self.c
        ack_select = int(self.P.defines.MsgID.ACK_SELECT_SERVER)
        select = LOGIN_STEPS.index("server select")
        refused = {}  # account -> (select acks seen when it was sent, when)

        def acks(cli):
            return sum(1 for mid, _b in cli.log if mid == ack_select)

        def reselect(cli, g):
            refused[cli.account] = (acks(cli), time.perf_counter())
            cli.select_server(g)

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
                (lambda cli=cli, g=game_id: reselect(cli, g),
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
                elif done is None and i == select:
                    seen, t_sent = refused[cli.account]
                    if acks(cli) > seen and time.perf_counter() - t_sent >= RESELECT_S:
                        steps[i][0]()
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



def failover_script():
    """scripts/torch_failover_smoke.py as a module: the failover scenario's
    one copy (its fault plan and its kill and re-home)."""
    return sys.modules.get("torch_failover_smoke") or port_script("torch_failover_smoke")


def failover_plan(P, seed: int):
    """scripts/torch_failover_smoke.py's fault plan (``P``, the port's
    modules, is the package it is built from): dups and delays on the
    dying game's links, dups on the survivor's, and a wedged store
    flusher under Game1, so its last saves live only in the WAL."""
    return failover_script().fault_plan(seed)


def failover_kill(d, game1, game2, clients, kv, wal_dir, after_chats: int = AFTER_CHATS):
    """scripts/torch_failover_smoke.py's kill and re-home
    (``kill_rehome``), for ``clients`` entered on ``game1`` of the
    driver's cluster (per-game WAL and checkpoint dirs over the store
    ``kv``, under :func:`failover_plan`), pumped by the driver: distinct
    saves staged to the WAL, a checkpoint, a hard kill, numbered chats
    into the outage, and the world's re-home of every session onto
    ``game2``.  Returns ``(checks, info)``: each check by the script's
    name, and the blip (kill to last re-home), the parked frames, the
    bases and the ghost re-homes."""
    checks, info = failover_script().kill_rehome(
        d.c, game1, game2, clients, kv, wal_dir,
        lambda cond, t: d.pump_until(cond, timeout=t), d._stir, after_chats=after_chats)
    check(checks["sessions bound on game 6"], "failover: sessions bound")
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
    # the phase's counters summed as the tick's context sums them
    ctx = SimpleNamespace(tick=k.state.tick, store=k.store,
                          count=lambda name, v: torch.sum(v, dtype=torch.int32))
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
    check(launches["buff_fold"] == 2 * (ticks + warm),
          f"(k): buff_fold launched once per class (Player, NPC) per tick served ({launches})")
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


#: (label, BuffList slot occupancy, expiry ticks) of the 1M buff sweep; the
#: configuration's recipe is the second
BUFF_SWEEP = (("occupancy_0.125", 0.125, None), ("occupancy_0.5", 0.5, None),
              ("occupancy_1.0", 1.0, None), ("short_expiry", 0.5, [1, 300]))


def buff_sweep() -> dict:
    """The benchmark's middleware world (``build_benchmark_world(1M,
    middleware=True, buffs=...)``, the configuration's recipe) at each
    BUFF_SWEEP occupancy and expiry: the median graph tick and the entity
    rate it gives, the buff phase by CUDA events, ``buff_fold_kernel`` on
    the NPC class's state (mean of 20 graph launches) against its bound,
    and the kernel's launches a replayed tick (one a class)."""
    from noahgameframe_tpu_torch.ops import buff_cuda

    out = {}
    for label, occupancy, expire in BUFF_SWEEP:
        over = {"slots_used": occupancy, **({"expire_ticks": expire} if expire else {})}
        t0 = time.perf_counter()
        w = gw.build_benchmark_world(N_MAIN, seed=SEED, device=DEV, middleware=True,
                                     buffs=middleware_recipe(**over))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        k = w.kernel
        tick_ms = graph_tick_ms(w)
        per_replay = k.costbook.entries["kernel.run"].last["kernel_launches_per_replay"]
        check(per_replay.get("buff_fold") == 2,
              f"(k): buff_fold launched once per class per replayed tick ({per_replay})")
        rec = k.state.classes["NPC"].records["BuffList"]
        _cols, ci, ei = w.buffs._rec_cols["NPC"]
        table, tick = w.buffs._table, k.state.tick
        fold_ms = time_ms(lambda: buff_cuda.buff_fold(rec.i32, rec.used, table, tick, ci, ei),
                          graph=True)
        c, r, nc = rec.i32.shape
        bound = (c * (r * nc * 4 + 2 * r + table.shape[1] * 4)) / PEAK_BYTES_PER_S * 1e3
        out[label] = {"slots_used": occupancy, "expire_ticks": expire or
                      middleware_recipe()["expire_ticks"], "build_s": build_s,
                      "tick": int(tick), "npc_buffs_used": int(rec.used.sum()),
                      "graph_tick_ms": tick_ms, "entity_ticks_per_s": N_MAIN / tick_ms * 1e3,
                      "buff_phase": buff_phase_ms(w), "fold_ms": fold_ms,
                      "fold_bound_ms": bound, "fold_roofline_pct": 100.0 * bound / fold_ms}
        del w, k, rec, table, tick
        free()
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
    sweep = buff_sweep()
    emit({"phase": "middleware", "card": card, "frame_limit_ms": FRAME_LIMIT_MS,
          "batch_100k": line, "batch_100k_engine2": line2,
          "served_batch_beside": {k2: SERVED_BATCH.get(k2) for k2 in (
              "frame_ms_p50", "frame_ms_p99", "waterfall_p50_ms")},
          "buff_phase_100k": buff_100k, "buff_phase_1m": buff_1m, "buff_sweep_1m": sweep,
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


# -- (l) the multi-device layer ----------------------------------------------------------
MESH_SHARDS = 4
MESH_TICKS = 16  # two whole trains of K = 8 (30 before the cuts for phase (o))
MESH_TRAIN_K = 8
# a bank of 3 x 2^19 rows divides the 2-, 3- and 4-shard meshes of the
# grow and the drain; a third full, so the drained shard's rows fit
ELASTIC_CAP = 3 << 19
ELASTIC_N = 1 << 19
ELASTIC_BUDGET = 65_536
SPATIAL_N = 4_194_304  # BASELINE config 5
SPATIAL_TICKS = 4
MESH_ROOM_TICKS = 10
DIST_N = 65_536
MESH_PARITY_N, MESH_PARITY_TICKS = 4096, 12


MESH_DEVICE = "cuda:0"  # the one card every virtual mesh of (l) lives on


def virtual_mesh(n: int, device: str = None, axis: str = "shard"):
    from noahgameframe_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n, axis=axis, device=device or MESH_DEVICE, virtual=True)


def detach_mesh(k, snap) -> None:
    """Take a kernel off its mesh and back to the snapshot's state."""
    k.sharded = None
    k.state = fresh(snap)


def sharded_kernel(k, n: int = MESH_SHARDS):
    from noahgameframe_tpu_torch.parallel.shard import ShardedKernel

    sk = ShardedKernel(k, mesh=virtual_mesh(n))
    sk.place()
    return sk


def held_against_plain(step) -> dict:
    """One ``step()`` (a sharded tick: each shard's fold) with every fold
    launch held against its plain version on the same tables (tolerance
    0): {kernel: (calls, max err)}."""
    from noahgameframe_tpu_torch.game import combat as gcm

    errs = {"combat_fold": [], "fused_neighborhood": []}
    real = {"combat_fold": gcm.combat_fold, "fused_neighborhood": gcm.fused_neighborhood}

    def fold(vic, att, radius):
        out = real["combat_fold"](vic, att, radius)
        ref = sck.combat_fold_plain(vic, att, radius)
        errs["combat_fold"].append(max(int((a.long() - b.long()).abs().max())
                                       for a, b in zip(out, ref)))
        return out

    def fused(bank, vs, ats, radius):
        out = real["fused_neighborhood"](bank, vs, ats, radius)
        ref = sck.fused_neighborhood_plain(bank, vs, ats, radius)
        errs["fused_neighborhood"].append(max(int((a.long() - b.long()).abs().max())
                                              for a, b in zip(out, ref)))
        return out

    gcm.combat_fold, gcm.fused_neighborhood = fold, fused
    try:
        step()
    finally:
        gcm.combat_fold, gcm.fused_neighborhood = real["combat_fold"], real["fused_neighborhood"]
    return {nm: (len(v), max(v) if v else None) for nm, v in errs.items()}


def mesh_world_1m():
    """(l) 1: the 1M world on a 4-shard virtual mesh of the card against
    the single-device graph tick, under engines 1 and 2."""
    w = settled_world(N_MAIN, DEV)
    k = w.kernel
    s0 = snapshot(k.state)
    k.set_graph_tick(True)
    want = [k.tick().counters["state_digest"] for _ in range(MESH_TICKS)]
    k.state = fresh(s0)
    single_ms = statistics.median(tick_times(k, 10, graph=DEV == "cuda"))
    k.set_graph_tick(False)
    out = {"single_graph_tick_ms": single_ms, "engines": {}}
    launches = {nm: 0 for nm in sck.KERNELS}
    held = {}
    for engine, name in ((1, "combat_fold"), (2, "fused_neighborhood")):
        os.environ["NF_PALLAS"] = str(engine)
        try:
            detach_mesh(k, s0)
            sk = sharded_kernel(k)
            sck.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = [sk.tick().counters["state_digest"] for _ in range(MESH_TICKS)]
            torch.cuda.synchronize()
            observed_s = time.perf_counter() - t0
            step_bytes = sk.last_step_bytes
            ticks = MESH_TICKS
            check(got == want, f"engine {engine}: the 4-shard digest stream equals the "
                               "single-device graph tick's")
            detach_mesh(k, s0)
            sk = sharded_kernel(k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sk.run_device(MESH_TICKS)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            ticks += MESH_TICKS
            check(sk.digest() & 0xFFFFFFFF == want[-1] & 0xFFFFFFFF,
                  f"engine {engine}: run_device({MESH_TICKS}) on the mesh lands on the "
                  "single-device digest")
            detach_mesh(k, s0)
            sk = sharded_kernel(k)
            sk.configure_train(MESH_TRAIN_K)
            outs = sk.train(MESH_TICKS)
            ticks += MESH_TICKS
            check([o.counters["state_digest"] for o in outs] == want,
                  f"engine {engine}: train(K={MESH_TRAIN_K}) on the mesh gives the stream")
            got_launches = {nm: kk.launches for nm, kk in sck.KERNELS.items()}
            check(got_launches[name] >= ticks * MESH_SHARDS,
                  f"engine {engine}: {name} launched on every shard of every tick "
                  f"({got_launches[name]} for {ticks} ticks x {MESH_SHARDS} shards)")
            for nm in launches:
                launches[nm] += got_launches[nm]
            held[name] = held_against_plain(sk.tick)[name]
            check(held[name][0] == MESH_SHARDS and held[name][1] == 0,
                  f"engine {engine}: every shard's {name} equals its plain version")
            out["engines"][engine] = {
                "observed_tick_ms": observed_s / MESH_TICKS * 1e3,
                "run_device_tick_ms": run_s / MESH_TICKS * 1e3,
                "collective_bytes_per_tick": step_bytes,
                "ticks": ticks, "launches": got_launches,
                "per_shard_launches_per_tick": got_launches[name] / (ticks * MESH_SHARDS),
                "last_digest": want[-1]}
        finally:
            os.environ.pop("NF_PALLAS", None)
    del sk, w, k, s0
    free()
    out["held_against_plain"] = {nm: {"shards": c, "max_abs_err": e}
                                 for nm, (c, e) in held.items()}
    return out, launches, held


def elastic_world(n_shards: int, mesh):
    """The 1M benchmark recipe's extent and cells in an ELASTIC_CAP-row bank
    with a spatial placement (combat and movement off: the walk draws a
    row's target by its slot, and the fold breaks ties by row, so with
    them a migrated row would not be a control's row), an identity in the
    Gold column."""
    from noahgameframe_tpu_torch.core.store import with_class
    from noahgameframe_tpu_torch.parallel.rowmigrate import SpatialPlacement

    extent = float(np.sqrt(N_MAIN / 0.4))
    cell = 4.0
    width = int(extent / cell)
    pl = SpatialPlacement(class_name="NPC", pos_prop="Position", extent=extent,
                          cell_size=cell, width=width, n_shards=n_shards,
                          mig_budget=ELASTIC_BUDGET)
    w = gw.GameWorld(gw.WorldConfig(npc_capacity=ELASTIC_CAP, extent=extent, combat=False,
                                    movement=False, seed=SEED, middleware=False,
                                    placement=pl, mesh=mesh), device=DEV)
    w.start()
    w.scene.create_scene(1, width=extent)
    w.seed_npcs(ELASTIC_N)
    k = w.kernel
    col = k.store.spec("NPC").slot("Gold").col
    cs = k.state.classes["NPC"]
    i32 = cs.i32.clone()
    i32[:, col] = torch.arange(i32.shape[0], dtype=torch.int32, device=i32.device)
    k.state = with_class(k.state, "NPC", cs.replace(i32=i32))
    return w, {"NPC": col}


def mesh_elastic():
    """(l) 2: grow 2 -> 4, drain shard 3, under ticks; the canonical digest
    pinned to a one-shard control's after every op."""
    from noahgameframe_tpu_torch.parallel.elastic import DigestControl

    w, ident = elastic_world(2, virtual_mesh(2))
    el = w.shard(ident_cols=ident, exodus_tick_bound=64)
    ctl_world, _ = elastic_world(1, virtual_mesh(1))
    control = DigestControl(ctl_world, ident)
    k = w.kernel
    out = {"rows": ELASTIC_N, "capacity": ELASTIC_CAP, "mig_budget": ELASTIC_BUDGET,
           "ops": []}
    stats = {"migrated": 0, "overflow": 0, "dropped": 0}

    def tick(n=1):
        for _ in range(n):
            w.tick()
            s = k.state.aux[w.migration.aux_key].cpu().numpy()
            stats["migrated"] += int(s[:, 0].sum())
            stats["overflow"] += int(s[:, 1].sum())
            stats["dropped"] += int(s[:, 2].sum())

    def pinned(tag):
        check(el.digest() == control.advance_to(k.tick_count),
              f"elastic {tag}: canonical digest equals the static control's")

    tick(4)
    pinned("warm@2")
    for kind, arg in (("grow", 4), ("drain", 3)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        el.begin_grow(arg) if kind == "grow" else el.begin_drain(arg)
        ticks = 0
        for _ in range(100):
            el.poll()
            if el.inflight is None:
                break
            tick()
            ticks += 1
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(el.inflight is None, f"elastic {kind} completed")
        pinned(f"after {kind}")
        out["ops"].append({**el.ops_done[-1], "seconds": secs, "ticks": ticks})
    tick(3)
    pinned("settled@3")
    st = el.status()
    check(st["dropped_rows"] == 0 and stats["dropped"] == 0, "elastic: no row dropped")
    check(st["pop"] == st["pop_baseline"] == ELASTIC_N, "elastic: the population is kept")
    check(stats["migrated"] > 0, "elastic: rows migrated")
    out.update(stats, devices=el.n_devices, status=st)
    del w, ctl_world, control, el, k
    free()
    return out


def spatial_geom(n: int, n_shards: int, skin: float):
    """The JAX package's bench geometry (``run_mesh_migrate``) for n
    entities, with cells widened to radius + skin."""
    from noahgameframe_tpu_torch.ops.stencil import auto_bucket
    from noahgameframe_tpu_torch.parallel.spatial import SpatialGeom

    radius = 4.0
    cell = max(4.0, radius + skin)
    extent = max(64.0, float(np.sqrt(n / 0.4)))
    width = max(MESH_SHARDS, int(extent / cell))
    width -= width % MESH_SHARDS
    extent = width * cell
    # +16 victim slots: a cell-bucket drop would make the dropped set
    # depend on row order, which differs between placements
    bucket = auto_bucket(n, width) + 16
    att_bucket = auto_bucket(max(1, n // 30), width, lo=4, align=2) + 4
    return SpatialGeom(extent=extent, cell_size=cell, width=width, n_shards=n_shards,
                       bucket=bucket, att_bucket=att_bucket, radius=radius,
                       mig_budget=8192, speed=1.0, attack_period=30, skin=skin)


def mesh_spatial():
    """(l) 3: the spatial preset at 4,194,304 entities, 4 shards against 1,
    at skin 0 and 2.0: equal HP by gid every tick."""
    from noahgameframe_tpu_torch.parallel.spatial import SpatialWorld

    rng = np.random.default_rng(SEED)
    out = {"entities": SPATIAL_N, "ticks": SPATIAL_TICKS, "runs": {}}
    for skin in (0.0, 2.0):
        g4 = spatial_geom(SPATIAL_N, MESH_SHARDS, skin)
        pos = rng.uniform(1.0, g4.extent - 1.0, (SPATIAL_N, 2)).astype(np.float32)
        hp = np.full(SPATIAL_N, 10_000, np.int32)
        atk = rng.integers(5, 20, SPATIAL_N).astype(np.int32)
        camp = (np.arange(SPATIAL_N) % 2).astype(np.int32)
        worlds = {}
        for shards in (MESH_SHARDS, 1):
            g = g4._replace(n_shards=shards)
            sw = SpatialWorld(g, mesh=virtual_mesh(shards))
            t0 = time.perf_counter()
            sw.place(pos, hp, atk, camp)
            torch.cuda.synchronize()
            worlds[shards] = (sw, time.perf_counter() - t0)

        def hp_by_gid(sw):
            st = sw.state
            dst = torch.full((SPATIAL_N,), -1, dtype=torch.int32, device=st.hp.device)
            dst[st.gid[st.active].long()] = st.hp[st.active]
            return dst

        run = {"geometry": dict(g4._asdict()), "migrated": 0, "tick_ms": {}}
        secs = {MESH_SHARDS: 0.0, 1: 0.0}
        for t in range(SPATIAL_TICKS):
            for shards, (sw, _p) in worlds.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sw.step()
                torch.cuda.synchronize()
                secs[shards] += time.perf_counter() - t0
                check(int(sw.stats_last[:, 1:].sum()) == 0,
                      f"spatial skin {skin}, {shards} shards: no overflow or drop "
                      f"{sw.stats_last.sum(axis=0).tolist()}")
            run["migrated"] += int(worlds[MESH_SHARDS][0].stats_last[:, 0].sum())
            check(torch.equal(hp_by_gid(worlds[MESH_SHARDS][0]), hp_by_gid(worlds[1][0])),
                  f"spatial skin {skin}: HP by gid equal on 4 shards and 1 at tick {t}")
        check(run["migrated"] > 0, f"spatial skin {skin}: migration moved rows")
        hp4 = hp_by_gid(worlds[MESH_SHARDS][0])
        check(bool((hp4 < 10_000).any()), f"spatial skin {skin}: combat landed")
        for shards, s in secs.items():
            run["tick_ms"][shards] = s / SPATIAL_TICKS * 1e3
            run[f"ticks_per_s_{shards}_shards"] = SPATIAL_TICKS / s
            run[f"place_s_{shards}_shards"] = worlds[shards][1]
        run["rebuilds_4_shards"] = worlds[MESH_SHARDS][0].rebuilds_total
        out["runs"][str(skin)] = run
        del worlds
        free()
    return out


def mesh_rooms():
    """(l) 4: 16,384 rooms of the rooms recipe over 4 shards: every room's
    digest lane equals the unsharded batch's, every tick."""
    w = rooms_recipe()
    k = w.kernel
    base = k.state.replace(aux={})
    leaves, spec, _ = tree.flatten(base)
    state = tree.unflatten(spec, [x.unsqueeze(0).expand(ROOMS_MAIN, *x.shape).clone()
                                  for x in leaves])
    seeds = torch.arange(SEED, SEED + ROOMS_MAIN, dtype=torch.int64, device=DEV)
    state = state.replace(rng=torch.stack([torch.zeros_like(seeds), seeds], -1))
    check(torch.equal(state.rng[7], prng_key(SEED + 7, DEV)), "room keys as prng_key gives")
    # each batch takes its own copy: a captured step writes its batch's
    # tensors in place
    s0 = snapshot(state)
    plain = rooms.RoomBatch(k, ROOMS_MAIN)
    plain.load_state(fresh(s0))
    sharded = rooms.RoomBatch(k, ROOMS_MAIN, mesh=virtual_mesh(MESH_SHARDS, axis="rooms"))
    sharded.load_state(fresh(s0))
    sck.reset_launch_counts()
    times = {"plain": 0.0, "sharded": 0.0}
    for t in range(MESH_ROOM_TICKS):
        for name, b in (("plain", plain), ("sharded", sharded)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b.tick()
            torch.cuda.synchronize()
            times[name] += time.perf_counter() - t0
        check(np.array_equal(plain.last_counters["state_digest"],
                             sharded.last_counters["state_digest"]),
              f"rooms: 4-shard digest lanes equal the unsharded batch's at tick {t}")
    launches = {nm: kk.launches for nm, kk in sck.KERNELS.items()}
    out = {"rooms": ROOMS_MAIN, "shards": MESH_SHARDS, "ticks": MESH_ROOM_TICKS,
           "tick_ms": {n: s / MESH_ROOM_TICKS * 1e3 for n, s in times.items()},
           "launches": launches}
    del plain, sharded, state, s0, w, k
    free()
    return out


def mesh_worker(pid: int, nproc: int, coord: str) -> int:
    """One process of (l) 5: join the gloo group, mesh 2 shards of cuda:0
    a process, one sharded tick of the 65,536-row world; print the
    checksum and the local tick's."""
    import torch.distributed as dist

    from noahgameframe_tpu_torch.parallel import collectives as coll
    from noahgameframe_tpu_torch.parallel.multihost import global_mesh, init_distributed
    from noahgameframe_tpu_torch.parallel.shard import ShardedKernel

    sck.library()
    check(init_distributed(coord, nproc, pid, backend="gloo"), "the gloo group joined")
    mesh = global_mesh(local_devices=[MESH_DEVICE, MESH_DEVICE])
    w = gw.build_benchmark_world(DIST_N, seed=SEED, device=DEV)
    k = w.kernel
    local_new, _ = k._step(k.state)
    expected = int(local_new.classes["NPC"].i32.to(torch.int64).sum())
    sk = ShardedKernel(k, mesh=mesh)
    sk.place()
    sk.run_device(1)
    parts = [b.classes["NPC"].i32.to(torch.int64).sum() for b in sk.blocks]
    checksum = int(coll.psum(mesh, parts)[0])
    print(json.dumps({"pid": pid, "mesh": mesh.size, "local": len(mesh.local),
                      "checksum": checksum, "expected": expected,
                      "bytes_moved": mesh.bytes_moved}), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def mesh_two_processes():
    """(l) 5: two processes, a gloo group, 2 shards of cuda:0 each."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, here, "--mesh-worker", str(i), "2",
                               f"127.0.0.1:{port}"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=os.path.dirname(here))
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            check(p.returncode == 0, f"mesh worker exits 0: {err[-2000:]}")
            outs.append(json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(o["mesh"] == 4 and o["local"] == 2 for o in outs), f"a global mesh of 4: {outs}")
    check(outs[0]["checksum"] == outs[1]["checksum"] == outs[0]["expected"]
          == outs[1]["expected"], f"the two processes' checksums equal the local tick's {outs}")
    return {"entities": DIST_N, "processes": 2, "backend": "gloo", "workers": outs}


def mesh_cpu_cuda():
    """(l) 6: a 4,096-row world on 4 virtual shards, on cpu and on cuda."""
    from noahgameframe_tpu_torch.parallel.shard import ShardedKernel

    streams = {}
    for dev in ("cpu", DEV):
        w = gw.build_benchmark_world(MESH_PARITY_N, seed=SEED, device=dev)
        w.kernel.enable_digest()
        sk = ShardedKernel(w.kernel, mesh=virtual_mesh(MESH_SHARDS, device=dev))
        sk.place()
        streams[dev] = [sk.tick().counters["state_digest"] for _ in range(MESH_PARITY_TICKS)]
    check(streams["cpu"] == streams[DEV], "the sharded 4,096 world's digests equal on cpu "
                                          "and cuda")
    return {"entities": MESH_PARITY_N, "ticks": MESH_PARITY_TICKS,
            "last_digest": streams["cpu"][-1]}


def phase_mesh(card: str):
    """(l): the multi-device layer on one card (virtual meshes of cuda:0).
    Returns each kernel's launches on the sharded path and the largest
    difference of a shard's launch from its plain version."""
    t_phase = time.perf_counter()
    sub = {}
    t0 = time.perf_counter()
    sub["world_1m"], launches, held = mesh_world_1m()
    emit({"phase": "mesh_world_1m", "card": card, "shards": MESH_SHARDS,
          "ticks": MESH_TICKS, "seconds": time.perf_counter() - t0, **sub["world_1m"]})
    for name, fn in (("elastic", mesh_elastic), ("spatial_4m", mesh_spatial),
                     ("rooms", mesh_rooms), ("two_processes", mesh_two_processes),
                     ("cpu_cuda", mesh_cpu_cuda)):
        t0 = time.perf_counter()
        sub[name] = fn()
        emit({"phase": f"mesh_{name}", "card": card, "seconds": time.perf_counter() - t0,
              **sub[name]})
    emit({"phase": "mesh", "card": card, "seconds": time.perf_counter() - t_phase})
    return launches, {nm: e for nm, (_c, e) in held.items()}


# -- (m) the game-day drill ----------------------------------------------------------
DRILL_SEED = 7
DRILL_SESSIONS, DRILL_CHATS = 40, 5  # scripts/gameday_smoke.py's full campaign
# scripts/reshard_smoke.py's short campaign (its full 12 sessions and 4
# chats before the cuts for phase (o))
RESHARD_SESSIONS, RESHARD_CHATS = 4, 2


def port_script(name: str):
    """A script under scripts/ (the port's drills) as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def drill_run(script, **kw) -> dict:
    """One campaign of ``script``: every check must hold; returns its
    report line's detail, its check count and its seconds."""
    root = tempfile.mkdtemp(prefix="nf_drill_")
    line_path = os.path.join(root, "line.json")
    t0 = time.perf_counter()
    try:
        checks = script.run(root, out_path=line_path, **kw)
        with open(line_path) as f:
            line = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    failed = [n for n, ok in checks.items() if not ok]
    check(not failed, f"{script.__name__}: every check holds ({failed})")
    return {"metric": line["metric"], "value": line["value"], **line["detail"],
            "checks": len(checks), "seconds": time.perf_counter() - t0}


def phase_drill(card: str):
    """(m): the game-day drill (run after (l)).

    1. scripts/torch_gameday_smoke.py's flagship campaign at the JAX
       script's full size (40 sessions, 5 chats, its regen recipe) on
       ``cuda``: a hard store outage under Game1, Game1 hard-killed during
       it and during the session surge, healed, revived from its
       checkpoint and WAL; every check holds and the drill is clean.
    2. The same campaign at a real size: Game1's worlds (live, revive
       substrate, control) and Game2's of phase (j)'s recipe
       (``build_benchmark_world(100_000)``'s, combat on, engine 1, 64
       player rows, each game's guids pinned at its own base), radius 8
       and batched serving, phase (j)'s lease cadence; zero dropped
       sessions, every invariant clean every pump, the revived Game1's NPC
       banks and tick equal a control ticked as far, Game2's journal
       replays digest-clean.  ``combat_fold`` launches in the run (graph
       replays, and each capture's warm-ups), and one tick of the
       control's world after the run with every fold held against its
       plain version.  The re-home time, the longest pump round, the
       checkpoint's save and load seconds.
    3. scripts/torch_reshard_smoke.py's campaign at the JAX script's
       short size (4 sessions, 2 chats) on virtual meshes of ``cuda:0`` (2 ->
       4 -> 3 shards and the 1-shard control): every check holds, and
       ``StableUnderReshard``'s digest clause against the control with
       it."""
    t_phase = time.perf_counter()
    out = {"phase": "drill", "card": card}
    gameday = port_script("torch_gameday_smoke")
    reshard = port_script("torch_reshard_smoke")
    launches0 = sck.KERNELS["combat_fold"].launches
    out["gameday"] = drill_run(gameday, seed=DRILL_SEED, sessions=DRILL_SESSIONS,
                               chats=DRILL_CHATS, device=DEV)
    check(sck.KERNELS["combat_fold"].launches == launches0,
          "the regen recipe launches no fold")

    built = []

    def world(seed: int, player_capacity: int, device):
        # Game1's worlds come from the campaign's seed, Game2's from seed + 1000
        base = GUID_BASE["Game1" if seed == DRILL_SEED else "Game2"]
        w = pinned_world(CLUSTER_N, player_capacity, device, base, seed=seed)
        built.append((seed, w))
        return w

    recipe = gameday.Recipe(world=world, role_kwargs=dict(CLUSTER_KW), keepalive_s=KEEPALIVE_S,
                            lease_suspect_s=LEASE_SUSPECT_S, lease_down_s=LEASE_DOWN_S)
    sck.reset_launch_counts()
    real = drill_run(gameday, seed=DRILL_SEED, sessions=DRILL_SESSIONS, chats=DRILL_CHATS,
                     device=DEV, recipe=recipe)
    launches = {n: kk.launches for n, kk in sck.KERNELS.items()}
    check(launches["combat_fold"] > 0, "combat_fold launched in the real-size drill")
    # the control (Game1's third world) ended the run ticked as far as the revived game
    control = [w for seed, w in built if seed == DRILL_SEED][1]
    held = held_against_plain(control.kernel.tick)
    check(held["combat_fold"][0] == 1 and held["combat_fold"][1] == 0,
          f"the drill world's fold equals its plain version ({held})")
    out["real_size"] = {**real, "entities": CLUSTER_N, "worlds": len(built),
                        "keepalive_s": KEEPALIVE_S, "lease_suspect_s": LEASE_SUSPECT_S,
                        "lease_down_s": LEASE_DOWN_S, "launches": launches,
                        "held_against_plain": {nm: {"calls": c, "max_abs_err": e}
                                               for nm, (c, e) in held.items()}}
    del built, control
    free()
    out["reshard"] = drill_run(reshard, seed=DRILL_SEED, sessions=RESHARD_SESSIONS,
                               chats=RESHARD_CHATS, device=MESH_DEVICE)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    free()
    return launches, held["combat_fold"][1]


# -- (n) the tools and the examples ------------------------------------------------
HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, "examples")
TEMPLATE_PLAYERS = 4096  # live Player rows of the template world, in a bank of twice that
TEMPLATE_TICKS = 30
TEMPLATE_DEAD_MP = 50  # written into the dead Player rows: the phase must keep it
PINNED_GUID = 5_000_000
# tests/test_codegen.py's class sheets
IOBJECT_CSV = """[class],name=IObject
[property]
Name,Type,Public,Private,Save,Cache,Ref,Upload,Desc
ID,string,0,1,0,0,0,0,
ClassName,string,0,1,0,0,0,0,
SceneID,int,0,1,0,0,0,0,
GroupID,int,0,1,0,0,0,0,
"""
HERO_CSV = """[class],name=Hero,parent=IObject,instancepath=Ini/Hero.xml
[property]
Name,Type,Public,Private,Save,Cache,Ref,Upload,Desc
HP,int,1,1,1,0,0,0,hit points
Speed,float,1,0,0,0,0,0,
Title,string,1,1,1,1,0,0,
Home,vector3,0,1,1,0,0,0,
[record:Inventory],rows=8,public=1,save=1
Tag,Type
ItemID,string
Count,int
[components]
Name,Language
HeroAI,python
"""
HERO_INI_CSV = """Id,HP,Speed,Title
hero_alpha,120,1.5,Captain
hero_beta,90,2.25,Scout
"""
# examples/torch_<name>.py (the plugin template runs in template_check);
# tutorials 5 and 8 build 4-shard virtual meshes
TUTORIALS = ("tutorial1_lifecycle", "tutorial2_properties", "tutorial3_heartbeat_events",
             "tutorial4_actor", "tutorial7_gameplay", "tutorial6_cluster",
             "tutorial5_sharded_world", "tutorial8_spatial")


@contextlib.contextmanager
def pinned_guids():
    """Every guid allocator built in the block starts pinned (the tutorials
    print guids, wall-clock numbers otherwise), so two runs print the same
    lines."""
    from noahgameframe_tpu_torch.core.datatypes import GuidAllocator

    init = GuidAllocator.__init__

    def pinned(alloc, *a, **kw):
        init(alloc, *a, **kw)
        alloc.pin(PINNED_GUID)

    GuidAllocator.__init__ = pinned
    try:
        yield
    finally:
        GuidAllocator.__init__ = init


def example_lines(name: str, device: str, env=None) -> tuple:
    """The lines ``examples/torch_<name>.py``'s ``main(device)`` prints
    (tutorial 4's result lines sorted: its two threads finish in either
    order), and its seconds; ``env`` is set around the run."""
    import io
    import runpy

    ns = runpy.run_path(os.path.join(EXAMPLES, f"torch_{name}.py"))
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with pinned_guids(), contextlib.redirect_stdout(buf):
            ns["main"](device)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    lines = buf.getvalue().splitlines()
    results = sorted(ln for ln in lines if ln.startswith("  result from actor"))
    if results:
        rest = [ln for ln in lines if not ln.startswith("  result from actor")]
        lines = rest[:1] + results + rest[1:]
    return lines, time.perf_counter() - t0


def cpp_driver(classes) -> str:
    """A C++ program over the generated header: a framed stream on stdin
    (msg id = index in ``classes``), each body decoded and re-encoded,
    framed to stdout (tests/test_cpp_sdk.py's driver)."""
    cases = "\n".join(
        f"        case {i}: {{ nfmsg::{c.__name__} m; "
        f"if (!m.Decode(body.data(), body.size())) return 2; out2 = m.Encode(); break; }}"
        for i, c in enumerate(classes))
    return ('#include "nfmsg.hpp"\n#include <cstdio>\n#include <iostream>\n#include <iterator>\n'
            "int main() {\n"
            "    std::string in((std::istreambuf_iterator<char>(std::cin)),\n"
            "                   std::istreambuf_iterator<char>());\n"
            "    std::string out; size_t off = 0; uint16_t id; std::string body;\n"
            "    nfmsg::UnframeResult ur;\n"
            "    while ((ur = nfmsg::unframe(in, off, id, body)) == nfmsg::UNFRAME_OK) {\n"
            "        std::string out2;\n        switch (id) {\n"
            f"{cases}\n        default: return 3;\n        }}\n"
            "        nfmsg::frame(out, id, out2);\n    }\n"
            "    if (ur == nfmsg::UNFRAME_ERROR) return 5;\n"
            "    if (off != in.size()) return 4;\n"
            "    fwrite(out.data(), 1, out.size(), stdout);\n    return 0;\n}\n")


def start_sdk_build(root: str):
    """Start g++ on the port's C++ header (``-Wall -Werror``) with a driver
    over every wire class; returns (process, binary, classes)."""
    from noahgameframe_tpu_torch.tools.emit_cpp_sdk import _collect, emit_header

    classes = list(_collect())
    with open(os.path.join(root, "nfmsg.hpp"), "w") as f:
        f.write(emit_header())
    with open(os.path.join(root, "main.cc"), "w") as f:
        f.write(cpp_driver(classes))
    exe = os.path.join(root, "roundtrip")
    gpp = shutil.which("g++")
    check(gpp is not None, "g++ is on PATH")
    proc = subprocess.Popen([gpp, "-std=c++11", "-O1", "-Wall", "-Werror", "-I", root,
                             os.path.join(root, "main.cc"), "-o", exe],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, exe, classes


def tools_check(build, root: str) -> dict:
    """(n) 1: the port's emitters reproduce clients/unity/ byte for byte,
    every golden vector round-trips through the compiled header, and the
    codegen pipeline's XML builds a world on the card that ticks."""
    import struct
    from pathlib import Path

    from noahgameframe_tpu_torch.core.schema import load_logic_class_xml
    from noahgameframe_tpu_torch.core.store import StoreConfig
    from noahgameframe_tpu_torch.kernel import Kernel, Plugin, PluginManager
    from noahgameframe_tpu_torch.tools import CodegenPipeline
    from noahgameframe_tpu_torch.tools.emit_cs_sdk import emit_cs
    from noahgameframe_tpu_torch.tools.golden_vectors import (
        emit_cs_harness,
        emit_vectors,
        golden_cases,
    )

    out = {}
    unity = os.path.join(HERE, "clients", "unity")
    for fname, emit in (("NFMsg.cs", emit_cs), ("NFMsgGolden.tsv", emit_vectors),
                        ("NFMsgGoldenTest.cs", emit_cs_harness)):
        with open(os.path.join(unity, fname)) as f:
            committed = f.read()
        check(emit() == committed, f"the port's emitter reproduces clients/unity/{fname}")
        out[fname] = len(committed.encode())
    proc, exe, classes = build
    t0 = time.perf_counter()
    log, _ = proc.communicate(timeout=300)
    out["gpp_wait_s"] = time.perf_counter() - t0
    check(proc.returncode == 0, f"the C++ header compiles with -Wall -Werror ({log[-2000:]})")
    index = {c.__name__: i for i, c in enumerate(classes)}
    cases = golden_cases()
    stream = b"".join(struct.pack(">HI", index[n], len(raw) + 6) + raw for n, raw in cases)
    r = subprocess.run([exe], input=stream, capture_output=True, timeout=60)
    check(r.returncode == 0 and r.stdout == stream,
          f"every golden vector round-trips byte-equal through the C++ binary (rc {r.returncode})")
    out["golden_vectors"] = len(cases)
    out["stream_bytes"] = len(stream)

    src, dst = os.path.join(root, "src"), Path(root) / "out"
    os.makedirs(src)
    for fname, text in (("IObject.csv", IOBJECT_CSV), ("Hero.csv", HERO_CSV),
                        ("Hero.ini.csv", HERO_INI_CSV)):
        with open(os.path.join(src, fname), "w") as f:
            f.write(text)
    report = CodegenPipeline(Path(src), dst).run()
    reg = load_logic_class_xml(dst / "Struct" / "LogicClass.xml", data_root=dst)
    k = Kernel(reg, StoreConfig(default_capacity=16), device=DEV)
    pm = PluginManager()
    pm.register_plugin(Plugin("KernelPlugin", [k]))
    k.elements.load_all(dst)
    pm.start()
    heroes = [k.create_from_element("Hero", e) for e in ("hero_alpha", "hero_beta")]
    check([int(k.get_property(g, "HP")) for g in heroes] == [120, 90],
          "the generated Hero elements seed their HP")
    pm.run(2)
    check(k.tick_count == 2 and k.state.classes["Hero"].i32.device.type == torch.device(DEV).type,
          "the generated world ticks on the card")
    out["codegen"] = {"classes": report["classes"], "files": len(report["struct"])
                      + len(report["ini"]) + len(report["constants"]) + len(report["sql"]),
                      "ticks": k.tick_count}
    return out


def tutorials_check() -> dict:
    """(n) 2: every tutorial on ``cuda`` (5 and 8 on 4-shard virtual meshes
    of ``cuda:0``, 5 under both kernels) prints the value lines of its
    ``cpu`` run."""
    out = {}
    for name in TUTORIALS:
        cpu, cpu_s = example_lines(name, "cpu")
        if name == "tutorial5_sharded_world":
            runs = {f"cuda NF_PALLAS={e}": example_lines(name, DEV, {"NF_PALLAS": str(e)})
                    for e in (1, 2)}
        else:
            runs = {"cuda": example_lines(name, DEV)}
        for label, (lines, _s) in runs.items():
            if name == "tutorial5_sharded_world":
                # the mesh and sharding lines name the devices
                want = [ln for ln in cpu if ln.startswith("alive:")] + cpu[-1:]
                got = [ln for ln in lines if ln.startswith("alive:")] + lines[-1:]
            else:
                want, got = cpu, lines
            check(got == want, f"{name} on {label} prints its cpu run's lines ({got} vs {want})")
        check(cpu[-1].endswith("done") or cpu[-1].endswith("OK"), f"{name} ran to its last line")
        out[name] = {"cpu_s": cpu_s, **{f"{lb}_s": s for lb, (_l, s) in runs.items()},
                     "last": cpu[-1], "lines": len(cpu)}
        if name == "tutorial5_sharded_world":
            out[name]["alive"] = [ln for ln in cpu if ln.startswith("alive:")][0]
            out[name]["sharding"] = runs["cuda NF_PALLAS=1"][0][:2]
    return out


def template_world(n: int, players: int, device: str):
    """BASELINE config 4's recipe (``build_benchmark_world(n)``'s geometry,
    seed and combat) with examples/torch_plugin_template.py loaded by its
    manifest before ``start()``, ``players`` live Player rows with MP in
    a bank of twice that, and TEMPLATE_DEAD_MP written into the dead
    rows."""
    from pathlib import Path

    from noahgameframe_tpu_torch.core.store import set_column, with_class

    extent = max(64.0, float(np.sqrt(n / 0.4)))
    w = gw.GameWorld(gw.WorldConfig(
        npc_capacity=1 << int(np.ceil(np.log2(max(n, 64)))), extent=extent, seed=SEED,
        attack_period_s=1.0, middleware=False, player_capacity=2 * players), device=device)
    with tempfile.TemporaryDirectory() as d:
        manifest = Path(d) / "Plugin.xml"
        manifest.write_text('<XML><Plugin Name="torch_plugin_template"/></XML>')
        sys.path.insert(0, EXAMPLES)
        try:
            check(w.pm.load_manifest(manifest) == 1, "the manifest loads the template")
        finally:
            sys.path.remove(EXAMPLES)
    w.start()
    w.scene.create_scene(1, width=extent)
    w.seed_npcs(n)
    k = w.kernel
    rng = np.random.default_rng(SEED + 12)
    k.state, _guids, _rows = k.store.create_many(k.state, "Player", players, values={
        "SceneID": np.full(players, 1, np.int64), "GroupID": np.zeros(players, np.int64),
        "MP": rng.integers(0, 2 * TEMPLATE_TICKS, players)})
    cs = k.state.classes["Player"]
    col = k.store.spec("Player").slot("MP").col
    i32 = set_column(cs.i32, col, torch.where(cs.alive, cs.i32[:, col], TEMPLATE_DEAD_MP))
    k.state = with_class(k.state, "Player", cs.replace(i32=i32))
    return w


def player_mp(k):
    cs = k.state.classes["Player"]
    return cs.i32[:, k.store.spec("Player").slot("MP").col].clone(), cs.alive.clone()


def template_check() -> tuple:
    """(n) 3: the plugin template at full width: 1M NPCs and 4,096 players.
    Its MP drain over TEMPLATE_TICKS graph ticks, the graph stream against
    eager ticks from the same state, the graph tick beside phase 3's, and
    one combat_fold a replayed tick.  Returns the line and the world."""
    t0 = time.perf_counter()
    w = template_world(N_MAIN, TEMPLATE_PLAYERS, DEV)
    k = w.kernel
    check(w.pm.find_module_by_name("MyGameplayModule") is not None, "the template is registered")
    k.enable_digest()
    w.run(20)  # settles the overflow auto-resize
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    s0 = snapshot(k.state)
    mp0, alive = player_mp(k)
    check(int(alive.sum()) == TEMPLATE_PLAYERS, "4,096 live players")

    k.set_graph_tick(False)
    eager = observed_stream(w, TEMPLATE_TICKS)
    mp_eager, _ = player_mp(k)
    k.state = fresh(s0)
    k.set_graph_tick(True)
    book = k.costbook
    seq0 = book._seq
    before = {nm: kk.launches for nm, kk in sck.KERNELS.items()}
    graph = observed_stream(w, TEMPLATE_TICKS)
    torch.cuda.synchronize()
    fold = sck.KERNELS["combat_fold"].launches - before["combat_fold"]
    warm = WARMUP_RUNS * sum(1 for r in book.compile_log
                             if r["seq"] >= seq0 and r["entry"] == "kernel.step")
    mp_graph, alive_after = player_mp(k)
    check(graph == eager, "the template world's graph digest stream equals its eager ticks'")
    check(torch.equal(mp_graph, mp_eager), "graph and eager ticks drain the same MP")
    want = torch.where(alive, torch.clamp_min(mp0 - TEMPLATE_TICKS, 0), mp0)
    check(torch.equal(alive_after, alive) and torch.equal(mp_graph, want),
          f"every live player lost exactly {TEMPLATE_TICKS} MP (floored at 0), dead rows kept "
          "theirs")
    check(bool((mp_graph[~alive] == TEMPLATE_DEAD_MP).all()), "dead rows keep their MP")
    check(fold == TEMPLATE_TICKS + warm,
          f"one combat_fold a graph tick ({fold} vs {TEMPLATE_TICKS} + {warm} in warm-ups)")
    prof = profile_run(lambda: [k.tick() for _ in range(10)], 10, host_ops=False)
    check(prof["kernel_launches"]["combat_fold"] == 10,
          "the profiler sees one combat_fold kernel a replayed tick of the template world")
    tick_ms = graph_tick_ms(w)
    line = {"entities": N_MAIN, "players": TEMPLATE_PLAYERS,
            "player_rows": int(alive.numel()), "ticks": TEMPLATE_TICKS,
            "build_and_settle_s": build_s, "digests_equal": True,
            "mp_drained": TEMPLATE_TICKS, "floored_at_0": int((want == 0)[alive].sum()),
            "dead_rows_kept": int((~alive).sum()), "combat_fold_launches": fold,
            "warmup_launches": warm, "profiled_combat_fold_per_replayed_tick":
                prof["kernel_launches"]["combat_fold"] / 10,
            "graph_tick_ms": tick_ms,
            "phase3_graph_tick_ms": MAIN_TICK_MS[0] if MAIN_TICK_MS else None,
            "captures": captures(k), "last_digest": graph[-1]}
    return line, w


def free_ports(n: int) -> list:
    import socket

    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


PROCESS_XML = """<XML>
  <Server ID="1" Type="MASTER" Name="M" IP="127.0.0.1" Port="{m}" MaxOnline="100"/>
  <Server ID="4" Type="LOGIN" Name="L" IP="127.0.0.1" Port="{l}" MaxOnline="100"/>
  <Server ID="7" Type="WORLD" Name="W" IP="127.0.0.1" Port="{w}" MaxOnline="100"/>
  <Server ID="5" Type="PROXY" Name="P" IP="127.0.0.1" Port="{p}" MaxOnline="100"/>
  <Server ID="6" Type="GAME" Name="G" IP="127.0.0.1" Port="{g}" MaxOnline="100"/>
</XML>
"""


def five_processes(root: str, device: str) -> dict:
    """(n) 4: scripts/torch_run_role.py five times, as
    tests/test_multiprocess_cluster.py runs scripts/run_role.py, with the
    game's world on ``device``, a journal and a checkpoint dir, and 0.5 s
    keepalives (the library's 10 s refresh would hold the dashboard back
    for 10-20 s): the master's ``/json`` lists the other four roles, a
    GameClient logs in, enters and chats, and the game's journal replays
    digest-clean through ``--replay`` on ``device`` and on ``cpu``.
    (tests/test_torch_multiprocess_cluster.py runs it on the CPU.)"""
    import signal
    import urllib.request

    from noahgameframe_tpu_torch.client import GameClient

    launcher = os.path.join(HERE, "scripts", "torch_run_role.py")
    m, l_, w, p, g, http = free_ports(6)
    xml = os.path.join(root, "cluster.xml")
    with open(xml, "w") as f:
        f.write(PROCESS_XML.format(m=m, l=l_, w=w, p=p, g=g))
    journal, ckpt = os.path.join(root, "journal"), os.path.join(root, "ckpt")
    common = ["--server-xml", xml, "--keepalive-seconds", "0.5",
              "--crash-log-dir", os.path.join(root, "crash")]
    # one intra-op thread a role process: they hold small worlds, and
    # beside other test workers full pools would oversubscribe the cores
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs, logs = {}, []
    out = {}
    t0 = time.perf_counter()

    def log_tail(role: str) -> str:
        with open(os.path.join(root, f"{role}.log")) as f:
            return f.read()[-1500:]

    try:
        for role, sid, extra in (("master", 1, ["--http-port", str(http)]), ("world", 7, []),
                                 ("login", 4, []), ("proxy", 5, []),
                                 ("game", 6, ["--device", device, "--journal", journal,
                                              "--checkpoint-dir", ckpt])):
            log = open(os.path.join(root, f"{role}.log"), "w")
            logs.append(log)
            procs[role] = subprocess.Popen(
                [sys.executable, launcher, "--role", role, "--id", str(sid), *common, *extra],
                stdout=log, stderr=subprocess.STDOUT, cwd=HERE, env=env)
        status, deadline = None, time.monotonic() + 180
        while time.monotonic() < deadline:
            if any(pr.poll() is not None for pr in procs.values()):
                break
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{http}/json", timeout=2) as r:
                    status = json.loads(r.read())
                if all(status.get("servers", {}).get(k)
                       for k in ("login", "world", "proxy", "game")):
                    break
            except OSError:
                pass  # the master is not up yet
            time.sleep(0.25)
        dead = {r: pr.poll() for r, pr in procs.items() if pr.poll() is not None}
        check(not dead, f"the five role processes run ({dead}: "
                        f"{[log_tail(r) for r in dead]})")
        check(status is not None and all(status["servers"].get(k)
                                         for k in ("login", "world", "proxy", "game")),
              f"the master's /json lists the five roles ({status})")
        out["dashboard_green_s"] = time.perf_counter() - t0
        out["servers"] = sorted(status["servers"])

        c = GameClient("procuser")
        c.connect("127.0.0.1", l_)

        def pump(cond, what: str, timeout: float = 60.0) -> None:
            end = time.monotonic() + timeout
            while time.monotonic() < end:
                c.execute()
                if cond():
                    return
                time.sleep(0.01)
            raise RuntimeError(f"check failed: the client's {what}")

        t1 = time.perf_counter()
        pump(lambda: c.connected, "login connect")
        c.login()
        pump(lambda: c.logged_in, "login")
        c.request_world_list()
        pump(lambda: c.worlds, "world list")
        c.connect_world(c.worlds[0].server_id)
        pump(lambda: c.world_grant is not None, "world grant")
        c.connect_proxy()
        pump(lambda: c.connected, "proxy connect")
        c.verify_key()
        pump(lambda: c.key_verified, "key")
        c.select_server(6)
        pump(lambda: c.server_selected, "server select")
        c.create_role("Proc")
        pump(lambda: c.roles, "role")
        c.enter_game("Proc")
        pump(lambda: c.entered, "enter")
        c.chat("hello from one role per process")
        pump(lambda: c.chat_log, "chat echo")
        c.close()
        out["login_enter_chat_s"] = time.perf_counter() - t1
        game = procs.pop("game")
        game.send_signal(signal.SIGINT)  # a clean stop closes the journal
        check(game.wait(timeout=60) == 0, f"the game process stops cleanly ({log_tail('game')})")
    finally:
        for pr in procs.values():
            pr.terminate()
        for pr in procs.values():
            try:
                pr.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pr.kill()
                pr.wait()
        for log in logs:
            log.close()
    # the replays on each device read the same journal and checkpoint:
    # both processes run at once
    out["replay"] = {}
    t1 = time.perf_counter()
    replays = {on: subprocess.Popen(
        [sys.executable, launcher, "--role", "game", "--id", "6", *common,
         "--device", on, "--replay", journal, "--checkpoint-dir", ckpt],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE, env=env)
        for on in dict.fromkeys((device, "cpu"))}
    try:
        for on, pr in replays.items():
            stdout, stderr = pr.communicate(timeout=300)
            check(pr.returncode == 0 and "REPLAY OK" in stdout,
                  f"the game's journal replays digest-clean on {on} "
                  f"({stdout[-800:]} {stderr[-1500:]})")
            out["replay"][on] = {"seconds": time.perf_counter() - t1,
                                 "summary": stdout.strip().splitlines()[-1]}
    finally:
        for pr in replays.values():
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    return out


def phase_examples(card: str):
    """(n): the tools and the examples (run last, ``phase_examples``).

    1. The port's emitters (``noahgameframe_tpu_torch/tools``) reproduce
       the committed clients/unity/{NFMsg.cs,NFMsgGolden.tsv,
       NFMsgGoldenTest.cs} byte for byte; ``emit_header()`` compiles with
       ``g++ -std=c++11 -O1 -Wall -Werror`` (in the background, while 2 and
       3 run) and every golden vector round-trips byte-equal through the
       binary; ``CodegenPipeline`` over tests/test_codegen.py's CSV sheets
       gives XML that the port's loader reads, and a Kernel on the card
       built from it creates the Hero elements and ticks.
    2. Every tutorial (examples/torch_*.py) on ``cuda`` prints the value
       lines of its ``cpu`` run: tutorials 5 and 8 on 4-shard virtual
       meshes of ``cuda:0``, 5 under ``NF_PALLAS=1`` and ``NF_PALLAS=2``.
    3. The plugin template at full width (``template_check``).
    4. Five role processes (``five_processes``).

    The kernel table gains each kernel's launches in 2 and 3, this phase's
    in-process runs (``examples_launches``); one eager tick of the template
    world under each engine then holds every fold against its plain
    version.  Returns the launches and each kernel's error there."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="nf_examples_")
    build = start_sdk_build(root)
    try:
        sck.reset_launch_counts()
        t0 = time.perf_counter()
        tutorials = tutorials_check()
        tutorials_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        template, w = template_check()
        template_s = time.perf_counter() - t0
        launches = {nm: kk.launches for nm, kk in sck.KERNELS.items()}
        check(launches["combat_fold"] > 0 and launches["fused_neighborhood"] > 0,
              f"both kernels launched in the examples ({launches})")
        k = w.kernel
        k.set_graph_tick(False)
        held = {"combat_fold": held_against_plain(k.tick)["combat_fold"]}
        os.environ["NF_PALLAS"] = "2"
        try:
            held["fused_neighborhood"] = held_against_plain(k.tick)["fused_neighborhood"]
        finally:
            os.environ.pop("NF_PALLAS", None)
        for nm, (calls, err) in held.items():
            check(calls == 1 and err == 0, f"the template world's {nm} equals its plain version")
        del w, k
        free()
        t0 = time.perf_counter()
        tools = tools_check(build, root)
        tools_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        processes = five_processes(root, DEV)
        processes_s = time.perf_counter() - t0
    finally:
        if build[0].poll() is None:
            build[0].kill()
            build[0].wait()
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "examples", "card": card, "tools": {**tools, "seconds": tools_s},
          "tutorials": {**tutorials, "seconds": tutorials_s},
          "template": {**template, "seconds": template_s},
          "processes": {**processes, "seconds": processes_s},
          "launches": launches,
          "held_against_plain": {nm: {"calls": c, "max_abs_err": e}
                                 for nm, (c, e) in held.items()},
          "seconds": time.perf_counter() - t_phase})
    return launches, {nm: e for nm, (_c, e) in held.items()}


# -- (o) the script drivers ---------------------------------------------------------
SCRIPT_SEED = 7
SURGE_ROUNDS = 40  # scripts/failover_smoke.py's default
ROOFLINE = {"entities": 20_000, "sessions": 32, "ticks": 120}  # scripts/roofline_report.py's
TRACE_TICKS = 3  # scripts/capture_trace.py's 1M capture
EXPORT_TICKS = 30  # scripts/export_trace.py ticks 100; 30 here is a depth cut


def script_checks(name: str, fn) -> dict:
    """One script run: every check must hold; returns its checks (name ->
    verdict) and seconds."""
    t0 = time.perf_counter()
    checks = fn()
    seconds = time.perf_counter() - t0
    failed = [k for k, ok in checks.items() if not ok]
    check(not failed, f"{name}: every check holds ({failed})")
    return {"checks": checks, "seconds": seconds}


def phase_scripts(card: str):
    """(o): the script drivers (run last, ``phase_scripts``), each on
    ``cuda`` at the JAX script's size.

    1. The cluster smokes: scripts/torch_chaos_smoke.py, the failover
       smoke's ``run`` and ``surge`` (40 round trips), the persist, replay
       and pipeline smokes; each script's checks (all must hold) and
       seconds.
    2. scripts/torch_costbook_smoke.py, with the served game's
       ``kernel.step`` cost record (flops, bytes accessed, temp bytes).
    3. scripts/torch_roofline_report.py at the JAX defaults (20,000
       entities, 32 sessions, 120 ticks, ``NF_STAGE_TIMING=1``) folded
       against ``PEAKS["gpu"]``: each stage's achieved fractions.
    4. scripts/torch_telemetry_smoke.py.
    5. scripts/torch_export_trace.py (1,024 entities, 100 ticks, a
       ``torch.profiler`` capture; 30 ticks, not the script's 100) under
       engines 1 and 2, and
       scripts/torch_capture_trace.py (1M, 3 graph ticks) under engines 1
       and 2: every trace file exists and its profile names
       ``combat_fold`` (engine 1) or ``fused_neighborhood`` (engine 2).

    The kernel table gains each kernel's launches in this phase
    (``scripts_launches``); one eager tick of a 20,000-entity world under
    each engine then holds every fold against its plain version.  Returns
    the launches and each kernel's error there."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="nf_scripts_")
    out = {"phase": "scripts", "card": card}
    sck.reset_launch_counts()
    try:
        def tmp(name: str) -> str:
            d = os.path.join(root, name)
            os.makedirs(d, exist_ok=True)
            return d

        chaos = port_script("torch_chaos_smoke")
        out["chaos"] = script_checks("torch_chaos_smoke", lambda: chaos.run(
            tmp("chaos"), seed=SCRIPT_SEED, device=DEV))
        fo = failover_script()
        out["failover"] = script_checks("torch_failover_smoke", lambda: fo.run(
            tmp("failover"), seed=SCRIPT_SEED, device=DEV))
        surge_line = os.path.join(root, "surge.json")
        out["surge"] = script_checks("torch_failover_smoke --surge", lambda: fo.surge(
            tmp("surge"), rounds=SURGE_ROUNDS, out_path=surge_line, device=DEV))
        with open(surge_line) as f:
            out["surge"]["line"] = json.load(f)
        for name in ("persist", "replay"):
            mod = port_script(f"torch_{name}_smoke")
            out[name] = script_checks(f"torch_{name}_smoke", lambda mod=mod, name=name: mod.run(
                tmp(name), seed=SCRIPT_SEED, device=DEV))
        pipe = port_script("torch_pipeline_smoke")
        out["pipeline"] = script_checks("torch_pipeline_smoke", lambda: pipe.run(
            tmp("pipeline"), device=DEV))
        cost = port_script("torch_costbook_smoke")
        step_path = os.path.join(root, "step.json")
        out["costbook"] = script_checks("torch_costbook_smoke", lambda: cost.run(
            device=DEV, out_path=step_path))
        with open(step_path) as f:
            step = json.load(f)["kernel.step"]
        out["costbook"]["kernel_step"] = {k: step["last"].get(k) for k in (
            "flops", "bytes_accessed", "temp_bytes", "cost_ops", "cost_ms", "uncounted_ops",
            "graph", "launches_per_replay")}
        out["costbook"]["kernel_step"]["capture_ms_total"] = step["capture_ms_total"]
        check(step["last"].get("graph") and step["last"]["flops"] > 0
              and step["last"]["temp_bytes"] > 0, f"the served kernel.step is costed ({step})")
        free()

        t0 = time.perf_counter()
        roof = port_script("torch_roofline_report").run(**ROOFLINE, device=DEV)
        stages = roof["roofline"]["stages"]
        check("tick" in stages and stages["tick"]["frac_of_peak_bytes"] > 0
              and not roof["roofline"]["provisional"],
              f"the roofline folds the tick stage against the card's peaks ({stages})")
        out["roofline"] = {"seconds": time.perf_counter() - t0, "peaks": roof["roofline"]["peaks"],
                           "frames": roof["roofline"]["frames"],
                           "kernel_step": roof["kernel_step"],
                           "stages": {st: {k: v[k] for k in (
                               "entries", "flops_per_frame", "bytes_per_frame",
                               "device_s_per_frame", "achieved_flops_per_s",
                               "achieved_bytes_per_s", "frac_of_peak_flops",
                               "frac_of_peak_bytes")} for st, v in stages.items()}}
        free()
        tele = port_script("torch_telemetry_smoke")
        out["telemetry"] = script_checks("torch_telemetry_smoke", lambda: tele.run(device=DEV))

        export = port_script("torch_export_trace")
        capture = port_script("torch_capture_trace")
        out["export_trace"], out["capture_trace"] = {}, {}
        for engine, kname in ((1, "combat_fold"), (2, "fused_neighborhood")):
            t0 = time.perf_counter()
            os.environ["NF_PALLAS"] = str(engine)
            try:
                info = export.run(ticks=EXPORT_TICKS, out=os.path.join(root, f"spans{engine}.json"),
                                  profile=os.path.join(root, f"prof{engine}"), device=DEV)
            finally:
                os.environ.pop("NF_PALLAS", None)
            check(os.path.getsize(info["out"]) > 0 and info["spans"] > EXPORT_TICKS,
                  f"the export trace's span file (engine {engine})")
            named = capture.kernels_named(info["profile"])
            check(named[kname] > 0, f"the export profile names {kname} ({named})")
            out["export_trace"][f"engine{engine}"] = {
                "spans": info["spans"], "kernels_named": named,
                "seconds": time.perf_counter() - t0}
            free()
            t0 = time.perf_counter()
            cap = capture.run(ticks=TRACE_TICKS, engine=engine,
                              out=os.path.join(root, f"trace{engine}.tar.gz"), device=DEV)
            check(cap["bytes"] > 0 and cap["kernels_named"][kname] > 0,
                  f"the 1M capture names {kname} ({cap})")
            out["capture_trace"][f"engine{engine}"] = {
                **{k: cap[k] for k in ("entities", "ticks", "traced_wall_s", "bytes",
                                       "kernels_named")},
                "seconds": time.perf_counter() - t0}
            free()
        launches = {nm: kk.launches for nm, kk in sck.KERNELS.items()}
        check(launches["combat_fold"] > 0 and launches["fused_neighborhood"] > 0,
              f"both kernels launched by the scripts ({launches})")
        w = gw.build_benchmark_world(ROOFLINE["entities"], seed=SCRIPT_SEED, device=DEV)
        k = w.kernel
        k.set_graph_tick(False)
        held = {"combat_fold": held_against_plain(k.tick)["combat_fold"]}
        os.environ["NF_PALLAS"] = "2"
        try:
            held["fused_neighborhood"] = held_against_plain(k.tick)["fused_neighborhood"]
        finally:
            os.environ.pop("NF_PALLAS", None)
        for nm, (calls, err) in held.items():
            check(calls == 1 and err == 0, f"the scripts' world's {nm} equals its plain version")
        del w, k
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = launches
    out["held_against_plain"] = {nm: {"calls": c, "max_abs_err": e} for nm, (c, e) in held.items()}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    free()
    return launches, {nm: e for nm, (_c, e) in held.items()}


# -- phase (p): nf-lint of the port, and its dynamic twin ----------------------

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(km.__file__)))
LINT_BASELINE = os.path.join(os.path.dirname(PKG_DIR), "nf_lint_torch_baseline.json")
PROBE_N = 4096  # rows of the config-4 world whose captured tick the probe breaks
PROBE_REL = "kernel/kernel.py"
PROBE_FN = ("Kernel", "_pack_summary")
#: each hand kernel and the custom ops that launch it
KERNEL_OPS = {"combat_fold": ("nf::combat_fold",),
              "fused_neighborhood": ("nf::slot_rows", "nf::fused_neighborhood"),
              "wander": ("nf::wander",), "fold_in": ("nf::fold_in",),
              "buff_fold": ("nf::buff_fold",)}


def probe_source():
    """``kernel/kernel.py`` with a ``.item()`` of the tick injected at the
    top of ``Kernel._pack_summary``'s body (after its docstring), in memory:
    (the injected module text, the injected line, the function's source)."""
    import ast
    import textwrap

    with open(os.path.join(PKG_DIR, PROBE_REL), encoding="utf-8") as f:
        src = f.read()
    cls_name, fn_name = PROBE_FN
    cls = next(n for n in ast.parse(src).body
               if isinstance(n, ast.ClassDef) and n.name == cls_name)
    fn = next(n for n in cls.body if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    body = fn.body
    first = body[1] if (isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                        and isinstance(body[0].value.value, str)) else body[0]
    lines = src.splitlines(keepends=True)
    line = first.lineno
    lines.insert(line - 1, " " * first.col_offset + "tick.item()  # injected host read\n")
    injected = "".join(lines)
    new_fn = next(n for n in next(
        n for n in ast.parse(injected).body
        if isinstance(n, ast.ClassDef) and n.name == cls_name).body
        if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    return injected, line, textwrap.dedent(ast.get_source_segment(injected, new_fn))


def capture_probe(spec_path: str) -> int:
    """The child of (p).2 (``chip_smoke.py --capture-probe SPEC``): a
    PROBE_N-row config-4 world on ``cuda`` under ``set_graph_tick`` ticks
    once as a CUDA graph, then ``Kernel._pack_summary`` is replaced by the
    injected source (in memory) and the next tick's capture must raise.
    Prints one JSON line; exits 0 when the capture raised."""
    with open(spec_path) as f:
        spec = json.load(f)
    sck.library()
    w = gw.build_benchmark_world(PROBE_N, seed=SEED, device=DEV)
    k = w.kernel
    k.set_graph_tick(True)
    k.tick()
    entry = k.costbook.entry("kernel.step")
    clean_graph = entry.runner is not None and entry.runner.graph
    torch.cuda.synchronize()
    tick0 = int(k.state.tick)
    ns = dict(vars(km))
    exec(compile(spec["source"], "<injected>", "exec"), ns)
    injected = ns[PROBE_FN[1]]
    calls = [0]

    def counted(*a, **kw):
        calls[0] += 1
        return injected(*a, **kw)

    setattr(km.Kernel, PROBE_FN[1], counted)
    k.invalidate()
    raised = None
    try:
        k.tick()
    except Exception as e:  # the capture must refuse the host read
        # the chain, innermost first: the refused sync, then what the end
        # of the capture reported
        raised, cur = [], e
        while cur is not None and len(raised) < 4:
            raised.insert(0, f"{type(cur).__name__}: "
                             f"{(str(cur).strip().splitlines() or [''])[0][:240]}")
            cur = cur.__cause__ or cur.__context__
    out = {"clean_graph": bool(clean_graph), "tick_before": tick0, "raised": raised,
           "injected_calls": calls[0], "graph_runner_after": entry.runner is not None,
           "warmup_runs": WARMUP_RUNS}
    print(json.dumps(out), flush=True)
    return 0 if raised is not None else 1


def phase_lint(card: str, max_err: dict):
    """(p): nf-lint of the port on the card's host, and its dynamic twin.

    1. ``run_lint`` over the port package against the committed baseline:
       open, suppressed and baselined counts, the rules, the seconds; open
       must be 0 and no baseline entry stale.  ``CUSTOM_OP_PARITY_TESTS``'
       keys are exactly the five ``nf::`` ops behind ``KERNELS``' four
       kernels, each registered with torch, and phase 2 held every kernel
       at ``max_abs_err == 0`` in this run (the row tables of
       ``nf::slot_rows`` equal to ``slot_rows`` is one of its checks).
    2. The dynamic twin of ``capture-safety``: a ``.item()`` injected
       (in memory) into ``Kernel._pack_summary``, which the lint reports
       as reachable from the graph-captured tick; the lint flags the
       injected source through ``overrides=``, and in a child process
       (started first, so it runs beside the lint) a PROBE_N-row config-4
       world's tick capture raises on it (the cost book does not fall back
       to an eager tick)."""
    import ast

    t_phase = time.perf_counter()
    injected, line, fn_src = probe_source()
    root_dir = tempfile.mkdtemp(prefix="nf_probe_")
    try:
        spec_path = os.path.join(root_dir, "spec.json")
        with open(spec_path, "w") as f:
            json.dump({"source": fn_src}, f)
        with open(os.path.join(root_dir, "out"), "w+") as out, \
                open(os.path.join(root_dir, "err"), "w+") as err:
            t_child = time.perf_counter()
            proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                     "--capture-probe", spec_path], stdout=out, stderr=err)
            try:
                # 1: the port's tree
                t0 = time.perf_counter()
                report = run_lint(PKG_DIR, baseline_path=LINT_BASELINE)
                lint_s = time.perf_counter() - t0
                # 2: the injected source through the lint
                t0 = time.perf_counter()
                probe = run_lint(PKG_DIR, rule_filter=["capture-safety"],
                                 overrides={PROBE_REL: injected})
                probe_s = time.perf_counter() - t0
                rc = proc.wait(timeout=300)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            child_s = time.perf_counter() - t_child
            out.seek(0)
            err.seek(0)
            stdout, stderr = out.read(), err.read()
    finally:
        shutil.rmtree(root_dir, ignore_errors=True)

    counts = report.to_json()["counts"]
    check(counts["open"] == 0, f"nf-lint: no open finding on the port ({counts})")
    check(not report.stale_baseline, "nf-lint: no stale baseline entry")
    from noahgameframe_tpu_torch.ops import buff_cuda

    reg = {**sck.CUSTOM_OP_PARITY_TESTS, **buff_cuda.CUSTOM_OP_PARITY_TESTS}
    check(set(KERNEL_OPS) == set(sck.KERNELS), "every hand kernel has its custom ops")
    check(set(reg) == {op for ops in KERNEL_OPS.values() for op in ops},
          "the registry's keys are exactly the kernels' nf:: ops")
    for op in reg:
        check(hasattr(torch.ops.nf, op.partition("::")[2]), f"{op} is registered with torch")
    for name in KERNEL_OPS:
        check(max_err[name] == 0, f"phase 2 held {name} at max_abs_err 0")

    # the root the lint must name: the graph dispatcher of Kernel.compile's tick
    wrap_line = next(n.lineno for n in ast.walk(ast.parse(injected))
                     if isinstance(n, ast.Call) and n.args
                     and getattr(n.args[0], "value", None) == "kernel.step")
    root = f"{PROBE_REL}:{wrap_line} (graph)"
    hits = [f for f in probe.open_findings if f.path == PROBE_REL and f.line == line]
    check(len(hits) == 1 and "`.item()`" in hits[0].message and root in hits[0].message,
          f"the lint flags the injected .item() from the graph-captured tick ({root})")
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    check(bool(lines), f"the capture probe printed its result (rc {rc}): {stderr[-2000:]}")
    child = json.loads(lines[-1])
    check(child["clean_graph"], "the probe world's clean tick ran as a CUDA graph")
    check(rc == 0 and child["raised"], "the capture of the injected tick raised")
    check(not child["graph_runner_after"], "no graph was kept for the injected tick")
    check(child["injected_calls"] >= 1, "the injected function ran on the captured path")
    emit({"phase": "lint", "card": card,
          "lint": {**counts, "rules": len(report.rules), "seconds": lint_s,
                   "stale_baseline": len(report.stale_baseline)},
          "registry": dict(reg), "held_max_abs_err": {n: max_err[n] for n in KERNEL_OPS},
          "probe": {"function": ".".join(PROBE_FN), "path": PROBE_REL, "line": line,
                    "lint_message": hits[0].message, "lint_seconds": probe_s,
                    "capture": child, "child_seconds": child_s},
          "seconds": time.perf_counter() - t_phase})

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-worker":
        return mesh_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if len(sys.argv) > 1 and sys.argv[1] == "--capture-probe":
        return capture_probe(sys.argv[2])
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
    free()
    mesh_launches, mesh_err = phase_mesh(card)
    free()
    drill_launches, drill_err = phase_drill(card)
    free()
    examples_launches, examples_err = phase_examples(card)
    free()
    scripts_launches, scripts_err = phase_scripts(card)
    free()
    phase_lint(card, max_err)

    emit({"phase": "elapsed", "seconds": time.perf_counter() - t_start})
    src = "noahgameframe_tpu_torch/csrc/stencil.cu"
    launches = {"combat_fold": main_launches["combat_fold"],
                "fused_neighborhood": fused_launches}
    # each kernel at the 1M world geometry (its main path) and, as rooms_*,
    # at the rooms geometry (R = 16,384 rooms, 10 x 10 cells, Kv = 8, Ka = 6)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": sck.KERNELS[name].replaces,
         "launches": launches[name],
         "max_abs_err": max(max_err[name], room_err[name], mesh_err[name],
                            drill_err if name == "combat_fold" else 0, examples_err[name],
                            scripts_err[name]),
         "ms": timing[name]["ms"], "eager_ms": timing[name]["eager_ms"],
         "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"], "bound_by": timing[name]["bound_by"],
         "library_ms": None,
         "resumed_launches": persist_launches[name],
         "host_layer_launches": host_launches[name],
         "served_launches": served_launches[name],
         "middleware_launches": middleware_launches[name],
         "cluster_launches": cluster_launches[name],
         "sharded_launches": mesh_launches[name],
         "drill_launches": drill_launches[name],
         "examples_launches": examples_launches[name],
         "scripts_launches": scripts_launches[name],
         "rooms_launches": rooms_launches[name], "rooms_ms": room_timing[name]["ms"],
         "rooms_eager_ms": room_timing[name]["eager_ms"],
         "rooms_plain_ms": room_timing[name]["plain_ms"],
         "rooms_bound_ms": room_timing[name]["bound_ms"],
         "rooms_bound_by": room_timing[name]["bound_by"]}
        for name in ("combat_fold", "fused_neighborhood")] + [
        # the buff fold at the main path's shape (2^20 NPC rows); it runs
        # only in middleware worlds
        {"name": "buff_fold", "route": "cuda", "source": "noahgameframe_tpu_torch/csrc/buff.cu",
         "replaces": sck.KERNELS["buff_fold"].replaces,
         "launches_per_tick": 2, "max_abs_err": max_err["buff_fold"],
         "ms": timing["buff_fold"]["ms"], "eager_ms": timing["buff_fold"]["eager_ms"],
         "plain_ms": timing["buff_fold"]["plain_ms"],
         "bound_ms": timing["buff_fold"]["bound_ms"],
         "bound_by": timing["buff_fold"]["bound_by"],
         "middleware_launches": middleware_launches["buff_fold"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
