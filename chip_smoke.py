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
3. the main path: ``build_benchmark_world(1_000_000)`` on ``cuda`` under
   the default engine 1, warmed up, then ``run_device(90)``: tick times,
   entity-ticks/s and each kernel's launches in that run;
4. 30 observed ticks at 1M under engines 0, 1 and 2 give identical
   ``state_digest`` streams (the engine-2 run is kernel 2's path);
5. ``build_benchmark_world(4096)`` gives the same digest stream for 60
   ticks on ``cuda`` and on ``cpu``.

Then the kernel table line and, last, the result line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this file, it fails before printing any result.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from noahgameframe_tpu_torch.game import world as gw
from noahgameframe_tpu_torch.ops import stencil as sc
from noahgameframe_tpu_torch.ops import stencil_cuda as sck

# published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32
# rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float32 operations per occupied pair: 2 subtractions, 1 multiply, 1 fma
FLOPS_PER_PAIR = 5

N_MAIN = 1_000_000
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
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
            ms=time_ms(lambda: sck.combat_fold(vt, at, radius)),
            plain_ms=time_ms(lambda: sck.combat_fold_plain(vt, at, radius), reps=5),
            bound_ms=b1[0], bound_by=b1[1], pairs=pairs1),
        "fused_neighborhood": dict(
            ms=time_ms(lambda: sck.fused_neighborhood(pop["bank"], vs, ats, radius)),
            plain_ms=time_ms(
                lambda: sck.fused_neighborhood_plain(pop["bank"], vs, ats, radius), reps=5),
            bound_ms=b2[0], bound_by=b2[1], pairs=pairs2,
            # the wrapper's row-table build, part of its ms above
            row_tables_ms=time_ms(lambda: sck.row_tables(vs, ats, n))),
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


# -- phases 3-5 ----------------------------------------------------------------


def free(world) -> None:
    del world
    gc.collect()
    torch.cuda.empty_cache()


def profile_ticks(kernel, n: int, *, host_ops: bool) -> dict:
    """torch.profiler over n run_device ticks: the window's wall time, the
    summed device time of its kernels and copies, and their ratio, the
    card's busy share in that same window.  ``host_ops`` also records the
    host's ATen calls (their count per tick and the top kernels), at a
    higher host cost per launch: the busy share of a window without them
    is nearer the unprofiled tick's.  Device time 0 means the profiler
    recorded no CUDA activity on this machine."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        kernel.run_device(n, reconcile=False)
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
           "device_launches_per_tick": sum(r[2] for r in rows) / n}
    if host_ops:
        out["aten_calls_per_tick"] = sum(
            e.count for e in prof.key_averages() if e.key.startswith("aten::")) / n
        out["top"] = [{"name": k[:80], "ms": us / 1e3, "calls": c}
                      for us, k, c in rows[:12]]
    return out


def phase_main_path():
    t0 = time.perf_counter()
    w = gw.build_benchmark_world(N_MAIN, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    k = w.kernel
    check(w.combat.resolved_engine() == 1, "engine 1 is the default on cuda")
    k.run_device(5, reconcile=False)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sck.reset_launch_counts()
    t0 = time.perf_counter()
    k.run_device(90, reconcile=False)
    # run_device never waits on the card: the host is done enqueueing here,
    # and what is left is the card draining its queue
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {name: kk.launches for name, kk in sck.KERNELS.items()}
    check(launches["combat_fold"] == 90, "kernel 1 ran once per tick of the main path")
    # per-tick device times, outside the counted run
    events = [torch.cuda.Event(enable_timing=True) for _ in range(31)]
    events[0].record()
    for i in range(30):
        k.run_device(1, reconcile=False)
        events[i + 1].record()
    events[-1].synchronize()
    ticks = [events[i].elapsed_time(events[i + 1]) for i in range(30)]
    profile_dev = profile_ticks(k, 10, host_ops=False)
    profile = profile_ticks(k, 10, host_ops=True)
    cs = k.state.classes["NPC"]
    spec = k.store.spec("NPC")
    hp = cs.i32[:, spec.slot("HP").col]
    pos = cs.vec[:, spec.slot("Position").col, :2]
    check(bool(torch.isfinite(pos).all()), "positions finite")
    check(bool(((hp >= 0) & (hp <= 100)).all()), "HP within [0, MAXHP]")
    emit({
        "phase": "main_path", "entities": N_MAIN, "engine": 1,
        "world_build_s": build_s, "ticks": 90,
        "run_device_90_s": total_s, "host_enqueue_90_s": enqueue_s,
        "drain_after_enqueue_ms": (total_s - enqueue_s) * 1e3,
        "mean_tick_ms": total_s / 90 * 1e3,
        "median_tick_ms": statistics.median(ticks),
        "entity_ticks_per_s": N_MAIN * 90 / total_s,
        "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile_10_ticks_device_only": profile_dev,
        "profile_10_ticks": profile,
        "hp_total": int(hp.sum()),
    })
    free(w)
    return launches


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
    free(w)
    return stream, counters, launches, secs


def phase_engines():
    runs = {e: digest_stream(N_MAIN, 30, e, "cuda") for e in (0, 1, 2)}
    s0, c0 = runs[0][0], runs[0][1]
    for e in (1, 2):
        check(runs[e][0] == s0, f"engine {e} digest stream equals engine 0's")
        check(runs[e][1] == c0, f"engine {e} counter bank equals engine 0's")
    check(runs[1][2]["combat_fold"] == 30, "engine 1 ran kernel 1 every tick")
    check(runs[2][2]["fused_neighborhood"] == 30, "engine 2 ran kernel 2 every tick")
    check(runs[0][2]["combat_fold"] == runs[0][2]["fused_neighborhood"] == 0,
          "engine 0 launched no kernel")
    emit({"phase": "engine_digest_parity", "entities": N_MAIN, "ticks": 30,
          "digests_equal": True, "last_digest": s0[-1],
          "launches": {e: runs[e][2] for e in runs},
          "observed_tick_s": {e: runs[e][3] / 30 for e in runs}})
    return runs[2][2]


def phase_cpu_parity():
    gpu = digest_stream(4096, 60, None, "cuda")
    cpu = digest_stream(4096, 60, None, "cpu")
    check(gpu[0] == cpu[0], "cuda and cpu digest streams equal at 4096")
    check(gpu[1] == cpu[1], "cuda and cpu counter banks equal at 4096")
    check(gpu[2]["combat_fold"] == 60, "the cuda run went through kernel 1")
    emit({"phase": "cuda_cpu_parity", "entities": 4096, "ticks": 60,
          "digests_equal": True, "last_digest": gpu[0][-1]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    sck.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in (sck.BUILD_LOG or "").splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln]})

    timing, max_err = phase_kernels()
    main_launches = phase_main_path()
    fused_launches = phase_engines()
    phase_cpu_parity()

    src = "noahgameframe_tpu_torch/csrc/stencil.cu"
    launches = {"combat_fold": main_launches["combat_fold"],
                "fused_neighborhood": fused_launches["fused_neighborhood"]}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": sck.KERNELS[name].replaces,
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"], "bound_by": timing[name]["bound_by"],
         "library_ms": None}
        for name in ("combat_fold", "fused_neighborhood")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
