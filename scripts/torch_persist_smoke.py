#!/usr/bin/env python
"""Write-behind persistence smoke on the PyTorch port: kill a game server
mid-flush while the store is down, revive it from the durable
(checkpoint, WAL) pair, and prove both the world AND the store converged
to the fault-free answer.

    python scripts/torch_persist_smoke.py                 # worlds on cuda
    python scripts/torch_persist_smoke.py --device cpu

The port's copy of ``scripts/persist_smoke.py``: the same scenario, the
same checks under the same names, with every world on ``device``
(``None`` = ``"cuda"``; without a card that raises).

Boots the five-role LocalCluster from torch_chaos_smoke's world recipe plus a
few persisted players, with a write-behind pipeline (persist/
writebehind.py) flushing Save-flagged per-tick diffs into a shared
MemoryKV through a seeded store FaultPlan (refuse-first-N, latency
spikes, a hard down window by op count).  The scenario:

- early flushes retry through the refuse-first budget and land,
- scripted Gold writes + regen dynamics keep the dirty stream flowing,
- a checkpoint (with its WAL fsync barrier) pins the durable pair,
- the store goes DOWN: the queue fills, lag grows, the master's /json
  shows the game degraded — and the tick loop KEEPS TICKING (asserted
  via the tick-latency histogram and the flusher-thread ledger),
- the game role is hard-killed mid-outage; queued batches survive only
  in the staging WAL,
- the revived role recovers the WAL suffix, rides out the rest of the
  outage, then drains to lag 0,
- the final world is bit-identical to a fault-free control (full bank
  compare + the journal's per-tick state digests), and every store blob
  equals the revived world's own Save-pack snapshot.

Exits 0 on success.
"""

from __future__ import annotations

import sys
import tempfile
import threading
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torch_chaos_smoke import build_world  # noqa: E402
from torch_telemetry_smoke import scrape  # noqa: E402

PLAYERS = 3
EXTRA_TICKS = 20
LATENCY_S = 0.1
PERSIST_SERIES = (
    "nf_persist_flush_total", "nf_persist_retry_total",
    "nf_persist_lag_ticks", "nf_persist_queue_depth",
    "nf_persist_degraded",
)


def seed_players(world) -> list:
    """Deterministic persisted players on top of the chaos world: fixed
    guids (the default allocator is wall-clock based), regen armed so
    the Save-flagged dirty stream flows without any host input."""
    from noahgameframe_tpu_torch.core.datatypes import Guid
    from noahgameframe_tpu_torch.game.defines import (
        COMM_PROPERTY_RECORD,
        PropertyGroup,
    )

    # install the role's default stat table up front so the live world
    # (which gets it from GameRole's empty-config fallback) and the
    # bare control world run the identical compiled level phase
    pc = world.property_config
    if not np.any(pc._base):
        pc.fill_linear(
            0,
            base={"MAXHP": 100, "MAXMP": 50, "MAXSP": 50, "HPREGEN": 1,
                  "ATK_VALUE": 10, "DEF_VALUE": 5, "MOVE_SPEED": 30000},
            per_level={"MAXHP": 20, "ATK_VALUE": 2, "DEF_VALUE": 1},
        )
        pc.freeze()
    k = world.kernel
    guids = []
    for i in range(PLAYERS):
        guids.append(k.create_object(
            "Player",
            {"Name": f"Hero{i}", "Account": f"acct{i}",
             "Gold": 100 + i, "HP": 40 + 5 * i},
            guid=Guid(9, 1000 + i), scene=1, group=1,
        ))
    k.state = k.store.record_write_rows(
        k.state, "Player", np.arange(PLAYERS), COMM_PROPERTY_RECORD,
        int(PropertyGroup.EFFECTVALUE),
        {"MAXHP": [200] * PLAYERS, "HPREGEN": [1] * PLAYERS},
    )
    world.regen.arm_all("Player")
    return guids


def store_plan(seed: int):
    """Transport faults from the chaos smoke stay off here — this smoke
    isolates the store leg: a refuse-first budget at boot, probabilistic
    latency spikes throughout, and a hard outage over ops [40, 120).
    The op clock lives in the ChaosDirector, so the revived role's
    rebuilt pipeline CONTINUES the outage instead of restarting it."""
    from noahgameframe_tpu_torch.net.chaos import FaultPlan, StoreFaults

    return FaultPlan(seed=seed, stores={
        "game6.store": StoreFaults(
            fail_first=2,
            latency=0.2, latency_s=LATENCY_S,
            down=((40, 120),),
        ),
    })


def _ext(cluster, role: str, sid: int) -> dict:
    for e in cluster.master.servers_status()["servers"].get(role, []):
        if e["server_id"] == sid:
            return e.get("ext", {})
    return {}


def _drive_control(world, until_tick: int, writes) -> dict:
    """Replay GameRole.execute's exact per-tick module ordering,
    applying the recorded host writes at their recorded tick counts;
    returns tick -> uint32 state digest (the journal's tick_mark form)."""
    pm, k = world.pm, world.kernel
    digests = {}
    by_tick = {}
    for tick, fn in writes:
        by_tick.setdefault(tick, []).append(fn)
    for fn in by_tick.pop(k.tick_count, []):
        fn(world)
    while k.tick_count < until_tick:
        for m in pm.modules.values():
            if m is not k:
                m.execute()
        k.execute()
        k.tick()
        pm.frame += 1
        digests[k.tick_count] = (
            int(k.last_counters.get("state_digest", 0)) & 0xFFFFFFFF
        )
        for fn in by_tick.pop(k.tick_count, []):
            fn(world)
    return digests


def run(tmpdir, seed: int = 7, device=None) -> dict:
    """Run the whole scenario with every world on ``device`` (``None`` =
    ``"cuda"``); returns {check name: bool}."""
    from noahgameframe_tpu_torch.core.device import resolve_device
    from noahgameframe_tpu_torch.net.retry import RetryPolicy
    from noahgameframe_tpu_torch.net.roles.cluster import LocalCluster
    from noahgameframe_tpu_torch.persist.agent import PlayerDataAgent
    from noahgameframe_tpu_torch.persist.checkpoint import _flatten_state
    from noahgameframe_tpu_torch.persist.codec import snapshot_object
    from noahgameframe_tpu_torch.persist.kv import MemoryKV
    from noahgameframe_tpu_torch.replay.journal import read_ticks

    ckpt = Path(tmpdir) / "ckpt"
    wal = Path(tmpdir) / "wal"
    jdir = Path(tmpdir) / "journal"
    device = resolve_device(device)
    kv = MemoryKV()
    world = build_world(seed, device)
    guids = seed_players(world)
    # every world the scenario needs is built before the lease clock
    # starts: a build inside the pump would stall it past a lease
    substrate = build_world(seed, device)
    control = build_world(seed, device)
    seed_players(control)
    cluster = LocalCluster(
        http_port=0,
        game_world=world,
        game_kwargs={
            "checkpoint_dir": ckpt,
            "checkpoint_seconds": 3600.0,  # checkpoints are explicit below
            "journal_dir": jdir,
            "data_agent": PlayerDataAgent(kv),
            "persist_store": kv,
            "persist_wal_dir": wal,
            "persist_drain_timeout": 0.3,
            "autosave_seconds": 3600.0,  # the diff spine is the saver now
        },
    )
    checks = {}
    revived = None
    writes = []  # (tick_count at write, fn) — replayed into the control
    main_thread = threading.get_ident()
    try:
        cluster.apply_chaos(store_plan(seed))
        game = cluster.game
        cluster.start(timeout=60)
        checks["wired under store faults"] = True
        pipeline = game.persist
        checks["pipeline wired"] = pipeline is not None

        # ---- phase A: refuse-first budget retries, then flushes land
        checks["first flush lands after retries"] = cluster.pump_until(
            lambda: pipeline.flushes_total >= 1, timeout=60
        )
        checks["refuse-first retries counted"] = pipeline.retries_total >= 2

        # ---- phase B: scripted Gold writes, recorded for the control.
        # All host writes land BEFORE the checkpoint: the revived run
        # re-executes only post-checkpoint ticks, which must need no
        # host input to match the control.
        for i, g in enumerate(guids):
            target = game.kernel.tick_count + 3
            cluster.pump_until(
                lambda t=target: game.kernel.tick_count >= t, timeout=30)
            tick = game.kernel.tick_count

            def w(wld, gg=g, v=1000 * (i + 1)):
                wk = wld.kernel
                wk.state = wk.store.set_property(wk.state, gg, "Gold", v)

            w(game.game_world)
            writes.append((tick, w))
        checks["gold writes staged"] = True

        # ---- durable pair: checkpoint + WAL fsync barrier
        game.checkpoint_now()
        checks["checkpoint + barrier written"] = (ckpt / "meta.json").exists()

        # ---- phase C: the down window opens; degraded, never blocked
        checks["store outage observed"] = cluster.pump_until(
            lambda: pipeline.degraded() and pipeline.queue_depth() >= 2,
            timeout=60,
        )
        t_deg = game.kernel.tick_count
        cluster.pump_until(
            lambda: game.kernel.tick_count >= t_deg + 10, timeout=30)
        checks["ticks advance while degraded"] = (
            game.kernel.tick_count >= t_deg + 10 and pipeline.degraded()
        )
        checks["lag gauge grows"] = pipeline.lag_ticks() > 0
        checks["degraded on master /json ext"] = cluster.pump_until(
            lambda: _ext(cluster, "game", 6).get("persist_degraded") == "1",
            timeout=30,
        )
        # tick-time telemetry: neither the injected store latency (0.1 s
        # sleeps) nor the outage ever reaches the tick path
        hist = game.telemetry.registry.get("nf_game_tick_seconds")
        checks["tick p50 below injected store latency"] = (
            0.0 < hist.percentile(50) < LATENCY_S
        )
        checks["store calls never on the pump thread"] = (
            len(pipeline.store_threads) > 0
            and main_thread not in pipeline.store_threads
        )
        wal_batches = pipeline.wal.batches_total

        # ---- kill mid-outage: queued batches survive only in the WAL
        cluster.kill_role("Game1")
        checks["WAL retained pending batches"] = wal_batches > 0 and any(
            wal.glob("wal-*.nfw"))

        # ---- revive from the durable (checkpoint, WAL) pair
        revived = cluster.revive_role("Game1", world=substrate,
                                      resume=True)
        rp = revived.persist
        checks["WAL suffix recovered"] = rp.recovered_batches > 0
        # ride out the rest of the down window fast (each retry burns
        # one op against the plan's deterministic [40, 120) schedule)
        rp.retry = RetryPolicy(base=0.003, cap=0.01, seed=seed)
        checks["revived game rewired"] = cluster.pump_until(
            lambda: cluster.wired(), timeout=60
        )
        checks["store heals and queue drains"] = cluster.pump_until(
            lambda: rp.queue_depth() == 0 and rp.lag_ticks() == 0
            and not rp.degraded(),
            timeout=120,
        )
        target = revived.kernel.tick_count + EXTRA_TICKS
        cluster.pump_until(
            lambda: revived.kernel.tick_count >= target, timeout=30)
        checks["healthy on master /json ext"] = cluster.pump_until(
            lambda: _ext(cluster, "game", 6).get("persist_degraded") == "0",
            timeout=30,
        )

        # ---- freeze: stop pumping (no more ticks) and flush the tail
        # so the store reflects the final world before the comparisons
        checks["final drain"] = rp.drain(timeout=10.0)

        # ---- world bit-identical to the fault-free control
        control.kernel.enable_digest()
        digests = _drive_control(control, revived.kernel.tick_count, writes)
        a = _flatten_state(revived.kernel.state)
        b = _flatten_state(control.kernel.state)
        keys = [key for key in b
                if key.startswith("c/NPC/") or key.startswith("c/Player/")]
        checks["world matches fault-free control"] = (
            int(a["tick"]) == int(b["tick"])
            and np.array_equal(a["rng"], b["rng"])
            and all(np.array_equal(a[key], b[key]) for key in keys)
        )

        # ---- journal digest stream (both runs' records, the revived
        # run overwriting the overlap) matches the control everywhere.
        # The revived writer is still OPEN: sync it first, or the strict
        # reader sees its buffered tail as a torn segment.
        if revived.journal is not None:
            revived.journal.sync()
        recorded = read_ticks(jdir)
        overlap = [t for t in recorded if t in digests]
        checks["journal digest stream matches control"] = (
            len(overlap) > 30
            and all(recorded[t] == digests[t] for t in overlap)
        )

        # ---- every store blob equals the live Save-pack snapshot
        rk = revived.kernel
        agent = revived.data_agent
        checks["store blobs match world snapshots"] = all(
            kv.get(agent._key_of(g)) == snapshot_object(
                rk.store, rk.state, g, agent.flags)
            for g in guids
        )
        checks["idempotence watermark written"] = (
            kv.get("__wb__:game6") is not None
        )

        # ---- telemetry: counters moved, /metrics serves all five series
        reg = revived.telemetry.registry
        checks["flush counter moved"] = reg.value("nf_persist_flush_total") > 0
        checks["retry counter moved"] = reg.value("nf_persist_retry_total") > 0
        checks["latency spikes injected"] = (
            cluster.chaos.total("store_latency") > 0
        )
        checks["outage ops refused"] = cluster.chaos.total("store_down") > 0
        game_http = revived.serve_metrics(0)
        body = scrape(
            cluster.execute, game_http.port
        ).partition(b"\r\n\r\n")[2].decode()
        for series in PERSIST_SERIES:
            checks[f"/metrics serves {series}"] = any(
                ln.startswith(series) for ln in body.splitlines()
            )
    finally:
        cluster.shut()
        if revived is not None and revived not in cluster.roles:
            revived.shut()
    return checks


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None, help="the worlds' device (default cuda)")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmpdir:
        checks = run(tmpdir, seed=args.seed, device=args.device)
    failed = [name for name, ok in checks.items() if not ok]
    for name, ok in checks.items():
        print(f"  {'ok  ' if ok else 'FAIL'} {name}")
    if failed:
        print(f"PERSIST SMOKE FAILED: {failed}")
        return 1
    print(f"PERSIST SMOKE OK: {len(checks)} checks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
