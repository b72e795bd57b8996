#!/usr/bin/env python
"""Chaos smoke on the PyTorch port: kill a game server under fault
injection, revive it from its atomic checkpoint, and prove the cluster
converged to the fault-free answer.

    python scripts/torch_chaos_smoke.py                 # worlds on cuda
    python scripts/torch_chaos_smoke.py --device cpu

The port's copy of ``scripts/chaos_smoke.py``: the same scenario, the
same checks under the same names, with every world on ``device``
(``None`` = ``"cuda"``; without a card that raises).  The world recipe
(:func:`build_world`) is the one the persist and replay smokes reuse.

Boots the five-role LocalCluster with a seeded FaultPlan (drops, dups,
delays, corruption, connection refusal, a timed login<->master
partition), waits for a checkpoint, hard-kills the game role, watches
the master's heartbeat lease flip it DOWN, revives it with ``--resume``
semantics, and then asserts:

- the master shows the game DOWN then UP again (lease state),
- the revived world's NPC banks + tick + rng exactly match a fault-free
  control world driven the same number of ticks (faults may delay the
  cluster, never corrupt the simulation),
- the injected-fault / retry / lease-expiry / recovery counters are all
  nonzero and visible over real /metrics scrapes.

Exits 0 on success — wire it into CI next to the telemetry smoke.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torch_telemetry_smoke import scrape  # noqa: E402

NPCS = 8
EXTRA_TICKS = 20


def build_world(seed: int = 7, device=None):
    """One deterministic world recipe used three times: the live world,
    the revive substrate (overwritten by the checkpoint load), and the
    fault-free control.  Regen is the only dynamic phase, so the world
    evolves tick-by-tick with zero host input."""
    from noahgameframe_tpu_torch.game.defines import (
        COMM_PROPERTY_RECORD,
        PropertyGroup,
    )
    from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig

    w = GameWorld(WorldConfig(
        npc_capacity=64, player_capacity=8, seed=seed,
        combat=False, movement=False, regen=True, middleware=False,
        regen_period_s=0.1,
    ), device=device).start()
    # mirror GameRole's scene bring-up so the control world (never
    # attached to a role) starts from the identical host state
    if 1 not in w.scene.scenes:
        w.scene.create_scene(1)
    if 1 not in w.scene.scenes[1].groups:
        w.scene.request_group(1)
    w.seed_npcs(NPCS, hp=100)
    # raise MAXHP above HP so the regen phase has real dynamics to replay
    k = w.kernel
    k.state = k.store.record_write_rows(
        k.state, "NPC", np.arange(NPCS), COMM_PROPERTY_RECORD,
        int(PropertyGroup.EFFECTVALUE), {"MAXHP": [200] * NPCS},
    )
    return w


def fault_plan(seed: int):
    from noahgameframe_tpu_torch.net.chaos import FaultPlan, LinkFaults

    return FaultPlan(seed=seed, links={
        # refuse exercises the RetryPolicy backoff on the game's world link
        "game6.world": LinkFaults(refuse=0.25, drop=0.05, dup=0.05),
        # refuse_first=2 guarantees retries on a link whose role survives
        # the whole scenario (the game role is killed, taking its
        # retries_total with it)
        "proxy5.world": LinkFaults(refuse_first=2, drop=0.05, dup=0.1,
                                   delay=0.1, delay_polls=5),
        # corrupt/truncate exercise the dispatch fault isolation
        "proxy5.games": LinkFaults(dup=0.1, corrupt=0.05, truncate=0.05),
        # timed both-way partition; heals when the window closes
        "login4.master": LinkFaults(partitions=((200, 400, "both"),)),
    })


def _lease(cluster, role: str, sid: int):
    for e in cluster.master.servers_status()["servers"].get(role, []):
        if e["server_id"] == sid:
            return e["lease"]
    return None


def _drive_control(world, ticks: int) -> None:
    """Replay GameRole.execute's exact per-tick module ordering."""
    pm, k = world.pm, world.kernel
    while k.tick_count < ticks:
        for m in pm.modules.values():
            if m is not k:
                m.execute()
        k.execute()
        k.tick()
        pm.frame += 1


def run(tmpdir, seed: int = 7, device=None) -> dict:
    """Run the whole scenario with every world on ``device`` (``None`` =
    ``"cuda"``); returns {check name: bool}."""
    from noahgameframe_tpu_torch.core.device import resolve_device
    from noahgameframe_tpu_torch.net.roles.cluster import LocalCluster
    from noahgameframe_tpu_torch.persist.checkpoint import _flatten_state

    device = resolve_device(device)
    ckpt = Path(tmpdir) / "ckpt"
    # every world the scenario needs is built before the lease clock
    # starts: a build inside the pump would stall it past a lease
    substrate, control = build_world(seed, device), build_world(seed, device)
    cluster = LocalCluster(
        http_port=0,
        game_world=build_world(seed, device),
        lease_suspect_seconds=0.6,
        lease_down_seconds=1.2,
        game_kwargs={"checkpoint_dir": ckpt, "checkpoint_seconds": 0.3},
    )
    checks = {}
    revived = None
    try:
        cluster.apply_chaos(fault_plan(seed))
        cluster.start(timeout=60)
        checks["wired under faults"] = True
        checks["checkpoint written"] = cluster.pump_until(
            lambda: (ckpt / "meta.json").exists(), timeout=30
        )
        cluster.kill_role("Game1")
        checks["master marks game DOWN"] = cluster.pump_until(
            lambda: _lease(cluster, "game", 6) == "DOWN", timeout=30
        )
        revived = cluster.revive_role("Game1", world=substrate,
                                      resume=True)
        reg = revived.telemetry.registry
        checks["resume restored checkpoint"] = (
            reg.value("nf_recoveries_total") == 1
        )
        checks["master marks game UP"] = cluster.pump_until(
            lambda: _lease(cluster, "game", 6) == "UP" and cluster.wired(),
            timeout=60,
        )
        target = revived.kernel.tick_count + EXTRA_TICKS
        checks["revived world ticking"] = cluster.pump_until(
            lambda: revived.kernel.tick_count >= target, timeout=30
        )

        # ---- determinism: revived == fault-free control at equal tick
        _drive_control(control, revived.kernel.tick_count)
        a = _flatten_state(revived.kernel.state)
        b = _flatten_state(control.kernel.state)
        npc_keys = [key for key in b if key.startswith("c/NPC/")]
        checks["world matches fault-free control"] = (
            int(a["tick"]) == int(b["tick"])
            and np.array_equal(a["rng"], b["rng"])
            and all(np.array_equal(a[key], b[key]) for key in npc_keys)
        )

        # ---- counters (in-process reads)
        checks["faults injected"] = cluster.chaos.total() > 0
        retries = sum(
            sum(p.retries_total.values())
            for r in cluster.roles for p in r.clients.values()
        )
        checks["retries counted"] = retries > 0
        checks["lease expiry counted"] = (
            cluster.master.telemetry.registry.value(
                "nf_lease_expirations_total", role="game") >= 1
        )
        checks["partition healed"] = (
            cluster.chaos.total("partition_out") > 0
            and _lease(cluster, "login", 4) == "UP"
        )

        # ---- the same story over real /metrics scrapes
        master_body = scrape(
            cluster.execute, cluster.master.http.port
        ).partition(b"\r\n\r\n")[2].decode()
        checks["/metrics lease counters"] = any(
            ln.startswith('nf_lease_expirations_total{role="game"}')
            and float(ln.split()[-1]) >= 1
            for ln in master_body.splitlines()
        )
        game_http = revived.serve_metrics(0)
        game_body = scrape(
            cluster.execute, game_http.port
        ).partition(b"\r\n\r\n")[2].decode()
        checks["/metrics chaos counters"] = any(
            ln.startswith("nf_chaos_faults_total{")
            and float(ln.split()[-1]) > 0
            for ln in game_body.splitlines()
        )
        checks["/metrics recovery counter"] = any(
            ln.startswith("nf_recoveries_total ")
            and float(ln.split()[-1]) == 1
            for ln in game_body.splitlines()
        )
        proxy_http = cluster.proxy.serve_metrics(0)
        proxy_body = scrape(
            cluster.execute, proxy_http.port
        ).partition(b"\r\n\r\n")[2].decode()
        checks["/metrics retry counters"] = any(
            ln.startswith("nf_reconnects_total{")
            and float(ln.split()[-1]) > 0
            for ln in proxy_body.splitlines()
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
        print(f"CHAOS SMOKE FAILED: {failed}")
        return 1
    print(f"CHAOS SMOKE OK: {len(checks)} checks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
