#!/usr/bin/env python
"""Elastic-mesh game day on the PyTorch port: grow the serving mesh
DURING a session surge, then drain a device out from under the same live
world — all under link chaos — and prove digest-pinned parity with a
fault-free static-mesh control.

    python scripts/torch_reshard_smoke.py                       # full, cuda:0
    python scripts/torch_reshard_smoke.py --short --device cpu  # tier-1

The port's copy of ``scripts/reshard_smoke.py``: the same campaign, the
same checks under the same names.  Every mesh is a virtual mesh of the
one device (``make_mesh(n, device=..., virtual=True)``): 2 shards, grown
to 4, drained to 3, and the 1-shard control.  The composition rides the
drill engine: a seeded, tick-indexed
:class:`drill.Campaign` over a LocalCluster whose Game1 world is placed
on a 2-device mesh with the elastic driver attached
(``GameWorld.shard``), sampled every pump by the standard invariant
library plus :class:`drill.StableUnderReshard` pinned to a 1-shard
fault-free :class:`~parallel.elastic.DigestControl` twin:

    tick   0  surge active (N clients logged into Game1, chatting)
    tick   6  grow_mesh 2 -> 4 devices; clients chat INTO the reshard
    tick 120  drain_device 1 (budgeted row exodus, then 4 -> 3 shrink);
              more chat traffic rides the drain
    tick 160  chaos heals

Asserts: per-tick ``canonical_digest`` equality with the control at
every sampled tick (the mesh grew, drained and rebalanced in between —
the NPC bytes may not differ), zero rows dropped by the exodus
protocol, population conserved across both ops, every mid-reshard chat
echoed exactly once (no dropped or duplicated frames at the serve
edge), every recompile sanctioned by a reshard generation bump
(``unexplained_since() == []``), and the drill verdict clean.
``--out PATH`` writes the report line (exodus ticks, rows moved, drill
verdict) as JSON.  Exits 0 on success.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

NPCS = 16
GROW_TICK = 6
DRAIN_TICK = 120
HEAL_TICK = 160
GROW_TO = 4
DRAIN_DEVICE = 1


def build_world(seed: int, n_shards: int, player_capacity: int = 96,
                device=None):
    """Deterministic regen world with the spatial placement attached, on a
    virtual mesh of ``n_shards`` shards of ``device``.  Capacities are
    divisible by every mesh width this campaign visits (2, 4, 3 — and 1
    for the control): NPC 48, Player 96."""
    from noahgameframe_tpu_torch.core.store import with_class
    from noahgameframe_tpu_torch.game.defines import (
        COMM_PROPERTY_RECORD,
        PropertyGroup,
    )
    from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig
    from noahgameframe_tpu_torch.parallel.mesh import make_mesh
    from noahgameframe_tpu_torch.parallel.rowmigrate import SpatialPlacement

    w = GameWorld(WorldConfig(
        npc_capacity=48, player_capacity=player_capacity, seed=seed,
        extent=64.0, dt=0.01, combat=False, movement=False, regen=True,
        middleware=False, regen_period_s=0.1,
        placement=SpatialPlacement(
            class_name="NPC", pos_prop="Position", extent=64.0,
            cell_size=8.0, width=8, n_shards=n_shards, mig_budget=8,
        ),
        mesh=make_mesh(n_shards, device=device, virtual=True),
    ), device=device).start()
    if 1 not in w.scene.scenes:
        w.scene.create_scene(1)
    if 1 not in w.scene.scenes[1].groups:
        w.scene.request_group(1)
    w.seed_npcs(NPCS, hp=100)
    k = w.kernel
    k.state = k.store.record_write_rows(
        k.state, "NPC", np.arange(NPCS), COMM_PROPERTY_RECORD,
        int(PropertyGroup.EFFECTVALUE), {"MAXHP": [200] * NPCS},
    )
    # unique identity in an inert saved column (Gold) so the placement-
    # invariant digest can pair rows however the mesh has shuffled them;
    # written on a clone, and the new bank replaces the old in the state
    slot = k.store.spec("NPC").slot("Gold")
    cs = k.state.classes["NPC"]
    i32 = cs.i32.clone()
    i32[:, slot.col] = torch.arange(i32.shape[0], dtype=torch.int32,
                                    device=i32.device)
    k.state = with_class(k.state, "NPC", cs.replace(i32=i32))
    return w, slot.col


class _ControlTwin:
    """The DigestControl world shim: ticks the control world with
    GameRole.execute's exact per-tick module ordering."""

    def __init__(self, world):
        self.world = world
        self.kernel = world.kernel

    def tick(self) -> None:
        pm, k = self.world.pm, self.world.kernel
        for m in pm.modules.values():
            if m is not k:
                m.execute()
        k.execute()
        k.tick()
        pm.frame += 1


def _session_of(game, account: str):
    for sess in game.sessions.values():
        if sess.account == account and sess.guid is not None:
            return sess
    return None


def _batch_login(cluster, clients, game_id: int, pump,
                 timeout: float = 30.0) -> bool:
    stages = [
        (lambda c: c.connect("127.0.0.1", cluster.login.config.port),
         "login connect", lambda c: c.connected),
        (lambda c: c.login(), "login ack", lambda c: c.logged_in),
        (lambda c: c.request_world_list(), "world list",
         lambda c: c.worlds),
        (lambda c: c.connect_world(c.worlds[0].server_id),
         "world grant", lambda c: c.world_grant is not None),
        (lambda c: c.connect_proxy(), "proxy connect",
         lambda c: c.connected),
        (lambda c: c.verify_key(), "key verify",
         lambda c: c.key_verified),
        (lambda c: c.select_server(game_id), "server select",
         lambda c: c.server_selected),
        (lambda c: c.create_role(f"P{c.account}"), "role list",
         lambda c: c.roles),
        (lambda c: c.enter_game(f"P{c.account}"), "enter game",
         lambda c: c.entered),
    ]
    for action, stage, cond in stages:
        for cli in clients:
            action(cli)
        if not pump(lambda: all(cond(c) for c in clients), timeout):
            stalled = [c.account for c in clients if not cond(c)]
            print(f"  surge login stalled at {stage}: {stalled[:5]}"
                  f"{'…' if len(stalled) > 5 else ''}")
            return False
    return True


def run(tmpdir, seed: int = 7, sessions: int = 12, chats: int = 4,
        out_path=None, device=None) -> dict:
    """Run the elastic-mesh campaign on virtual meshes of ``device``
    (``None`` = ``"cuda:0"``); returns {check name: bool}."""
    from noahgameframe_tpu_torch.client import GameClient
    from noahgameframe_tpu_torch.drill import (
        Campaign,
        DrillRunner,
        StableUnderReshard,
        default_invariants,
    )
    from noahgameframe_tpu_torch.net.chaos import FaultPlan, LinkFaults
    from noahgameframe_tpu_torch.net.roles.cluster import LocalCluster
    from noahgameframe_tpu_torch.parallel.elastic import DigestControl

    device = torch.device("cuda:0" if device is None else device)
    checks: dict = {}
    world, gold_col = build_world(seed, n_shards=2, device=device)
    ident_cols = {"NPC": gold_col}
    cluster = LocalCluster(
        http_port=0,
        n_games=1,
        game_world=world,
        # a mesh-width re-placement stalls one pump; the lease clock
        # must not read that as a dead game
        lease_suspect_seconds=30.0,
        lease_down_seconds=60.0,
        game_kwargs={
            "autosave_seconds": 3600.0,
            "checkpoint_seconds": 3600.0,
        },
        device=device,
    )
    game1 = cluster.games[0]
    proxy, master = cluster.proxy, cluster.master
    # the elastic driver rides the role's own world — grow_mesh /
    # drain_device campaign actions resolve through GameRole
    elastic = world.shard(2, ident_cols=ident_cols, exodus_tick_bound=64)
    control = DigestControl(
        _ControlTwin(build_world(seed, n_shards=1, device=device)[0]),
        ident_cols)

    clients = [GameClient(f"e{i:02d}") for i in range(sessions)]

    def stir():
        for c in clients:
            c.execute()

    def pump(cond, t=30.0):
        return cluster.pump_until(cond, extra=stir, timeout=t)

    campaign = (
        Campaign("reshard", seed=seed)
        .add(0, "note", label="surge active on a 2-device mesh")
        .add(GROW_TICK, "grow_mesh", label="grow 2 -> 4 mid-surge",
             role="Game1", n=GROW_TO)
        .add(DRAIN_TICK, "drain_device",
             label="drain device 1 under chat traffic",
             role="Game1", device=DRAIN_DEVICE)
        .add(HEAL_TICK, "heal", label="link chaos heals")
    )

    rep = None
    t0 = time.monotonic()
    try:
        cluster.start(timeout=60)
        # delay-only link chaos: frames stall and reorder but never
        # duplicate, so "every chat echoed exactly once" is a real
        # serve-edge coherence check, not an artifact of dup faults
        cluster.apply_chaos(FaultPlan(
            seed=seed,
            links={
                "proxy5.games->6": LinkFaults(delay=0.08, delay_polls=2),
                "game6.world": LinkFaults(delay=0.05, delay_polls=1),
            },
        ))
        checks["cluster wired under link chaos"] = True
        stage_t = 30.0 + 3.0 * sessions
        checks[f"all {sessions} clients entered game 6"] = all(
            _batch_login(cluster, clients[i:i + 8],
                         game1.config.server_id, pump, timeout=stage_t)
            for i in range(0, sessions, 8)
        )
        for c in clients:
            c.chat(f"warm-{c.account}")
        checks["surge warm chat round-tripped"] = pump(
            lambda: all(
                any(t == f"warm-{c.account}" for _w, t in c.chat_log)
                for c in clients
            ),
            t=stage_t,
        )
        # every re-capture from here on must be reshard-sanctioned
        mark = game1.kernel.costbook.mark()

        runner = DrillRunner(
            cluster, campaign,
            invariants=default_invariants()
            + [StableUnderReshard(control=control)],
        )
        sent = [0]

        def surge_extra():
            stir()
            # chat INTO the reshards: a numbered burst per in-flight op
            if elastic.inflight is not None and sent[0] < chats:
                for c in clients:
                    c.chat(f"mid-{c.account}-{sent[0]}")
                sent[0] += 1

        checks["grow completed to 4 devices"] = runner.pump_until(
            lambda: elastic.n_devices == GROW_TO
            and elastic.inflight is None,
            extra=surge_extra, timeout=stage_t,
        )
        # pump the campaign clock up to the drain step, then through it
        checks["drain completed to 3 devices"] = runner.pump_until(
            lambda: runner.tick > DRAIN_TICK
            and elastic.n_devices == GROW_TO - 1
            and elastic.inflight is None,
            extra=surge_extra, timeout=stage_t + 30.0,
        )
        checks["campaign fully fired"] = runner.pump_until(
            lambda: runner.steps_remaining == 0,
            extra=surge_extra, timeout=30.0,
        )
        # drain any still-delayed echo frames before the exactly-once
        # audit (chaos healed at HEAL_TICK; give the links a settle)
        want = [f"mid-{c.account}-{i}"
                for c in clients for i in range(sent[0])]
        runner.pump_until(
            lambda: all(
                sum(1 for _w, t in c.chat_log
                    if t == f"mid-{c.account}-{i}") >= 1
                for c in clients for i in range(sent[0])
            ),
            extra=stir, timeout=30.0,
        )

        ops = list(elastic.ops_done)
        checks["both reshards in the ledger"] = (
            [op["kind"] for op in ops] == ["grow", "drain"])
        checks["reshards moved real rows"] = (
            elastic.rows_moved_total > 0)
        checks["zero rows dropped by the exodus"] = (
            elastic.dropped_rows == 0)
        checks["population conserved across both ops"] = all(
            op["pop_after"] == op["pop_before"] for op in ops
        )
        checks["exodus drained within its tick budget"] = all(
            op.get("drained_in_budget", True) for op in ops
        )
        checks["mid-reshard chats echoed exactly once each"] = (
            bool(want) and all(
                sum(1 for _w, t in c.chat_log
                    if t == f"mid-{c.account}-{i}") == 1
                for c in clients for i in range(sent[0])
            )
        )
        checks["zero parked frames dropped"] = (
            proxy.parking.dropped_total == 0)

        # final digest pin: the elastic world, having grown, drained and
        # rebalanced, equals the static 1-shard fault-free control
        live_tick = int(game1.kernel.tick_count)
        checks["final digest equals static-mesh control"] = (
            elastic.digest() == control.advance_to(live_tick))

        checks["zero unexplained recompiles"] = (
            game1.kernel.costbook.unexplained_since(mark) == [])

        report = runner.report()
        rep = report
        checks["stable_under_reshard sampled"] = (
            report.checks.get("stable_under_reshard", 0) > 0)
        checks["zero invariant violations"] = report.clean
        if not report.clean:
            for v in report.violations[:10]:
                print(f"    violation @tick {v.tick} [{v.invariant}] "
                      f"{v.detail}")
        status = master.servers_status()
        checks["/json drill block live"] = (
            status.get("drill", {}).get("campaign") == "reshard")
    finally:
        for c in clients:
            c.close()
        cluster.shut()

    elapsed = time.monotonic() - t0
    drain_ops = [op for op in (rep and elastic.ops_done or [])
                 if op["kind"] == "drain"]
    exodus_ticks = drain_ops[0]["exodus_ticks"] if drain_ops else 0
    print(f"  reshard: {sessions} sessions held through grow 2->4 and "
          f"drain->3 in {elapsed:.1f}s, exodus={exodus_ticks} ticks, "
          f"rows_moved={elastic.rows_moved_total}, "
          f"dropped={elastic.dropped_rows}")
    if out_path is not None:
        Path(out_path).write_text(json.dumps({
            "metric": "reshard_gameday_exodus_ticks",
            "value": int(exodus_ticks),
            "unit": "ticks",
            "detail": {
                "sessions": sessions,
                "chats_per_session": chats,
                "seed": seed,
                "campaign": "reshard",
                "grow_tick": GROW_TICK,
                "drain_tick": DRAIN_TICK,
                "devices_visited": [2, GROW_TO, GROW_TO - 1],
                "rows_moved_total": int(elastic.rows_moved_total),
                "dropped_rows": int(elastic.dropped_rows),
                "drill_clean": bool(checks.get(
                    "zero invariant violations", False)),
                "digest_pinned": bool(checks.get(
                    "final digest equals static-mesh control", False)),
                "elapsed_s": elapsed,
                "platform": device.type,
            },
        }, indent=2, sort_keys=True) + "\n")
    return checks


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--short", action="store_true",
                    help="tier-1 sized campaign: 4 sessions, 2 bursts")
    ap.add_argument("--sessions", type=int, default=None)
    ap.add_argument("--chats", type=int, default=None)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None,
                    help="the device of every virtual mesh (default cuda:0)")
    ap.add_argument("--out", default=None,
                    help="write the report line as JSON to this path")
    args = ap.parse_args()
    sessions = args.sessions or (4 if args.short else 12)
    chats = args.chats or (2 if args.short else 4)
    with tempfile.TemporaryDirectory() as tmpdir:
        checks = run(tmpdir, seed=args.seed, sessions=sessions,
                     chats=chats, out_path=args.out, device=args.device)
    failed = [name for name, ok in checks.items() if not ok]
    for name, ok in checks.items():
        print(f"  {'ok  ' if ok else 'FAIL'} {name}")
    if failed:
        print(f"RESHARD SMOKE FAILED: {failed}")
        return 1
    print(f"RESHARD SMOKE OK: {len(checks)} checks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
