#!/usr/bin/env python
"""Game-day drill on the PyTorch port: kill a game DURING a hard store
outage DURING a session surge, heal, and prove the whole reliability
stack — failover + WAL recovery + journal replay — converges
bit-identically to a fault-free control with zero dropped sessions.

    python scripts/torch_gameday_smoke.py                       # 40 sessions, cuda
    python scripts/torch_gameday_smoke.py --short --device cpu  # tier-1 size

The port's copy of ``scripts/gameday_smoke.py``: the same campaign, the
same checks under the same names.  The composition is driven by a
:class:`drill.DrillRunner` over a seeded, tick-indexed
:class:`drill.Campaign`, with the full invariant library sampled every
pump:

    tick   0  surge active (N clients logged into Game1, chatting)
    tick   5  hard store outage under Game1 (flusher wedged — every
              flush fails, saves live only in the WAL)
    tick  10  final saves staged; checkpoint barrier fsyncs the WAL
    tick  15  assert the WAL holds the staged blobs, the store doesn't
    tick  20  Game1 HARD-killed (crash path: no drain, no goodbye)
    ...       clients keep chatting into the outage: frames park at the
              proxy, the world re-homes all N sessions onto Game2 from
              the dead game's WAL suffix (basis "wal")
    tick 120  store outage heals
    tick 125  Game1 revived from its (checkpoint, WAL) pair

Asserts: every session re-homed with zero drops and ordered chat
replay, every invariant clean for the whole run, the revived world's
NPC banks + tick bit-identical to a fault-free control driven the same
number of ticks, and Game2's journal (which recorded the entire surge
intake) replays digest-clean offline.

A :class:`Recipe` builds the worlds (Game1 live, its revive substrate
and its control, and Game2) and carries the role kwargs and the lease
cadence; :data:`REGEN` is the JAX script's regen-only recipe, and a
caller passes another to run the same campaign at a real size.
``--out PATH`` writes the report line (re-home rate, replay digest,
drill verdict) as JSON.  Exits 0 on success.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

NPCS = 8
EXTRA_TICKS = 20
KILL_TICK = 20
HEAL_TICK = 120
REVIVE_TICK = 125


def build_world(seed: int, player_capacity: int = 64, device=None):
    """Deterministic regen-only world (the chaos-smoke recipe, with a
    player bank big enough for the whole surge)."""
    from noahgameframe_tpu_torch.game.defines import (
        COMM_PROPERTY_RECORD,
        PropertyGroup,
    )
    from noahgameframe_tpu_torch.game.world import GameWorld, WorldConfig

    w = GameWorld(WorldConfig(
        npc_capacity=64, player_capacity=player_capacity, seed=seed,
        combat=False, movement=False, regen=True, middleware=False,
        regen_period_s=0.1,
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
    return w


@dataclasses.dataclass(frozen=True)
class Recipe:
    """What the campaign runs over.  ``world(seed, player_capacity,
    device)`` builds each world: Game1's (live, revive substrate and
    control from ``seed``) and Game2's (from ``seed + 1000``).
    ``role_kwargs`` go to both games and to the offline role that replays
    Game2's journal.  The lease cadence is the cluster's: a recipe whose
    pump rounds are long needs leases sized above them."""

    world: Callable = build_world
    role_kwargs: dict = dataclasses.field(default_factory=dict)
    keepalive_s: float = 0.2
    lease_suspect_s: float = 2.0
    lease_down_s: float = 4.0


REGEN = Recipe()


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


def _warm_paths(seed: int, capacity: int, device) -> None:
    """Run the player lifecycle once on a throwaway regen world on the
    campaign's device BEFORE the cluster is under its lease clock.  The
    port compiles nothing per shape, but the first create, snapshot and
    restore on a device pay its lazy set-up (kernel modules, allocator
    pools), and the CUDA kernels are built once per process: done inside
    the pump, either would stall it past a lease."""
    import torch

    from noahgameframe_tpu_torch.persist.agent import PlayerDataAgent
    from noahgameframe_tpu_torch.persist.codec import (
        apply_snapshot,
        snapshot_object,
    )
    from noahgameframe_tpu_torch.persist.kv import MemoryKV

    if torch.device(device).type == "cuda":
        from noahgameframe_tpu_torch.ops import stencil_cuda

        stencil_cuda.library()
    w = build_world(seed + 2000, player_capacity=capacity, device=device)
    k = w.kernel
    flags = PlayerDataAgent(MemoryKV()).flags
    guid = k.create_object(
        "Player",
        {"Account": "_warm", "Name": "_warm", "GameID": 0},
        scene=1, group=1,
    )
    k.set_property(guid, "Gold", 1)
    if w.properties is not None:
        w.properties.full_hp_mp(guid)
        w.properties.full_sp(guid)
    blob = snapshot_object(k.store, k.state, guid, flags)
    k.state = apply_snapshot(k.store, k.state, guid, blob)
    k.destroy_object(guid)
    _drive_control(w, 3)


def _session_of(game, account: str):
    for sess in game.sessions.values():
        if sess.account == account and sess.guid is not None:
            return sess
    return None


def _first_seen(log, prefix: str):
    """This client's own numbered echoes, deduped (chaos dups) but in
    first-seen order — replay must deliver 0..N-1 ascending."""
    return list(dict.fromkeys(
        t for _w, t in log if t.startswith(prefix)
    ))


def _batch_login(cluster, clients, game_id: int, pump,
                 timeout: float = 30.0) -> bool:
    """The full reference login pipeline for N clients in lockstep:
    every client runs stage k, then one pump gates on ALL of them
    passing — a surge logs in in stage-time, not N × pipeline-time."""
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


def run(tmpdir, seed: int = 7, sessions: int = 40, chats: int = 5,
        out_path=None, device=None, recipe: Optional[Recipe] = None) -> dict:
    """Run the flagship campaign on ``device`` (``None`` = ``"cuda"``);
    returns {check name: bool}."""
    from noahgameframe_tpu_torch.client import GameClient
    from noahgameframe_tpu_torch.core.device import resolve_device
    from noahgameframe_tpu_torch.drill import (
        Campaign,
        DrillRunner,
        default_invariants,
    )
    from noahgameframe_tpu_torch.net.chaos import (
        FaultPlan,
        LinkFaults,
        StoreFaults,
    )
    from noahgameframe_tpu_torch.net.roles.cluster import LocalCluster
    from noahgameframe_tpu_torch.persist.agent import PlayerDataAgent
    from noahgameframe_tpu_torch.persist.checkpoint import _flatten_state
    from noahgameframe_tpu_torch.persist.codec import snapshot_object
    from noahgameframe_tpu_torch.persist.kv import MemoryKV
    from noahgameframe_tpu_torch.persist.writebehind import read_peer_wal
    from noahgameframe_tpu_torch.replay import replay_journal

    device = resolve_device(device)
    recipe = REGEN if recipe is None else recipe
    t_run = time.monotonic()
    tmp = Path(tmpdir)
    kv = MemoryKV()
    checks: dict = {}
    capacity = max(64, sessions + 8)

    def world_of(world_seed: int):
        return recipe.world(world_seed, player_capacity=capacity,
                            device=device)

    # every world the campaign needs is built before the lease clock
    # starts: a build inside the pump would stall it
    _warm_paths(seed, capacity, device)
    substrate = world_of(seed)
    control = world_of(seed)
    timings = {"max_pump_round_s": 0.0}
    load = substrate.load

    def timed_load(path):
        timings["checkpoint_load"] = out = load(path)
        return out

    substrate.load = timed_load
    jdir2 = tmp / "journal2"
    cluster = LocalCluster(
        http_port=0,
        n_games=2,
        game_world=world_of(seed),
        keepalive_seconds=recipe.keepalive_s,
        lease_suspect_seconds=recipe.lease_suspect_s,
        lease_down_seconds=recipe.lease_down_s,
        game_kwargs={
            **recipe.role_kwargs,
            "autosave_seconds": 3600.0,
            "checkpoint_seconds": 3600.0,
            "persist_drain_timeout": 0.3,
        },
        game_kwargs_by_name={
            "Game1": {
                "data_agent": PlayerDataAgent(kv),
                "persist_store": kv,
                "persist_wal_dir": tmp / "wal1",
                "checkpoint_dir": tmp / "ckpt1",
            },
            "Game2": {
                "world": world_of(seed + 1000),
                "journal_dir": jdir2,
                "data_agent": PlayerDataAgent(kv),
                "persist_store": kv,
                "persist_wal_dir": tmp / "wal2",
                "checkpoint_dir": tmp / "ckpt2",
            },
        },
        world_kwargs={"recover_store": kv},
        device=device,
    )
    game1, game2 = cluster.games[0], cluster.games[1]
    proxy, world, master = cluster.proxy, cluster.world, cluster.master
    clients = [GameClient(f"p{i:02d}") for i in range(sessions)]
    execute = cluster.execute

    def timed_execute():
        t0 = time.monotonic()
        execute()
        timings["max_pump_round_s"] = max(timings["max_pump_round_s"],
                                          time.monotonic() - t0)

    cluster.execute = timed_execute

    def stir():
        for c in clients:
            c.execute()

    def pump(cond, t=30.0):
        return cluster.pump_until(cond, extra=stir, timeout=t)

    def store_probe():
        out = {}
        for key in kv.keys("__wb__:*"):
            raw = kv.get(key)
            if raw is None:
                continue
            seq, _, tick = raw.decode("ascii", "replace").partition(":")
            out[f"store:{key}"] = (int(seq), int(tick or 0))
        return out

    # staged-save bookkeeping shared between campaign call steps
    expected: dict = {}
    pre_blob: dict = {}
    save_keys: dict = {}
    stage_flags = {"saves": False, "wal": False, "store_clean": False}

    def stage_saves(_runner) -> None:
        k1, agent1 = game1.kernel, game1.data_agent
        ok = True
        for i, cli in enumerate(clients):
            sess = _session_of(game1, cli.account)
            if sess is None:
                ok = False
                continue
            k1.set_property(sess.guid, "Gold", 1000 + i)
            k1.set_property(sess.guid, "Level", 5)
            expected[cli.account] = {
                p: k1.get_property(sess.guid, p)
                for p in ("Name", "Level", "Gold")
            }
            pre_blob[cli.account] = snapshot_object(
                k1.store, k1.state, sess.guid, agent1.flags
            )
            save_keys[cli.account] = agent1._key_of(sess.guid)
            agent1.save(sess.guid)
        t0 = time.monotonic()
        game1.checkpoint_now()  # ckpt + WAL barrier (fsync)
        timings["checkpoint_save_s"] = time.monotonic() - t0
        # host state no checkpoint carries (the JAX package does not
        # either): the revive substrate takes the killed world's bucket
        # boost, as a control ticked from the start reaches it too.  A
        # real hard kill loses it, so the report line says it was carried
        combat = game1.game_world.combat
        if combat is not None:
            substrate.combat._bucket_boost = combat._bucket_boost
            timings["revive_bucket_boost_carried"] = int(combat._bucket_boost)
        stage_flags["saves"] = ok

    def wal_check(_runner) -> None:
        view = read_peer_wal(tmp / "wal1")
        stage_flags["wal"] = bool(pre_blob) and all(
            view.pending.get(save_keys[acc]) == pre_blob[acc]
            for acc in pre_blob
        )
        # the store is wedged: the final saves must NOT have reached it
        stage_flags["store_clean"] = all(
            kv.get(save_keys[acc]) != pre_blob[acc] for acc in pre_blob
        )

    campaign = (
        Campaign("gameday", seed=seed)
        .add(0, "note", label="surge active")
        .add(5, "store_faults", label="hard store outage under Game1",
             pattern="game6.store",
             faults=StoreFaults(fail_first=1_000_000_000))
        .add(10, "call", label="stage final saves into the WAL",
             fn=stage_saves)
        .add(15, "call", label="WAL holds the blobs, store does not",
             fn=wal_check)
        .add(KILL_TICK, "kill_role",
             label="kill Game1 mid-outage mid-surge",
             role="Game1", hard=True)
        .add(HEAL_TICK, "heal", label="store outage heals",
             pattern="game6.store")
        .add(REVIVE_TICK, "revive_role",
             label="revive Game1 from (ckpt, WAL)", name="Game1",
             world_factory=lambda: substrate, resume=True)
    )

    rehome_elapsed = 0.0
    rep = None
    report = None
    try:
        cluster.start(timeout=120)
        # mild link chaos from the start: the dying game's links can
        # reorder freely; the SURVIVOR path is dup-only (a delaying link
        # downstream of the parking buffer would reorder frames the
        # replay just put back in order — transport's doing, not ours)
        cluster.apply_chaos(FaultPlan(
            seed=seed,
            links={
                "proxy5.games->6": LinkFaults(dup=0.05, delay=0.05,
                                              delay_polls=2),
                "proxy5.games->16": LinkFaults(dup=0.02),
                "game6.world": LinkFaults(dup=0.02),
            },
        ))
        checks["cluster wired under chaos"] = True
        # stage timeouts scale with the surge
        stage_t = 30.0 + 3.0 * sessions
        # log in by squads: a single 40-wide enter wave can starve the
        # game's keepalive reports past the lease window, and the master
        # would "crash" a healthy game
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

        # ---- the drill proper: campaign + invariants, sampled per pump
        runner = DrillRunner(
            cluster, campaign,
            invariants=default_invariants(store_probe=store_probe),
        )
        sent = [0]
        t_kill = [0.0]
        t_done = [0.0]

        def surge_extra():
            stir()
            if runner.tick <= KILL_TICK:
                return
            if t_kill[0] == 0.0:
                # don't talk into the dying socket: frames sent before
                # the proxy sees the drop are lost upstream of parking
                if 6 in proxy.games.connected_servers():
                    return
                t_kill[0] = time.monotonic()
            if sent[0] < chats:
                for c in clients:
                    c.chat(f"after-{c.account}-{sent[0]}")
                sent[0] += 1

        def rehomed():
            done = (
                sent[0] >= chats
                and world.failover.pending_count() == 0
                and proxy.parking.depth() == 0
                and all(_session_of(game2, c.account) is not None
                        for c in clients)
                and all(len(_first_seen(c.chat_log,
                                        f"after-{c.account}-")) >= chats
                        for c in clients)
            )
            if done and t_done[0] == 0.0:
                t_done[0] = time.monotonic()
            return done

        checks["all sessions re-homed, parked frames drained"] = (
            runner.pump_until(rehomed, extra=surge_extra,
                              timeout=60.0 + 3.0 * sessions)
        )
        if not checks["all sessions re-homed, parked frames drained"]:
            on2 = sum(1 for c in clients
                      if _session_of(game2, c.account) is not None)
            print(f"  re-home stalled: tick={runner.tick} sent={sent[0]}"
                  f" on_game2={on2}/{sessions}"
                  f" pending={world.failover.pending_count()}"
                  f" parked={proxy.parking.depth()}"
                  f" chats_min={min(len(_first_seen(c.chat_log, f'after-{c.account}-')) for c in clients)}")
        rehome_elapsed = max(0.0, t_done[0] - t_kill[0])
        checks["final saves staged for every session"] = (
            stage_flags["saves"])
        checks["WAL held bit-identical pre-kill blobs"] = (
            stage_flags["wal"])
        checks["store never saw the final saves"] = (
            stage_flags["store_clean"])

        # the campaign must have run to completion (heal + revive fired)
        checks["campaign fully fired"] = runner.pump_until(
            lambda: runner.steps_remaining == 0,
            extra=surge_extra, timeout=30,
        )

        # ---- ordered, lossless replay per client
        checks["chats replayed complete + in order (all clients)"] = all(
            _first_seen(c.chat_log, f"after-{c.account}-")
            == [f"after-{c.account}-{i}" for i in range(chats)]
            for c in clients
        )
        checks["zero parked frames dropped"] = (
            proxy.parking.dropped_total == 0)
        checks["every client heard REHOMING"] = all(
            any(int(n.code) == 1 for n in c.switch_notices)
            for c in clients
        )

        # ---- recovery basis + counter bank
        done_entries = world.failover.completed[-sessions:]
        checks["every re-home used the WAL basis"] = (
            len(done_entries) >= sessions
            and all(e["basis"] == "wal" for e in done_entries)
        )
        reg = world.telemetry.registry
        checks["failover counters balanced"] = (
            reg.value("nf_failover_initiated_total") == float(sessions)
            and reg.value("nf_failover_completed_total") == float(sessions)
        )
        k2 = game2.kernel

        def _props_match(cli) -> bool:
            sess = _session_of(game2, cli.account)
            if sess is None:
                return False
            return {
                p: k2.get_property(sess.guid, p)
                for p in ("Name", "Level", "Gold")
            } == expected.get(cli.account)

        checks["recovered state property-identical on survivor"] = all(
            _props_match(c) for c in clients
        )

        # ---- revived Game1 converges to the fault-free control
        revived = cluster.role_by_name("Game1")
        target = revived.kernel.tick_count + EXTRA_TICKS
        checks["revived game ticking"] = runner.pump_until(
            lambda: revived.kernel.tick_count >= target
            and cluster.wired(),
            extra=surge_extra, timeout=60,
        )
        _drive_control(control, revived.kernel.tick_count)
        a = _flatten_state(revived.kernel.state)
        b = _flatten_state(control.kernel.state)
        npc_keys = [key for key in b if key.startswith("c/NPC/")]
        checks["world bit-identical to fault-free control"] = (
            int(a["tick"]) == int(b["tick"])
            and bool(npc_keys)
            and all(np.array_equal(a[key], b[key]) for key in npc_keys)
        )

        # ---- the drill's own verdicts
        report = runner.report()
        checks["all invariants sampled"] = all(
            report.checks.get(inv.name, 0) > 0
            for inv in runner.invariants
        )
        checks["zero invariant violations"] = report.clean
        if not report.clean:
            for v in report.violations[:10]:
                print(f"    violation @tick {v.tick} [{v.invariant}] "
                      f"{v.detail}")
        status = master.servers_status()
        checks["/json drill block live"] = (
            status.get("drill", {}).get("campaign") == "gameday")
        phase = (status.get("chaos", {}).get("store_phase", {})
                 .get("game6.store", {}))
        checks["/json store phase shows the healed outage"] = (
            phase.get("ops_seen", 0) > 0
            and phase.get("fail_first_remaining") == 0
            and phase.get("fails_injected", 0) > 0
        )
    finally:
        for c in clients:
            c.close()
        cluster.shut()

    # ---- digest pin: the survivor journaled the WHOLE game day
    # (surge intake, switch-ins, chat replay); it must replay clean.
    # The offline role mirrors the recorded role's non-network kwargs
    # too (a data agent binds persist flags into kernel state, so a bare
    # stock role computes a different digest trajectory)
    from noahgameframe_tpu_torch.net.defines import ServerType
    from noahgameframe_tpu_torch.net.roles.base import RoleConfig
    from noahgameframe_tpu_torch.net.roles.game import GameRole

    replay_kv = MemoryKV()
    offline = GameRole(
        RoleConfig(16, int(ServerType.GAME), "Replay", "127.0.0.1", 0,
                   targets=[]),
        world=world_of(seed + 1000),
        data_agent=PlayerDataAgent(replay_kv),
        persist_store=replay_kv,
        persist_wal_dir=tmp / "replay_wal",
        checkpoint_dir=tmp / "replay_ckpt",
        autosave_seconds=3600.0,
        checkpoint_seconds=3600.0,
        persist_drain_timeout=0.3,
        **recipe.role_kwargs,
    )
    offline.server.send_raw = lambda _conn, _msg, _body: True
    t_replay = time.monotonic()
    try:
        rep = replay_journal(jdir2, role=offline)
    finally:
        offline.shut()
    replay_s = time.monotonic() - t_replay
    checks["survivor journal replays digest-clean"] = rep.ok
    checks["survivor journal replayed ticks"] = rep.ticks_replayed > 0
    if not rep.ok:
        print(f"  {rep.summary()}")

    rate = sessions / rehome_elapsed if rehome_elapsed > 0 else 0.0
    boost = timings.get("revive_bucket_boost_carried")
    print(f"  gameday: {sessions} sessions re-homed in "
          f"{rehome_elapsed:.2f}s ({rate:.1f}/s), replay ok={rep.ok} "
          f"({rep.ticks_replayed} ticks)"
          + ("" if boost is None else
             f", revive carried the killed world's bucket boost {boost} over"))
    if out_path is not None:
        final_tick = max(rep.digests) if rep.digests else 0
        Path(out_path).write_text(json.dumps({
            "metric": "gameday_sessions_rehomed_per_sec",
            "value": rate,
            "unit": "sessions/s",
            "detail": {
                "sessions": sessions,
                "chats_per_session": chats,
                "rehome_elapsed_s": rehome_elapsed,
                "seed": seed,
                "campaign": "gameday",
                "kill_tick": KILL_TICK,
                "heal_tick": HEAL_TICK,
                "revive_tick": REVIVE_TICK,
                "drill_clean": bool(checks.get(
                    "zero invariant violations", False)),
                "drill_ticks": report.ticks if report is not None else 0,
                "violations": len(report.violations) if report is not None else -1,
                "replay_ok": bool(rep.ok),
                "ticks_replayed": int(rep.ticks_replayed),
                "replay_s": replay_s,
                "final_digest": (f"{rep.digests.get(final_tick, 0):#010x}"
                                 if rep.digests else "0x0"),
                "max_pump_round_s": timings["max_pump_round_s"],
                "checkpoint_save_s": timings.get("checkpoint_save_s"),
                "checkpoint_load": timings.get("checkpoint_load"),
                # host state outside the checkpoint, copied from the
                # killed world (None: the recipe has no combat)
                "revive_bucket_boost_carried": boost,
                "seconds": time.monotonic() - t_run,
                "platform": device.type,
            },
        }, indent=2, sort_keys=True) + "\n")
    return checks


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--short", action="store_true",
                    help="tier-1 sized campaign: 6 sessions")
    ap.add_argument("--sessions", type=int, default=None)
    ap.add_argument("--chats", type=int, default=None)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None,
                    help="the worlds' device (default cuda)")
    ap.add_argument("--out", default=None,
                    help="write the report line as JSON to this path")
    args = ap.parse_args()
    sessions = args.sessions or (6 if args.short else 40)
    chats = args.chats or (3 if args.short else 5)
    with tempfile.TemporaryDirectory() as tmpdir:
        checks = run(tmpdir, seed=args.seed, sessions=sessions,
                     chats=chats, out_path=args.out, device=args.device)
    failed = [name for name, ok in checks.items() if not ok]
    for name, ok in checks.items():
        print(f"  {'ok  ' if ok else 'FAIL'} {name}")
    if failed:
        print(f"GAMEDAY SMOKE FAILED: {failed}")
        return 1
    print(f"GAMEDAY SMOKE OK: {len(checks)} checks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
