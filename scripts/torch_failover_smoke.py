#!/usr/bin/env python
"""Supervised session-failover smoke on the PyTorch port: kill a game
mid-combat under link faults and prove the blip is bounded and lossless.

    python scripts/torch_failover_smoke.py                 # worlds on cuda
    python scripts/torch_failover_smoke.py --device cpu
    python scripts/torch_failover_smoke.py --surge [--out PATH]

The port's copy of ``scripts/failover_smoke.py``: the same scenarios, the
same checks under the same names, with every game's world on ``device``
(``None`` = ``"cuda"``; without a card that raises).

Default scenario: boots a two-game LocalCluster where each game owns its
OWN write-behind WAL + checkpoint dirs over one shared store, logs two
clients into Game1, drives movement/chat, wedges Game1's store flusher
(StoreFaults.fail_first) so saves stay WAL-only, snapshots both players,
then HARD-kills Game1 (crash path: no drain, no goodbye) while the
clients keep talking.  Asserts:

- the world's FailoverDriver re-homes both sessions onto the survivor,
  reconstructing each blob from the dead game's WAL suffix (basis
  "wal" — the store never saw the final save);
- recovered player state is bit-identical to the pre-kill snapshot
  (WAL bytes) and property-identical on the adopting game;
- client frames sent into the outage PARK at the proxy and replay in
  order after the re-point — chat echoes arrive complete and ordered,
  ``nf_failover_dropped_total`` stays 0, zero sessions drop;
- clients receive the explicit REHOMING switch notice;
- the master surfaces the failover block (pending/lag) on /json.

The kill and re-home (:func:`kill_rehome`) is the one copy of that part
of the scenario: ``chip_smoke.py``'s cluster phase runs it over its own
cluster and 24 sessions.

--surge: one client ping-pongs between the two games via the real
``switch_server`` protocol under an active FaultPlan, with the flight
recorder journaling Game1.  Measures completed switches/sec and
digest-pins the run via offline replay; ``--out PATH`` writes the
report line (nothing is written into ``bench_runs/``).

Exits 0 on success.
"""

from __future__ import annotations

import json
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

AFTER_CHATS = 5  # numbered chats each client sends into the outage


def _login(cluster, cli, game_id: int, role: str, pump) -> bool:
    """The full reference login pipeline (login -> world -> proxy ->
    game); each hop gates on its ack and fails fast with the stage name
    on timeout."""
    steps = [
        (lambda: cli.connect("127.0.0.1", cluster.login.config.port),
         "login connect", lambda: cli.connected),
        (cli.login, "login ack", lambda: cli.logged_in),
        (cli.request_world_list, "world list", lambda: cli.worlds),
        (lambda: cli.connect_world(cli.worlds[0].server_id),
         "world grant", lambda: cli.world_grant is not None),
        (cli.connect_proxy, "proxy connect", lambda: cli.connected),
        (cli.verify_key, "key verify", lambda: cli.key_verified),
        (lambda: cli.select_server(game_id),
         "server select", lambda: cli.server_selected),
        (lambda: cli.create_role(role), "role list", lambda: cli.roles),
        (lambda: cli.enter_game(role), "enter game",
         lambda: cli.entered),
    ]
    for action, stage, cond in steps:
        action()
        if not pump(cond):
            print(f"  login stalled for {cli.account} at: {stage}")
            return False
    return True


def _session_of(game, account: str):
    for sess in game.sessions.values():
        if sess.account == account and sess.guid is not None:
            return sess
    return None


def _chat_positions(log, prefix: str):
    """Indices of this client's own numbered echoes, in arrival order."""
    return [i for i, (_who, text) in enumerate(log)
            if text.startswith(prefix)]


def _get_json(cluster, stir, port: int, path: str) -> dict:
    """GET a JSON page from an HttpServer of the cluster while a thread
    pumps the cluster and the clients."""
    stop = threading.Event()

    def _bg():
        while not stop.is_set():
            cluster.execute()
            stir()
            time.sleep(0.002)

    th = threading.Thread(target=_bg, daemon=True)
    th.start()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5
        ) as r:
            return json.loads(r.read().decode())
    finally:
        stop.set()
        th.join(timeout=2)


def kill_rehome(cluster, game1, game2, clients, kv, wal_dir, pump, stir,
                after_chats: int = AFTER_CHATS, golds=None, checks=None):
    """The kill and re-home for ``clients`` entered on ``game1`` (a
    LocalCluster whose games have their own WAL and checkpoint dirs over
    the store ``kv``, Game1's store flusher wedged): distinct saves
    staged to the WAL in one pump step with their snapshots, a
    checkpoint, a HARD kill, numbered chats into the outage, and the
    world's re-home of every session onto ``game2``.  ``pump(cond, t)``
    pumps the cluster and the clients until ``cond()`` or ``t`` seconds;
    ``stir()`` pumps the clients once.  Each client's player gets Level 9
    and its Gold from ``golds`` (default ``1000 + 37 * i``) before the
    save.  Adds its checks to ``checks`` and returns ``(checks, info)``: the blip (kill to last re-home), the
    parked frames, the bases and the ghost re-homes."""
    from noahgameframe_tpu_torch.net.defines import SwitchNoticeCode
    from noahgameframe_tpu_torch.persist.codec import snapshot_object
    from noahgameframe_tpu_torch.persist.writebehind import read_peer_wal

    checks = {} if checks is None else checks
    proxy, world, master = cluster.proxy, cluster.world, cluster.master
    sess = {cli.account: _session_of(game1, cli.account) for cli in clients}
    checks["sessions bound on game 6"] = all(s is not None for s in sess.values())
    if not checks["sessions bound on game 6"]:
        # no point driving the kill without the precondition — report
        # the failed checks instead of tracebacking on a missing guid
        return checks, {"sessions": len(clients)}
    # --- freeze: distinct durable state per player, staged to the WAL in
    # the same pump step as the snapshot (no tick between -> the save
    # bytes are bit-identical to the snapshot bytes)
    k1, agent1 = game1.kernel, game1.data_agent
    pre, pre_blob, keys = {}, {}, {}
    for i, cli in enumerate(clients):
        s = sess[cli.account]
        k1.set_property(s.guid, "Gold", 1000 + 37 * i if golds is None else golds[i])
        k1.set_property(s.guid, "Level", 9)
        pre[cli.account] = {p: k1.get_property(s.guid, p)
                            for p in ("Name", "Level", "Gold")}
        pre_blob[cli.account] = snapshot_object(k1.store, k1.state, s.guid,
                                                agent1.flags)
        agent1.save(s.guid)
        keys[cli.account] = agent1._key_of(s.guid)
    game1.checkpoint_now()  # ckpt + WAL barrier (fsync)

    # the WAL's staged bytes ARE the snapshot — the recovery basis
    view = read_peer_wal(wal_dir)
    checks["WAL holds bit-identical pre-kill blobs"] = all(
        view.pending.get(keys[acc]) == pre_blob[acc] for acc in keys)
    checks["store never saw the final saves"] = all(
        kv.get(keys[acc]) != pre_blob[acc] for acc in keys)

    # --- CRASH: hard kill (no session saves, no persist drain)
    selfids = {(s.guid.head, s.guid.data) for s in sess.values()}
    done0 = len(world.failover.completed)
    t = {"rehomed": None, "max_pending": 0}

    def watch():
        t["max_pending"] = max(t["max_pending"], world.failover.pending_count())
        if t["rehomed"] is None and sum(
                1 for e in world.failover.completed[done0:]
                if tuple(e["selfid"]) in selfids) >= len(clients):
            t["rehomed"] = time.perf_counter()

    dead = game1.config.server_id
    t_kill = time.perf_counter()
    cluster.kill_role(game1.config.name, hard=True)
    # wait until the proxy's link has actually dropped before the
    # clients talk again — a frame written into the dying socket would
    # be lost upstream of the parking buffer
    checks["proxy saw the link drop"] = pump(
        lambda: watch() or dead not in proxy.games.connected_servers(), 10.0)

    # --- clients keep talking INTO the outage: numbered chats that must
    # park, replay in order, and echo back complete.  The first chat goes
    # out NOW — before the next pump round — so it reaches the proxy
    # while the binding is dead but the survivor's re-point has not
    # landed yet (roles pump server conns first, game links second, so a
    # same-round chat parks)
    for cli in clients:
        cli.chat(f"after-{cli.account}-0")
    stir()
    sent = [1]

    def mine(cli):
        return _chat_positions(cli.chat_log, f"after-{cli.account}-")

    def settled():
        watch()
        if sent[0] < after_chats:
            for cli in clients:
                cli.chat(f"after-{cli.account}-{sent[0]}")
            sent[0] += 1
            return False
        return (all(_session_of(game2, cli.account) is not None for cli in clients)
                and world.failover.pending_count() == 0
                and proxy.parking.depth() == 0
                and all(len(mine(cli)) >= after_chats for cli in clients))

    checks["sessions re-homed to survivor"] = pump(settled, 60.0)
    checks["failover was observable while pending"] = t["max_pending"] > 0

    # --- ordered, lossless replay
    for cli in clients:
        name, prefix = cli.account, f"after-{cli.account}-"
        texts = [t for _w, t in cli.chat_log if t.startswith(prefix)]
        # dedupe (the chaos link dups messages) but keep first-seen
        # order: replay must deliver 0..N-1 ascending
        first_seen = list(dict.fromkeys(texts))
        checks[f"{name} chat replayed complete + in order"] = (
            first_seen == [f"{prefix}{i}" for i in range(after_chats)]
        )
    checks["frames were actually parked"] = proxy.parking.parked_total > 0
    checks["nf_failover_dropped_total == 0"] = (
        proxy.parking.dropped_total == 0
    )

    # --- recovered state: new guid on the survivor, same player
    k2 = game2.kernel
    for acc in pre:
        s2 = _session_of(game2, acc)
        got = None if s2 is None else {p: k2.get_property(s2.guid, p)
                                       for p in ("Name", "Level", "Gold")}
        checks[f"{acc} state recovered on game 16"] = got == pre[acc]
        checks[f"{acc} rebound to game 16"] = (
            s2 is not None
            and int(k2.get_property(s2.guid, "GameID")) == game2.config.server_id
        )
    new = [e for e in world.failover.completed[done0:]
           if tuple(e["selfid"]) in selfids]
    # the world also re-homes a player that switched away from the dead
    # game earlier (a ghost: the origin never sends an offline notice for
    # a switched player, so its bind info stays; the JAX package does the
    # same)
    ghosts = len(world.failover.completed) - done0 - len(new)
    bases = sorted({e["basis"] for e in new})
    checks["recovery basis was the WAL suffix"] = (
        len(new) == len(clients) and bases == ["wal"]
    )
    reg = world.telemetry.registry
    checks["failover counters balanced"] = (
        reg.value("nf_failover_initiated_total")
        == reg.value("nf_failover_completed_total")
        >= len(clients) + ghosts
    )
    checks["clients got the REHOMING notice"] = all(
        any(int(n.code) == int(SwitchNoticeCode.REHOMING)
            for n in cli.switch_notices)
        for cli in clients
    )
    checks["zero session drops"] = (
        all(cli.entered for cli in clients)
        and proxy.parking.dropped_disconnect == 0
    )

    # --- master surfaces the failover block on /json.  The block rides
    # the world's heartbeat ext, so the master's view lags the re-home by
    # up to one report interval — pump until the fresh report lands
    # instead of sampling a possibly-stale one
    def _fo_settled():
        fo = master.servers_status().get("failover", {})
        return bool(fo) and all(
            v.get("pending") == 0 for v in fo.values() if "pending" in v
        )

    checks["master /json failover block"] = (
        _fo_settled() or pump(_fo_settled, 10.0)
    )
    page = _get_json(cluster, stir, master.http.port, "/json")
    checks["/json serves failover block over HTTP"] = "failover" in page
    info = {"sessions": len(clients),
            "blip_ms": None if t["rehomed"] is None
            else (t["rehomed"] - t_kill) * 1e3,
            "parked_frames": proxy.parking.parked_total, "bases": bases,
            "max_pending": t["max_pending"], "ghost_rehomes": ghosts}
    return checks, info


def fault_plan(seed: int):
    """Faults from the start: mild duplication + delay on the proxy's game
    links and the dying game's world link, and a WEDGED store flusher
    under Game1 — every flush fails, so the final saves live only in the
    WAL and recovery MUST take the WAL basis."""
    from noahgameframe_tpu_torch.net.chaos import (
        FaultPlan,
        LinkFaults,
        StoreFaults,
    )

    return FaultPlan(
        seed=seed,
        links={
            # the dying game's links can reorder freely (delay); the
            # SURVIVOR path gets dup-only faults — a delaying link
            # downstream of the parking buffer would reorder frames the
            # replay just put back in order, and that is the transport's
            # doing, not the failover's
            "proxy5.games->6": LinkFaults(dup=0.05, delay=0.05,
                                          delay_polls=2),
            "proxy5.games->16": LinkFaults(dup=0.02),
            "game6.world": LinkFaults(dup=0.02),
        },
        stores={"game6.store": StoreFaults(fail_first=1_000_000)},
    )


def run(tmpdir, seed: int = 7, device=None) -> dict:
    """Run the kill/re-home scenario with both games' worlds on ``device``
    (``None`` = ``"cuda"``); returns {check name: bool}."""
    from noahgameframe_tpu_torch.client import GameClient
    from noahgameframe_tpu_torch.core.device import resolve_device
    from noahgameframe_tpu_torch.net.roles.cluster import LocalCluster
    from noahgameframe_tpu_torch.persist.agent import PlayerDataAgent
    from noahgameframe_tpu_torch.persist.kv import MemoryKV

    device = resolve_device(device)
    tmp = Path(tmpdir)
    kv = MemoryKV()
    checks: dict = {}
    cluster = LocalCluster(
        http_port=0,
        n_games=2,
        lease_suspect_seconds=1.0,
        lease_down_seconds=2.0,
        # autosave/checkpoint timers OFF: the explicit save below must be
        # the only staged write, or bit-identity would race the timer
        game_kwargs={
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
    ada, bob = GameClient("ada"), GameClient("bob")

    def stir():
        ada.execute()
        bob.execute()

    def pump(cond, t=20.0):
        return cluster.pump_until(cond, extra=stir, timeout=t)

    try:
        cluster.start(timeout=30)
        cluster.apply_chaos(fault_plan(seed))
        checks["cluster wired"] = True
        ok_a = _login(cluster, ada, game1.config.server_id, "Ada", pump)
        ok_b = _login(cluster, bob, game1.config.server_id, "Bob", pump)
        checks["both clients entered game 6"] = ok_a and ok_b

        # --- mid-combat activity: movement + chat on the doomed game
        step = [0]

        def fight():
            stir()
            step[0] += 1
            if step[0] % 20 == 0:
                ada.move_to(float(step[0] % 300), 50.0)
                bob.move_to(float(step[0] % 300), 80.0)
            if step[0] == 50:
                ada.chat("warm-a")
                bob.chat("warm-b")

        checks["pre-kill chat round-tripped"] = cluster.pump_until(
            lambda: (any(t == "warm-a" for _w, t in ada.chat_log)
                     and any(t == "warm-b" for _w, t in bob.chat_log)),
            extra=fight, timeout=20,
        )
        kill_rehome(cluster, game1, game2, [ada, bob], kv, tmp / "wal1",
                    pump, stir, golds=(4242, 777), checks=checks)
    finally:
        ada.close()
        bob.close()
        cluster.shut()
    return checks


def surge(tmpdir, seed: int = 11, rounds: int = 40,
          out_path=None, device=None) -> dict:
    """Handoff surge: ping-pong one session between the two games through
    the full switch protocol under an active FaultPlan, with Game1
    journaling, both worlds on ``device`` (``None`` = ``"cuda"``).
    Returns checks; writes the report line when ``out_path`` is given."""
    from noahgameframe_tpu_torch.client import GameClient
    from noahgameframe_tpu_torch.core.device import resolve_device
    from noahgameframe_tpu_torch.net.chaos import FaultPlan, LinkFaults
    from noahgameframe_tpu_torch.net.roles.cluster import LocalCluster
    from noahgameframe_tpu_torch.replay import make_offline_role, replay_journal

    device = resolve_device(device)
    jdir = Path(tmpdir) / "journal"
    checks: dict = {}
    cluster = LocalCluster(
        http_port=0,
        n_games=2,
        game_kwargs_by_name={"Game1": {"journal_dir": jdir}},
        device=device,
    )
    # the replay's substrate (the stock world on the same device) is built
    # before the cluster's clock starts
    replayer = make_offline_role(device=device)
    plan = FaultPlan(
        seed=seed,
        links={"proxy5.games": LinkFaults(dup=0.01, delay=0.02,
                                          delay_polls=2)},
    )
    cli = GameClient("surger")
    switches = 0
    elapsed = 0.0
    try:
        cluster.start(timeout=30)
        cluster.apply_chaos(plan)

        def pump(cond, t=20.0):
            return cluster.pump_until(cond, extra=cli.execute, timeout=t)

        ok = _login(cluster, cli, 6, "Surge", pump)
        checks["client entered game 6"] = ok
        by_id = {g.config.server_id: g for g in cluster.games}
        here = 6
        t0 = time.monotonic()
        for _ in range(rounds):
            target = 16 if here == 6 else 6
            sess = _session_of(by_id[here], "surger")
            if sess is None:
                break
            by_id[here].switch_server(sess.guid, target)
            if not pump(lambda: _session_of(by_id[target], "surger")
                        is not None, t=15.0):
                break
            here = target
            switches += 1
        elapsed = time.monotonic() - t0
        checks["all switches completed"] = switches == rounds
        checks["proxy re-pointed with the session"] = (
            _session_of(by_id[here], "surger") is not None
        )
    finally:
        cli.close()
        cluster.shut()

    # digest pin: the journaled run must replay bit-identically
    try:
        rep = replay_journal(jdir, role=replayer)
    finally:
        replayer.shut()
    checks["replay digest-identical under surge"] = rep.ok
    checks["replayed ticks"] = rep.ticks_replayed > 0

    rate = switches / elapsed if elapsed > 0 else 0.0
    if out_path is not None:
        Path(out_path).write_text(json.dumps({
            "metric": "handoff_switches_per_sec",
            "value": round(rate, 2),
            "unit": "switches/s",
            "detail": {
                "switches": switches,
                "elapsed_s": round(elapsed, 4),
                "seed": seed,
                "faults": {"proxy5.games": {"dup": 0.01, "delay": 0.02}},
                "replay_ok": rep.ok,
                "ticks_replayed": rep.ticks_replayed,
                "platform": device.type,
            },
        }) + "\n")
    print(f"  surge: {switches} switches in {elapsed:.2f}s "
          f"({rate:.1f}/s), replay ok={rep.ok}")
    return checks


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--surge", action="store_true",
                    help="run the handoff-surge scenario")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=40,
                    help="surge round trips (2 switches each)")
    ap.add_argument("--device", default=None, help="the worlds' device (default cuda)")
    ap.add_argument("--out", default=None,
                    help="with --surge, write the report line as JSON to this path")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmpdir:
        if args.surge:
            checks = surge(tmpdir, seed=args.seed or 11, rounds=args.rounds,
                           out_path=args.out, device=args.device)
        else:
            checks = run(tmpdir, seed=args.seed or 7, device=args.device)
    failed = [name for name, ok in checks.items() if not ok]
    for name, ok in checks.items():
        print(f"  {'ok  ' if ok else 'FAIL'} {name}")
    if failed:
        print(f"FAILOVER SMOKE FAILED: {failed}")
        return 1
    print(f"FAILOVER SMOKE OK: {len(checks)} checks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
