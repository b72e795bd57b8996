#!/usr/bin/env python
"""Frame-observatory smoke on the PyTorch port: end-to-end latency
attribution over a served cluster, plus the replay-identity proof that
tracing is free of state.

    python scripts/torch_pipeline_smoke.py                 # worlds on cuda
    python scripts/torch_pipeline_smoke.py --device cpu

The port's copy of ``scripts/pipeline_smoke.py``: the same scenario, the
same checks under the same names, with the game's world and the
replay's on ``device`` (``None`` = ``"cuda"``; without a card that
raises).  The journal holds no frame-trace message (``TRACE_MSG_IDS``),
so the replay compares digest streams without them.

Boots the five-role LocalCluster with NF_TRACE_SAMPLE=1 (every session
traced) and a journaling game role, walks a GameClient through the full
login pipeline, drives movement until traced frames round-trip, and
asserts:

- FRAME_TRACE sidecars flow game → proxy → client and the acks close
  the loop (RTT + proxy-relay histograms fill on the game role);
- the StageClock waterfall (tick/harvest/interest/encode/send/other)
  sums to the frame wall time within tolerance;
- the master's /pipeline endpoint serves well-formed JSON: per-game
  stage stats + trace counters and NTP-style clock offsets;
- a multi-process Perfetto merge (game + proxy tracers, distinct pids,
  clock offsets applied) yields one well-formed chrome-trace doc;
- the journal NEVER contains a trace-sidecar event, and an offline
  replay with tracing DISABLED reproduces every per-tick state digest
  bit for bit — observability on vs off cannot change the simulation.

Exits 0 on success.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TRACED_ACKS = 3  # acked round trips before we call the loop closed


def run(tmpdir, device=None) -> dict:
    """Run the whole scenario with the worlds on ``device`` (``None`` =
    ``"cuda"``); returns {check name: bool}."""
    from noahgameframe_tpu_torch.core.device import resolve_device
    from noahgameframe_tpu_torch.client import GameClient
    from noahgameframe_tpu_torch.net.defines import TRACE_MSG_IDS
    from noahgameframe_tpu_torch.net.roles.cluster import LocalCluster
    from noahgameframe_tpu_torch.replay import make_offline_role, replay_journal
    from noahgameframe_tpu_torch.replay.journal import (
        JournalReader,
        REC_EVENT,
        decode_event,
    )
    from noahgameframe_tpu_torch.telemetry.pipeline import merge_chrome_traces

    device = resolve_device(device)
    jdir = Path(tmpdir) / "journal"
    checks = {}
    old_env = os.environ.get("NF_TRACE_SAMPLE")
    os.environ["NF_TRACE_SAMPLE"] = "1"  # read at GameRole construction
    try:
        cluster = LocalCluster(
            http_port=0, game_kwargs={"journal_dir": jdir}, device=device
        )
    finally:
        if old_env is None:
            os.environ.pop("NF_TRACE_SAMPLE", None)
        else:
            os.environ["NF_TRACE_SAMPLE"] = old_env
    game, proxy, master = cluster.game, cluster.proxy, cluster.master
    # span capture for the Perfetto merge below
    game.telemetry.tracer.enabled = True
    proxy.telemetry.tracer.enabled = True
    cli = GameClient("observer")
    try:
        cluster.start(timeout=30)
        checks["cluster wired"] = True
        cli.connect("127.0.0.1", cluster.login.config.port)

        def pump(cond, t=15.0):
            return cluster.pump_until(cond, extra=cli.execute, timeout=t)

        ok = pump(lambda: cli.connected)
        cli.login()
        ok = ok and pump(lambda: cli.logged_in)
        cli.request_world_list()
        ok = ok and pump(lambda: cli.worlds)
        cli.connect_world(cli.worlds[0].server_id)
        ok = ok and pump(lambda: cli.world_grant is not None)
        cli.connect_proxy()
        ok = ok and pump(lambda: cli.connected)
        cli.verify_key()
        ok = ok and pump(lambda: cli.key_verified)
        cli.select_server(game.config.server_id)
        ok = ok and pump(lambda: cli.server_selected)
        cli.create_role("Obs")
        ok = ok and pump(lambda: cli.roles)
        cli.enter_game("Obs")
        ok = ok and pump(lambda: cli.entered)
        checks["client entered world"] = ok

        # keep the avatar moving so every frame has diffs to flush (and
        # therefore a trace sidecar trailing the sync traffic)
        step = [0]

        def stir():
            cli.execute()
            step[0] += 1
            if step[0] % 40 == 0 and cli.entered:
                cli.move_to(float(step[0] % 500), 100.0)

        checks["trace loop closed"] = cluster.pump_until(
            lambda: game.trace_acked >= TRACED_ACKS, extra=stir, timeout=30
        )
        checks["client saw stamped sidecars"] = any(
            t["proxy_relay_ms"] is not None for t in cli.traces
        )
        checks["rtt histogram filled"] = game._trace_rtt_hist.count > 0
        checks["relay histogram filled"] = game._trace_relay_hist.count > 0
        checks["proxy counted relays"] = proxy.traces_relayed >= TRACED_ACKS
        checks["proxy per-opcode relay latency"] = bool(
            proxy.games.counters.relay_ns
        )

        # ---- the waterfall sums to the frame wall time
        ps = game.pipeline_stats()
        checks["stage clock saw frames"] = ps["frames"] > 0
        total = sum(ps["last_ms"].values())
        # exact by construction (explicit "other" bucket); rounding of
        # up to 6 stages at 4 decimals bounds the drift
        checks["waterfall sums to frame latency"] = (
            abs(total - ps["last_wall_ms"]) <= 0.01
        )
        checks["tick stage attributed"] = "tick" in ps["stages"]
        checks["encode stage attributed"] = "encode" in ps["stages"]

        # ---- /pipeline over real HTTP
        checks["heartbeats carried pipeline blob"] = cluster.pump_until(
            lambda: master.pipeline_status()["games"]
            and "frames" in (master.pipeline_status()["games"][0]
                             .get("pipeline") or {}),
            extra=cli.execute, timeout=15,
        )
        # urlopen blocks, so the cluster needs a background pump while
        # the request is in flight (same pattern as tests/test_roles.py)
        import threading
        import time as _t

        stop = threading.Event()

        def _bg():
            while not stop.is_set():
                cluster.execute()
                _t.sleep(0.002)

        th = threading.Thread(target=_bg, daemon=True)
        th.start()
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{master.http.port}/pipeline", timeout=5
            ) as r:
                pipe = json.loads(r.read().decode())
        finally:
            stop.set()
            th.join(timeout=2)
        checks["/pipeline well-formed"] = (
            isinstance(pipe.get("clock_offsets_ns"), dict)
            and isinstance(pipe.get("games"), list)
            and pipe["games"]
            and pipe["games"][0]["pipeline"]["frames"] > 0
        )
        checks["clock offsets estimated"] = any(
            k.startswith("game") for k in pipe["clock_offsets_ns"]
        )

        # ---- multi-process Perfetto merge with aligned clocks
        off = pipe["clock_offsets_ns"].get(
            f"proxy{proxy.config.server_id}", 0) / 1e3
        merged = merge_chrome_traces(
            [game.telemetry.tracer.chrome_trace(
                process_name=f"game{game.config.server_id}", pid=1),
             proxy.telemetry.tracer.chrome_trace(
                process_name=f"proxy{proxy.config.server_id}", pid=2)],
            offsets_us=[0.0, off],
        )
        evs = merged["traceEvents"]
        checks["perfetto merge well-formed"] = (
            merged.get("displayTimeUnit") == "ms"
            and all("pid" in e and "ph" in e for e in evs)
            and {e["pid"] for e in evs} == {1, 2}
        )
    finally:
        cli.close()
        cluster.shut()

    # ---- trace traffic never reaches the journal
    sidecars = sum(
        1 for rec_type, body in JournalReader(jdir)
        if rec_type == REC_EVENT and decode_event(body)[3] in TRACE_MSG_IDS
    )
    checks["journal free of trace sidecars"] = sidecars == 0

    # ---- replay with tracing OFF reproduces the traced run bit for bit
    old = os.environ.get("NF_TRACE_SAMPLE")
    os.environ["NF_TRACE_SAMPLE"] = "0"
    try:
        role = make_offline_role(device=device)
        try:
            rep = replay_journal(jdir, role=role)
        finally:
            role.shut()
    finally:
        if old is None:
            os.environ.pop("NF_TRACE_SAMPLE", None)
        else:
            os.environ["NF_TRACE_SAMPLE"] = old
    checks["replayed ticks"] = rep.ticks_replayed > 0
    checks["replay bit-identical with tracing off"] = rep.ok
    return checks


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="the worlds' device (default cuda)")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmpdir:
        checks = run(tmpdir, device=args.device)
    failed = [name for name, ok in checks.items() if not ok]
    for name, ok in checks.items():
        print(f"  {'ok  ' if ok else 'FAIL'} {name}")
    if failed:
        print(f"PIPELINE SMOKE FAILED: {failed}")
        return 1
    print(f"PIPELINE SMOKE OK: {len(checks)} checks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
