#!/usr/bin/env python
"""Cost-observatory smoke on the PyTorch port: /costbook end to end over a
served cluster.

    python scripts/torch_costbook_smoke.py                 # worlds on cuda
    python scripts/torch_costbook_smoke.py --device cpu

The port's copy of ``scripts/costbook_smoke.py``: the same scenario, the
same checks under the same names, with the game's world on ``device``
(``None`` = ``"cuda"``; without a card that raises).  Where the JAX book
records compile wall time and XLA's cost analysis, the port's records a
capture wall time and its own cost count (``telemetry/costbook.py``):
"compile wall" reads the entry's capture wall (``capture_ms_total``,
warm-up plus CUDA-graph capture) on ``cuda``, and the counted run's wall
(``last["cost_ms"]``) on the CPU, where nothing is captured.  The
memory census is ``torch.cuda``'s allocator on ``cuda`` and the world's
state tensors (``state_tensors``) on the CPU.

Boots the five-role LocalCluster, walks a GameClient through the full
login pipeline, drives movement until the serving edge has compiled its
interest entries, and asserts:

- every role serves `/costbook` (master's aggregate on its status
  server; world/login/proxy/game each on a serve_metrics() server) and
  the document is well-formed JSON with the snapshot schema;
- the game role's book covers the expected entries (kernel.step plus
  the interest/serve edge) with compile wall time and cost analysis
  recorded for each;
- `nf_recompiles_total` / `nf_hbm_bytes_in_use` ride the game's
  /metrics exposition;
- the master aggregates the games' heartbeat `costbook` ext blobs at
  `/costbook` (totals + per-game), next to `/pipeline`;
- after warmup, continued movement/combat churn causes ZERO compiles
  not covered by a sanctioned generation bump
  (CostBook.unexplained_since — the live twin of nf-lint's static
  recompile-hazard rule).

Exits 0 on success.
"""

from __future__ import annotations

import json
import sys
import urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: entries the served game role must have compiled after the drive
EXPECTED_GAME_ENTRIES = ("kernel.step", "interest.step/Player")


def _scrape(cluster, port: int, path: str):
    """GET a status endpoint while a background thread pumps the
    cluster (urlopen blocks; same pattern as pipeline_smoke)."""
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
            f"http://127.0.0.1:{port}{path}", timeout=5
        ) as r:
            body = r.read().decode()
    finally:
        stop.set()
        th.join(timeout=2)
    return body


def run(device=None, out_path=None) -> dict:
    """Run the whole scenario with the worlds on ``device`` (``None`` =
    ``"cuda"``); returns {check name: bool}.  With ``out_path``, writes
    the game book's ``kernel.step`` entry (its cost record included) as
    JSON there."""
    from noahgameframe_tpu_torch.core.device import resolve_device
    from noahgameframe_tpu_torch.client import GameClient
    from noahgameframe_tpu_torch.net.roles.cluster import LocalCluster

    device = resolve_device(device)
    checks = {}
    cluster = LocalCluster(http_port=0,
                           game_kwargs={"interest_radius": 16.0},
                           device=device)
    game, master = cluster.game, cluster.master
    # the kernel-less roles get /costbook via serve_metrics (ephemeral
    # ports, pumped from each role's execute)
    side = {r: r.serve_metrics(0)
            for r in (cluster.world, cluster.login, cluster.proxy, game)}
    cli = GameClient("cost")
    try:
        cluster.start(timeout=30)
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
        cli.create_role("Cost")
        ok = ok and pump(lambda: cli.roles)
        cli.enter_game("Cost")
        ok = ok and pump(lambda: cli.entered)
        checks["client entered world"] = ok

        # movement churn until the serving edge compiled its entries
        step = [0]

        def stir():
            cli.execute()
            step[0] += 1
            if step[0] % 25 == 0 and cli.entered:
                cli.move_to(float(step[0] % 500), 100.0)

        book = game.kernel.costbook
        checks["game entries compiled"] = cluster.pump_until(
            lambda: all(n in book.entries and book.entries[n].compiles
                        for n in EXPECTED_GAME_ENTRIES),
            extra=stir, timeout=30,
        )

        # ---- recompile-free churn after warmup (the soak gate, live)
        mark = book.mark()
        # brief live churn window — the long recompile-free soak is
        # tests/test_costbook.py::test_soak_120_ticks_recompile_free
        cluster.pump_until(lambda: False, extra=stir, timeout=0.75)
        unexplained = book.unexplained_since(mark)
        checks["zero unexplained retraces"] = not unexplained
        if unexplained:
            print(f"  unexplained: {unexplained}", file=sys.stderr)

        # ---- /costbook on every role, uniform schema
        for role, http in side.items():
            doc = json.loads(_scrape(cluster, http.port, "/costbook"))
            name = role.config.name
            checks[f"/costbook on {name}"] = (
                isinstance(doc.get("entries"), dict)
                and "generation" in doc and "hbm" in doc
                and "compiles" in doc
            )
            if role is game:
                checks["game /costbook covers entries"] = all(
                    n in doc["entries"] for n in EXPECTED_GAME_ENTRIES
                )
                e = doc["entries"].get("kernel.step", {})
                # the capture wall on cuda, the counted run's on the CPU
                wall = (e.get("capture_ms_total", 0) if device.type == "cuda"
                        else e.get("last", {}).get("cost_ms", 0))
                checks["entry has compile wall + cost"] = (
                    wall > 0
                    and "flops" in e.get("last", {})
                    and "temp_bytes" in e.get("last", {})
                )
                checks["hbm census sampled"] = (
                    doc["hbm"].get("source") in
                    ("torch.cuda", "state_tensors")
                    and doc["hbm"].get("live_bytes", 0) > 0
                )

        # ---- nf_recompiles_total / nf_hbm_* on the game's /metrics
        text = _scrape(cluster, side[game].port, "/metrics")
        checks["nf_compiles_total exposed"] = "nf_compiles_total{" in text
        checks["nf_hbm gauges exposed"] = (
            "nf_hbm_bytes_in_use" in text and "nf_hbm_peak_bytes" in text
        )

        # ---- master aggregation from the heartbeat ext blobs
        checks["heartbeats carried costbook blob"] = cluster.pump_until(
            lambda: master.costbook_status()["games"],
            extra=cli.execute, timeout=15,
        )
        agg = json.loads(_scrape(cluster, master.http.port, "/costbook"))
        games = agg.get("games", {})
        checks["master /costbook aggregates"] = (
            bool(games)
            and all("entries" in g for g in games.values())
            and agg.get("totals", {}).get("compiles", 0) > 0
        )
        checks["master /json costbook block"] = bool(
            master.servers_status().get("costbook")
        )
        step = book.snapshot()["entries"].get("kernel.step", {})
        last = step.get("last", {})
        print(f"  kernel.step on {device}: flops {last.get('flops')} bytes "
              f"{last.get('bytes_accessed')} temp {last.get('temp_bytes')}")
        if out_path is not None:
            Path(out_path).write_text(json.dumps(
                {"device": str(device), "kernel.step": step}, sort_keys=True) + "\n")
    finally:
        cli.close()
        cluster.shut()
    return checks


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="the worlds' device (default cuda)")
    ap.add_argument("--out", default=None,
                    help="write the game's kernel.step entry as JSON to this path")
    args = ap.parse_args()
    checks = run(device=args.device, out_path=args.out)
    failed = [name for name, ok in checks.items() if not ok]
    for name, ok in checks.items():
        print(f"  {'ok  ' if ok else 'FAIL'} {name}")
    if failed:
        print(f"COSTBOOK SMOKE FAILED: {failed}")
        return 1
    print(f"COSTBOOK SMOKE OK: {len(checks)} checks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
