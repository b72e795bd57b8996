#!/usr/bin/env python
"""Telemetry smoke on the PyTorch port: boot a Game role, tick it, scrape
/metrics.

    python scripts/torch_telemetry_smoke.py                 # cuda
    python scripts/torch_telemetry_smoke.py --device cpu

The port's copy of ``scripts/telemetry_smoke.py``: boots a GameRole on
loopback over ``build_benchmark_world(256)`` (combat on) on ``device``,
drives 50 world ticks through the real pump, scrapes /metrics over a
real socket, and checks, under the JAX script's names, that the tick
and frame histograms, the on-device overflow counters and the tick count
are there.  :func:`run` returns the checks; :func:`scrape` is the
blocking GET the cluster smokes reuse.  Exits 0 on success.
"""

from __future__ import annotations

import socket
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TICKS = 50


def scrape(pump, port: int, path: bytes = b"/metrics") -> bytes:
    """GET over a blocking client socket against the pumped HttpServer."""
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.settimeout(0.02)
    s.sendall(b"GET " + path + b" HTTP/1.1\r\nHost: smoke\r\n"
              b"Connection: close\r\n\r\n")
    buf = b""
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        pump()
        try:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
        except socket.timeout:
            head, sep, body = buf.partition(b"\r\n\r\n")
            if sep:
                cl = [ln for ln in head.split(b"\r\n")
                      if ln.lower().startswith(b"content-length")]
                if cl and len(body) >= int(cl[0].split(b":")[1]):
                    break
    s.close()
    return buf


def run(device=None) -> dict:
    """Tick a game role :data:`TICKS` times through its pump on ``device``
    (``None`` = ``"cuda"``) and scrape its /metrics; returns {check
    name: bool} (and prints the scrape's size)."""
    from noahgameframe_tpu_torch.game.world import build_benchmark_world
    from noahgameframe_tpu_torch.net.roles.base import RoleConfig
    from noahgameframe_tpu_torch.net.roles.game import GameRole

    # combat ON: the AOI/stencil overflow counters only exist in worlds
    # with a combat phase (they come from its cell-table builds)
    world = build_benchmark_world(256, device=device)
    role = GameRole(RoleConfig(6, 0, "SmokeGame", "127.0.0.1", 0),
                    world=world)
    try:
        http = role.serve_metrics(0)
        print(f"game role up on {role.kernel.device}; /metrics on 127.0.0.1:{http.port}")

        dt = role.game_world.config.dt * 1.0001
        now = 1000.0
        ticked = role.kernel.tick_count
        while role.kernel.tick_count - ticked < TICKS:
            now += dt
            role.execute(now)

        raw = scrape(role.execute, http.port)
    finally:
        role.shut()
    status = raw.split(b"\r\n", 1)[0]
    body = raw.partition(b"\r\n\r\n")[2].decode()

    checks = {
        "http 200": b"200" in status,
        "tick histogram": "nf_game_tick_seconds_bucket{le=" in body,
        "frame histogram": "nf_frame_seconds_bucket{le=" in body,
        "victim overflow counter":
            'nf_tick_counters_total{counter="aoi_victim_overflow_drops"}'
            in body,
        "attacker overflow counter":
            'nf_tick_counters_total{counter="aoi_attacker_overflow_drops"}'
            in body,
        # scrape pumps tick the world too — assert the floor, not equality
        "tick count": any(
            ln.startswith("nf_ticks_total ")
            and float(ln.split()[1]) >= TICKS
            for ln in body.splitlines()
        ),
    }
    print(f"  scraped {len(body.splitlines())} metric lines")
    return checks


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="the world's device (default cuda)")
    args = ap.parse_args()
    checks = run(device=args.device)
    failed = [name for name, ok in checks.items() if not ok]
    for name, ok in checks.items():
        print(f"  {'ok  ' if ok else 'FAIL'} {name}")
    if failed:
        print(f"SMOKE FAILED: {failed}")
        return 1
    print(f"SMOKE OK: {TICKS} ticks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
