#!/usr/bin/env python
"""Run one server role of the PyTorch port as a standalone process
(NFPluginLoader equivalent).

The port's counterpart of scripts/run_role.py, with its CLI.  The
reference launches each role as `NFPluginLoader Server=GameServer ID=6`
reading Server.xml (`_Out/Tester/rund_*.sh`); here:

    python scripts/torch_run_role.py --role master --id 1 --server-xml cluster.xml
    python scripts/torch_run_role.py --role game --id 6 --server-xml cluster.xml

Server.xml lists every instance in the cluster; each process picks its own
row by (role, id) and derives its upstream targets from the others
(login/world dial the master; proxy/game dial the world).

The game role's world lives on ``--device`` (``cuda`` by default; ``cpu``
when asked).  The other four roles hold no device state.  In place of
scripts/run_role.py's ``--platform default|cpu``, which picks the jax
backend, the port takes ``--device cuda|cpu``.  ``--replay`` rebuilds the
game's device state offline on ``--device`` and exits 0 only if every
journaled digest is bit-identical.
"""

from __future__ import annotations

import argparse
import atexit
import faulthandler
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from noahgameframe_tpu_torch.net.defines import ServerType  # noqa: E402
from noahgameframe_tpu_torch.net.roles import (  # noqa: E402
    GameRole,
    LoginRole,
    MasterRole,
    ProxyRole,
    WorldRole,
    load_server_xml,
)
from noahgameframe_tpu_torch.net.roles.cluster import pace_role  # noqa: E402

ROLE_CLASSES = {
    "master": (MasterRole, int(ServerType.MASTER), None),
    "login": (LoginRole, int(ServerType.LOGIN), int(ServerType.MASTER)),
    "world": (WorldRole, int(ServerType.WORLD), int(ServerType.MASTER)),
    "proxy": (ProxyRole, int(ServerType.PROXY), int(ServerType.WORLD)),
    "game": (GameRole, int(ServerType.GAME), int(ServerType.WORLD)),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", required=True, choices=sorted(ROLE_CLASSES))
    ap.add_argument("--id", type=int, required=True, help="server id in Server.xml")
    ap.add_argument("--server-xml", required=True, type=Path)
    ap.add_argument("--http-port", type=int, default=None,
                    help="HTTP port: the master serves /json + /metrics "
                         "on it; every other role serves /metrics")
    ap.add_argument("--tick-sleep", type=float, default=0.001,
                    help="main-loop sleep (reference: 1 ms)")
    ap.add_argument("--keepalive-seconds", type=float, default=None,
                    help="report and re-dial cadence of this role's upstream "
                         "links (default: the library's 10 s refresh; a test "
                         "cluster uses a fraction of a second)")
    ap.add_argument("--crash-log-dir", type=Path, default=Path("crashlogs"),
                    help="where crash tracebacks are written")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="game role: the device of its world (and of "
                         "--replay); the other roles hold no device state")
    ap.add_argument("--checkpoint-dir", type=Path, default=None,
                    help="game role: directory for periodic atomic "
                         "whole-world checkpoints")
    ap.add_argument("--checkpoint-seconds", type=float, default=30.0,
                    help="game role: seconds between checkpoints")
    ap.add_argument("--resume", action="store_true",
                    help="game role: restore the latest checkpoint from "
                         "--checkpoint-dir before serving")
    ap.add_argument("--journal", type=Path, default=None,
                    help="game role: record every host->device input "
                         "(commands, migrations, tick digests) to this "
                         "flight-recorder directory")
    ap.add_argument("--journal-segment-bytes", type=int, default=1 << 20,
                    help="journal segment rotation threshold")
    ap.add_argument("--replay", type=Path, default=None,
                    help="game role: do not serve; rebuild device state "
                         "offline from --checkpoint-dir + this journal, "
                         "verify every per-tick digest, exit 0 iff "
                         "bit-identical")
    args = ap.parse_args()

    # crash capture: the reference installs a minidump handler around its
    # main loop (NFPluginLoader.cpp:42-69); the Python equivalent dumps
    # every thread's traceback to a per-process crash file on SIGSEGV/
    # SIGFPE/SIGABRT/SIGBUS and on hard faults in native extensions
    args.crash_log_dir.mkdir(parents=True, exist_ok=True)
    crash_path = args.crash_log_dir / f"{args.role}_{args.id}_{os.getpid()}.crash"
    crash_file = open(crash_path, "w")  # noqa: SIM115 — must outlive main
    faulthandler.enable(file=crash_file, all_threads=True)

    def _tidy_crash_file() -> None:
        # keep only real fault dumps; a clean exit leaves the file empty
        try:
            crash_file.flush()
            if crash_path.stat().st_size == 0:
                crash_path.unlink()
        except OSError:
            pass

    atexit.register(_tidy_crash_file)

    if args.replay is not None:
        if args.role != "game":
            print("--replay is a game-role mode", file=sys.stderr)
            return 2
        from noahgameframe_tpu_torch.replay import make_offline_role, replay_journal

        report = replay_journal(args.replay, checkpoint=args.checkpoint_dir,
                                role=make_offline_role(device=args.device))
        print(report.summary(), flush=True)
        return 0 if report.ok else 1

    cls, stype, upstream_type = ROLE_CLASSES[args.role]
    rows = load_server_xml(args.server_xml)
    mine = [r for r in rows if r.server_type == stype and r.server_id == args.id]
    if not mine:
        print(f"no <Server> row with Type={args.role} ID={args.id}", file=sys.stderr)
        return 2
    config = mine[0]
    if upstream_type is not None:
        config.targets = [r for r in rows if r.server_type == upstream_type]

    kwargs = {}
    if args.role == "game":
        kwargs["device"] = args.device
    if args.role == "master" and args.http_port is not None:
        kwargs["http_port"] = args.http_port
    if args.role == "game" and args.checkpoint_dir is not None:
        kwargs["checkpoint_dir"] = args.checkpoint_dir
        kwargs["checkpoint_seconds"] = args.checkpoint_seconds
        kwargs["resume"] = args.resume
    if args.role == "game" and args.journal is not None:
        kwargs["journal_dir"] = args.journal
        kwargs["journal_segment_bytes"] = args.journal_segment_bytes
    role = cls(config, **kwargs)
    if args.keepalive_seconds is not None:
        pace_role(role, args.keepalive_seconds)
    if args.role != "master" and args.http_port is not None:
        h = role.serve_metrics(args.http_port)
        print(f"{args.role} id={config.server_id} /metrics on "
              f"{config.ip}:{h.port}", flush=True)
    print(f"{args.role} id={config.server_id} listening on "
          f"{config.ip}:{config.port}", flush=True)
    try:
        while True:
            # frame percentiles ride the 10 s report's ext map to the
            # master dashboard (the reference reports raw counts only)
            with role.metrics.frame():
                role.execute()
            time.sleep(args.tick_sleep)
    except KeyboardInterrupt:
        pass
    finally:
        role.shut()
    return 0


if __name__ == "__main__":
    sys.exit(main())
