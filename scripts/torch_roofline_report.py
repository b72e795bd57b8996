"""Measured roofline on the PyTorch port: the cost book's counted cost x
the stage clock's device time.

The port's copy of ``scripts/roofline_report.py``.  It runs the served
path (a GameRole over ``build_benchmark_world(entities)``, simulated
sessions, ``NF_STAGE_TIMING=1`` so each stage syncs on its device work)
and folds each cost-book entry's FLOPs and bytes (the port's per-entry
cost count, ``telemetry/costbook.py``) against the StageClock's
per-stage seconds into achieved-against-peak fractions per stage
(``telemetry/costbook.roofline_fold``).  On ``cuda`` the peaks are
``PEAKS["gpu"]`` (one H100 SXM at 700 W); on the CPU they are the
provisional placeholders and the output says ``"provisional": true``.
The world runs on ``--device`` (default ``cuda``; without a card that
raises).

Usage:
    python scripts/torch_roofline_report.py \
        [--entities 20000] [--sessions 32] [--ticks 120] [--device cuda]

Writes ``chiprun_out/roofline_<round>.json`` (which git ignores; stdout
gets the same JSON).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REPO = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def run(entities: int = 20_000, sessions: int = 32, ticks: int = 120, seed: int = 42,
        interest_radius: float = 16.0, device=None) -> dict:
    """Serve ``ticks`` frames with ``NF_STAGE_TIMING=1`` on ``device``
    (``None`` = ``"cuda"``) and fold the cost book against the stage
    clock; returns the report."""
    import torch

    from noahgameframe_tpu_torch.core.datatypes import next_pow2
    from noahgameframe_tpu_torch.game import build_benchmark_world
    from noahgameframe_tpu_torch.net.roles.base import RoleConfig
    from noahgameframe_tpu_torch.net.roles.game import GameRole, Session
    from noahgameframe_tpu_torch.net.wire import Ident, ident_key
    from noahgameframe_tpu_torch.telemetry.costbook import roofline_fold

    world = build_benchmark_world(
        entities, combat=True, seed=seed,
        player_capacity=next_pow2(sessions + 8, lo=64), device=device,
    )
    # honest device seconds are the whole point: the stage clock's
    # synced spans are read from the environment when the role is built
    old = os.environ.get("NF_STAGE_TIMING")
    os.environ["NF_STAGE_TIMING"] = "1"
    try:
        role = GameRole(
            RoleConfig(6, 0, "RooflineGame", "127.0.0.1", 0),
            backend="py", world=world, cross_server_sync=False,
            interest_radius=interest_radius,
        )
    finally:
        if old is None:
            os.environ.pop("NF_STAGE_TIMING", None)
        else:
            os.environ["NF_STAGE_TIMING"] = old
    dev = role.kernel.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    try:
        role.server.send_raw = lambda conn_id, msg_id, body: True
        for i in range(sessions):
            ident = Ident(svrid=99, index=i + 1)
            sess = Session(ident=ident, conn_id=1000 + (i % 8),
                           account=f"bot{i}")
            sess.guid = role.kernel.create_object(
                "Player", {"Name": f"Bot{i}"}, scene=1, group=0)
            role.sessions[ident_key(ident)] = sess
            role._guid_session[sess.guid] = ident_key(ident)

        dt = world.config.dt * 1.0001
        now = 1000.0
        for _ in range(3):  # warmup: capture + first flush
            now += dt
            role.execute(now)
        sync()
        for _ in range(ticks):
            now += dt
            role.execute(now)
        sync()

        book = role.kernel.costbook
        hbm = book.hbm_sample(dev if dev.type == "cuda" else None)
        fold = roofline_fold(book, role.pipeline_stats(),
                             platform="gpu" if dev.type == "cuda" else "cpu")
        step = book.entries.get("kernel.step")
        return {
            "metric": "roofline_frac_of_peak",
            "entities": entities,
            "sessions": sessions,
            "ticks": ticks,
            "seed": seed,
            "interest_radius": interest_radius,
            "stage_timing": True,
            "device": str(dev),
            "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "hbm": hbm,
            "capture_ms": round(book.capture_s_total * 1e3, 1),
            "compiles": book.total_compiles,
            "recompiles": book.total_recompiles,
            "kernel_step": {key: step.last.get(key) for key in (
                "flops", "bytes_accessed", "temp_bytes", "cost_ops", "uncounted_ops")}
            if step is not None else None,
            "roofline": fold,
        }
    finally:
        role.shut()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--entities", type=int, default=20_000)
    ap.add_argument("--sessions", type=int, default=32)
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--interest-radius", type=float, default=16.0)
    ap.add_argument("--device", default=None, help="the world's device (default cuda)")
    ap.add_argument("--round", default="torch",
                    help="tag for the output filename")
    ap.add_argument("--out-dir", default=os.path.join(REPO, "chiprun_out"))
    args = ap.parse_args()

    out = run(args.entities, args.sessions, args.ticks, args.seed, args.interest_radius,
              args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"roofline_{args.round}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    print(f"# wrote {os.path.normpath(path)}", file=sys.stderr)


if __name__ == "__main__":
    main()
