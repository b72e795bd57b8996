#!/usr/bin/env python
"""Flight-recorder smoke on the PyTorch port: journal a chaos run, replay
it bit-identically, then bisect a deliberately perturbed replay to the
exact injected tick.

    python scripts/torch_replay_smoke.py                 # worlds on cuda
    python scripts/torch_replay_smoke.py --device cpu

The port's copy of ``scripts/replay_smoke.py``: the same scenario, the
same checks under the same names, with the recorded world and both
replays' worlds on ``device`` (``None`` = ``"cuda"``; without a card
that raises).

Boots the five-role LocalCluster from torch_chaos_smoke's world recipe with a
seeded FaultPlan AND a journaling game role, copies the first checkpoint
aside, runs 120+ journaled ticks under faults, and asserts:

- the master's /json aggregate exposes the chaos seed + link budgets
  (the replay side can re-derive the fault schedule),
- the journal telemetry moved (ticks/bytes/segments counters),
- an offline replay from (checkpoint, journal) reproduces EVERY
  per-tick on-device state digest bit for bit — the chaos run is
  deterministic modulo its recorded inputs,
- a second replay with one float perturbed at a chosen tick diverges,
  and digest bisection pins the FIRST divergent tick exactly there,
  with a field-level diff naming the perturbed bank.

Exits 0 on success.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torch_chaos_smoke import build_world, fault_plan  # noqa: E402

TICKS = 120  # journaled ticks past the base checkpoint
PERTURB_AFTER = 40  # perturbation lands this many ticks past the base


def run(tmpdir, seed: int = 7, device=None) -> dict:
    """Run the whole scenario with every world on ``device`` (``None`` =
    ``"cuda"``); returns {check name: bool}."""
    import json

    from noahgameframe_tpu_torch.core.device import resolve_device
    from noahgameframe_tpu_torch.net.roles.cluster import LocalCluster
    from noahgameframe_tpu_torch.replay import (
        bisect_divergence,
        field_diff,
        make_offline_role,
        read_ticks,
        replay_journal,
    )

    device = resolve_device(device)
    ckpt = Path(tmpdir) / "ckpt"
    ckpt0 = Path(tmpdir) / "ckpt0"
    jdir = Path(tmpdir) / "journal"
    cluster = LocalCluster(
        http_port=0,
        game_world=build_world(seed, device),
        game_kwargs={
            "checkpoint_dir": ckpt,
            "checkpoint_seconds": 0.2,
            "journal_dir": jdir,
            "journal_segment_bytes": 4096,
        },
    )
    checks = {}
    try:
        cluster.apply_chaos(fault_plan(seed))
        cluster.start(timeout=60)
        checks["wired under faults"] = True
        checks["checkpoint written"] = cluster.pump_until(
            lambda: (ckpt / "meta.json").exists(), timeout=30
        )
        # freeze the base checkpoint before the periodic writer replaces
        # it (single pump thread: nothing is mid-rename between pumps)
        shutil.copytree(ckpt, ckpt0)
        base_tick = json.loads((ckpt0 / "meta.json").read_text())["tick_count"]

        game = cluster.game
        checks["journaled 120+ ticks under chaos"] = cluster.pump_until(
            lambda: game.kernel.tick_count >= base_tick + TICKS, timeout=120
        )

        # ---- the chaos plan is visible where replay needs it
        status = cluster.master.servers_status()
        chaos = status.get("chaos", {})
        checks["chaos seed on master /json"] = chaos.get("seed") == seed
        checks["chaos link budgets on master /json"] = (
            "game6.world" in chaos.get("links", {})
        )

        # ---- journal telemetry moved
        reg = game.telemetry.registry
        checks["journal tick counter"] = (
            reg.value("nf_journal_ticks_total") >= TICKS
        )
        checks["journal byte counter"] = reg.value("nf_journal_bytes_total") > 0
        checks["journal segment rotation"] = (
            reg.value("nf_journal_segments_total") >= 2
        )
    finally:
        cluster.shut()

    # ------------------------------------------------- faithful replay
    expected = read_ticks(jdir)
    checks["journal readable after shutdown"] = len(expected) >= TICKS
    checks["chaos note journaled"] = any(
        n.get("kind") == "chaos" and n.get("seed") == seed
        for n in _journal_notes(jdir)
    )

    role = make_offline_role(world=build_world(seed, device))
    try:
        rep = replay_journal(jdir, checkpoint=ckpt0, role=role)
        checks["replayed 100+ ticks"] = rep.ticks_replayed >= 100
        checks["replay digests bit-identical"] = rep.ok
        checks["replay divergence counter zero"] = (
            role.telemetry.registry.value("nf_replay_divergences_total") == 0
        )
        clean_state = role.kernel.state
    finally:
        role.shut()

    # --------------------------------------- perturbed replay + bisect
    # nudge one NPC position component: movement is off, so nothing ever
    # rewrites the vec bank and the divergence persists tick after tick
    # (HP would heal back to the MAXHP cap and break bisect's monotone
    # boundary) — exactly the class of bug bisect exists to localize
    k_t = base_tick + PERTURB_AFTER

    def perturb(prole, tick):
        if tick != k_t:
            return
        from noahgameframe_tpu_torch.core.store import with_class

        k = prole.kernel
        cs = k.state.classes["NPC"]
        vec = cs.vec.clone()
        vec[0, 0, 0] += 1.0
        k.state = with_class(k.state, "NPC", cs.replace(vec=vec))

    role2 = make_offline_role(world=build_world(seed, device))
    try:
        rep2 = replay_journal(jdir, checkpoint=ckpt0, role=role2,
                              perturb=perturb)
        checks["perturbed replay diverges"] = not rep2.ok
        checks["divergence counter moved"] = (
            role2.telemetry.registry.value("nf_replay_divergences_total") >= 1
        )
        found = bisect_divergence(rep2.expected, rep2.digests)
        checks["bisect finds exact perturbed tick"] = found == k_t
        diff = field_diff(role2.kernel.state, clean_state)
        checks["field diff names perturbed bank"] = any(
            d["key"] == "c/NPC/vec" for d in diff
        )
    finally:
        role2.shut()
    return checks


def _journal_notes(jdir) -> list:
    from noahgameframe_tpu_torch.replay.journal import (
        REC_NOTE,
        JournalReader,
        decode_json,
    )

    return [decode_json(body) for rec_type, body in JournalReader(jdir)
            if rec_type == REC_NOTE]


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
        print(f"REPLAY SMOKE FAILED: {failed}")
        return 1
    print(f"REPLAY SMOKE OK: {len(checks)} checks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
