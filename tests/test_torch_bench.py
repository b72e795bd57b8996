"""The port's bench entry (python -m noahgameframe_tpu_torch.bench): on the
CPU, when asked for by name, it prints one JSON line with run_bench's
keys; without a card and without --device cpu it fails, with no CPU
fallback."""

import json
import os
import pathlib
import subprocess
import sys
from test_torch_parity import one_intra_op_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
DETAIL_KEYS = {
    "tick_ms", "tick_ms_p50", "tick_ms_p95", "tick_ms_p99", "tick_ms_p50_device",
    "tick_ms_p95_device", "tick_ms_p99_device", "lat_k", "binning", "verlet_skin",
    "pallas_engine", "tick_counters", "costbook", "grid_overflow_max",
    "att_overflow_max", "graph", "launches_per_tick",
}


def _bench(*args, env=None):
    # one intra-op thread: beside a parallel test run, an entry's thread
    # pool on every core oversubscribes the machine and its time explodes
    return subprocess.run(
        [sys.executable, "-m", "noahgameframe_tpu_torch.bench", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1", **(env or {})})


def test_bench_prints_one_line_on_the_cpu():
    proc = _bench("--device", "cpu", "--entities", "2048", "--ticks", "4", "--train", "2",
                  "--lat-k", "2", "--lat-budget-s", "0", env={"NF_VERLET_SKIN": "2.0"})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "entities_ticked_per_sec_per_chip"
    assert line["unit"] == "entity-ticks/s" and line["value"] > 0
    assert "vs_baseline" not in line
    d = line["detail"]
    assert DETAIL_KEYS <= set(d)
    assert d["entities"] == 2048 and d["platform"] == "cpu" and d["graph"] is False
    assert d["tick_train"] == 2 and d["train_dispatches"] == 2
    assert d["verlet_skin"] == 2.0 and d["verlet"]["NPC"]["rebuilds"] >= 1
    assert d["binning"] == "sort" and d["pallas_engine"] == 0
    assert d["tick_counters"]["tick"] > 4
    assert d["costbook"]["entries"]["kernel.train"]["compiles"] >= 1


def test_bench_without_a_card_fails():
    """No --device: cuda, which this process must not see."""
    proc = _bench("--entities", "64", "--ticks", "1", env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "device='cpu'" in proc.stderr


def test_bench_rooms_ladder_on_the_cpu():
    """--rooms: run_rooms's keys per rung, the churn and re-capture gates,
    and under --train the train arm and its digest parity against ticks."""
    proc = _bench("--rooms", "--device", "cpu", "--rooms-count", "2,4", "--rooms-ticks", "2",
                  "--rooms-churn", "2", "--train", "2")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "rooms_train_room_ticks_per_sec"
    assert line["unit"] == "room-ticks/s" and line["value"] > 0
    d = line["detail"]
    assert d["platform"] == "cpu" and d["all_gates"] is True and d["tick_train"] == 2
    assert [p["rooms"] for p in d["points"]] == [2, 4]
    p = d["points"][-1]
    for key in ("admit_ms_per_room", "tick_p50_ms", "tick_p99_ms", "room_ticks_per_sec",
                "entity_ticks_per_sec", "dropped_rows", "unexplained_recompiles",
                "train_room_ticks_per_sec", "train_dispatches", "digest_parity",
                "launches_per_tick", "costbook"):
        assert key in p, key
    assert p["rooms_admitted"] == 3 and p["entities_per_room"] == 32
    assert p["dropped_rows"] == 0 and p["unexplained_recompiles"] == 0
    assert p["digest_parity"] is True and p["digest_parity_ticks"] == 120
    assert p["train_dispatches"] == 2 and p["graph"] is False
