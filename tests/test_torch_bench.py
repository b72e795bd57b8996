"""The port's bench entry (python -m noahgameframe_tpu_torch.bench): on the
CPU, when asked for by name, it prints one JSON line with run_bench's
keys; without a card and without --device cpu it fails, with no CPU
fallback."""

import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
DETAIL_KEYS = {
    "tick_ms", "tick_ms_p50", "tick_ms_p95", "tick_ms_p99", "tick_ms_p50_device",
    "tick_ms_p95_device", "tick_ms_p99_device", "lat_k", "binning", "verlet_skin",
    "pallas_engine", "tick_counters", "costbook", "grid_overflow_max",
    "att_overflow_max", "graph", "launches_per_tick",
}


def _bench(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "noahgameframe_tpu_torch.bench", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, **(env or {})})


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
