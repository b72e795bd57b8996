"""BENCHMARK.json and the files it names: every cell's configuration,
traffic mix and metric readers are found by name, and the file keeps to
the benchmark's contract."""

import importlib
import json
import re

import pytest

from nfbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return run.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["nfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("workload", ["world_1m.frames"])
def test_cells_found_by_name(bench, workload):
    found = run.find_cell(bench, workload)
    assert found["config"]["kind"] == "world"
    assert found["traffic"]["entry"] == "kernel.run_device"
    assert {m["name"] for m in found["end_to_end"]} >= {"setup_s"}
    assert len(found["end_to_end"]) >= 2 and found["per_layer"]


def test_unknown_cell_is_refused(bench):
    with pytest.raises(KeyError):
        run.find_cell(bench, "no_such.cell")


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = importlib.import_module(f"nfbench.metrics.{m['name'].split('.')[0]}")
        assert callable(mod.read)


def test_names_units_and_bounds(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in bench["configs"])) == len(bench["configs"])
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        moved = [e for e in bench["end_to_end"] if e["name"] == m["moves"]][0]
        cells = [w["name"] for w in bench["workloads"]]
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("nfbench/configs/") and len(c["source"]) <= 200


def test_every_config_is_used_and_matches_its_file(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        with open(run.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
