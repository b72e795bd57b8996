"""BENCHMARK.json and the files it names: every cell's configuration,
traffic mix, deployment kind, entry, check and metric readers are found
by name, a new kind, entry and check come as added files, and the file
keeps to the benchmark's contract."""

import copy
import importlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from nfbench import run

from .conftest import CELLS

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


@pytest.mark.parametrize("workload", CELLS)
def test_cells_found_by_name(bench, workload):
    found = run.find_cell(bench, workload)
    kind, ent, chk = run.parts(found)
    assert kind.__name__ == f"nfbench.deployments.{found['config']['kind']}"
    assert ent.__name__ == "nfbench.entries." + found["traffic"]["entry"].replace(".", "_")
    assert chk.__name__ == f"nfbench.checks.{found['config']['kind']}"
    for fn in ("deploy", "tiny", "batch", "answer"):
        assert callable(getattr(kind, fn))
    assert found["config"]["kind"] in ent.KINDS and isinstance(ent.BOOK, str)
    assert callable(ent.prepare) and callable(ent.frame)
    for fn in ("reference_inputs", "run_check", "passed", "describe", "readings", "control"):
        assert callable(getattr(chk, fn))
    assert chk.LIMITS and isinstance(chk.CONTROL, str)
    for side in ("warmup_frames", "early_frames", "late_frames", "trace_from", "trace_frames"):
        assert side in found["traffic"]
    assert {m["name"] for m in found["end_to_end"]} >= {"setup_s"}
    assert len(found["end_to_end"]) >= 2 and found["per_layer"]


@pytest.mark.parametrize("workload,kind,entry,book", [
    ("world_1m.frames", "world", "kernel.run_device", "kernel.run")])
def test_the_world_cells_entries(bench, workload, kind, entry, book):
    found = run.find_cell(bench, workload)
    assert found["config"]["kind"] == kind and found["traffic"]["entry"] == entry
    _kind, ent, chk = run.parts(found)
    assert ent.BOOK == book
    # the world's check is exact: no cell may differ from the reference
    assert chk.LIMITS == {"cells_off": 0} and chk.CONTROL == "bfloat16"


@pytest.mark.parametrize("part,value,missing", [
    ("kind", "no_such_kind", "nfbench/deployments/no_such_kind.py"),
    ("entry", "no.such_entry", "nfbench/entries/no_such_entry.py"),
    ("metric", "no_such_metric.served", "nfbench/metrics/no_such_metric.py")])
def test_a_missing_part_is_refused_by_name(bench, part, value, missing):
    if part == "metric":
        with pytest.raises(LookupError, match=re.escape(missing)):
            run.reader(value)
        return
    found = copy.deepcopy(run.find_cell(bench, "world_1m.frames"))
    if part == "kind":
        found["config"]["kind"] = value
    else:
        found["traffic"]["entry"] = value
    with pytest.raises(LookupError, match=re.escape(missing)):
        run.parts(found)


def test_an_entry_refuses_a_kind_it_does_not_drive(bench, monkeypatch):
    found = run.find_cell(bench, "world_1m.frames")
    monkeypatch.setattr(run.parts(found)[1], "KINDS", ("rooms",))
    with pytest.raises(ValueError, match="drives no deployment of kind 'world'"):
        run.parts(found)


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
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert os.path.isfile(run.HERE / "traffic" / f"{w['traffic']}.json")
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) * 25 // 100)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert len(set(w["name"] for w in bench["workloads"])) == len(bench["workloads"])
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


# -- a new kind, entry and check, as added files only ------------------------------

TOY_KIND = """
import torch


class Toy:
    def __init__(self, cfg, seed, device):
        self.entities = int(cfg["entities"])
        g = torch.Generator().manual_seed(seed)
        self.x = torch.randint(0, 1000, (self.entities,), generator=g).to(device)
        self.tick = torch.zeros((), dtype=torch.int64, device=device)

    def leaves(self):
        return [("tick", self.tick), ("x", self.x)]

    def layout(self):
        return None

    def after_window(self):
        pass

    def launches_per_replay(self, book):
        return None

    def close(self):
        self.x = self.tick = None


def deploy(cfg, seed, device):
    return Toy(cfg, seed, device)


def tiny(found):
    return found


def batch(dep):
    return ["x"]


def answer(dep):
    return "x", (0,)
"""

TOY_ENTRY = """
KINDS = ("toy",)
BOOK = "toy.step"


def prepare(dep):
    dep.x.add_(0)


def frame(dep):
    dep.x.add_(3)
    dep.tick.add_(1)
"""

TOY_CHECK = """
import torch

LIMITS = {"cells_off": 0}
CONTROL = "none"


def reference_inputs(cfg, seed, device):
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randint(0, 1000, (int(cfg["entities"]),), generator=g).to(device)}


def run_check(cfg, lay, inputs, start, early, late, stats=None, max_ticks=0):
    off = {"cells_off": 0, "cells": 0}

    def compare(ref, got):
        off["cells_off"] += int((ref != got).sum())
        off["cells"] += got.numel()

    t = int(early[0]["tick"].reshape(-1)[0])
    compare(inputs["x"][None], start["x"])
    compare(inputs["x"][None] + 3 * t, early[0]["x"])
    compare(early[0]["x"] + 3, early[1]["x"])
    compare(late[0]["x"] + 3, late[1]["x"])
    if stats is not None:
        stats["early_tick"] = t
    return off


def passed(numbers):
    return all(numbers[k] <= lim for k, lim in LIMITS.items())


def describe(stats):
    return f"early tick {stats.get('early_tick')}"


def readings(stats):
    return {}


def control(found, seed, lay, inputs, start, target):
    return {"cells_off": 1, "cells": 1}
"""

TOY_RUN = """
import json, torch
from nfbench import run
found = run.find_cell(run.load_benchmark(), "toy.frames")
res = run.run_cell(found, 2**31 + 3, 0.2, False, torch.device("cpu"), lambda: 1.0,
                   log=lambda s: None)
print(json.dumps({"harness": run.__file__, "result": res}))
"""


def _tree(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_a_new_kind_entry_and_check_come_as_added_files(tmp_path):
    shutil.copytree(run.HERE, tmp_path / "nfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _tree(tmp_path)
    bench = json.loads(before["BENCHMARK.json"])
    bench["configs"].append({"name": "toy_cfg", "source": "a counter per row",
                             "file": "nfbench/configs/toy_cfg.json", "reduced": [],
                             "why": "a deployment kind of the harness's test"})
    bench["workloads"].append({"name": "toy.frames", "config": "toy_cfg",
                               "traffic": "toy_loop", "chips": 1, "why": "a toy"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    added = {
        "nfbench/configs/toy_cfg.json": json.dumps({"name": "toy_cfg", "kind": "toy",
                                                    "entities": 64}),
        "nfbench/traffic/toy_loop.json": json.dumps({
            "entry": "toy.step", "warmup_frames": 2, "early_frames": 4,
            "late_frames": [6, 9], "trace_from": 0, "trace_frames": 1}),
        "nfbench/deployments/toy.py": TOY_KIND,
        "nfbench/entries/toy_step.py": TOY_ENTRY,
    }
    for rel, text in added.items():
        (tmp_path / rel).write_text(text)
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")

    def toy_run():
        return subprocess.run([sys.executable, "-c", TOY_RUN], capture_output=True,
                              text=True, timeout=300, cwd=tmp_path, env=env)

    out = toy_run()
    assert out.returncode != 0 and "no module nfbench/checks/toy.py" in out.stderr
    (tmp_path / "nfbench/checks/toy.py").write_text(TOY_CHECK)
    out = toy_run()
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["harness"].startswith(str(tmp_path))
    res = line["result"]
    assert res["correct"] is True and res["attempted"] >= 10
    assert res["checks"] == {"cells_off": {"value": 0, "limit": 0}}
    assert set(res["metrics"]) == {m["name"] for m in bench["end_to_end"]
                                   if "toy.frames" in m.get("workloads", ["toy.frames"])}
    after = _tree(tmp_path)
    del before["BENCHMARK.json"]
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(added) | {"BENCHMARK.json", "nfbench/checks/toy.py"}
