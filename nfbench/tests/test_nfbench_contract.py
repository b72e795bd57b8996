"""A whole run of each cell on the CPU at a tiny size: the result line's
keys and their order, the metrics of each trace mode, and `correct` true
against the reference (the program and the reference agree); and the
command's refusal without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from nfbench import run

from .conftest import CELLS, tiny_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("workload", CELLS)
def test_result_line(workload, cpu_threads):
    found = tiny_cell(workload)
    res = run.run_cell(found, 2**31 + 77, 0.3, False, torch.device("cpu"), lambda: 2.5,
                       log=lambda s: None)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 14
    assert set(res["metrics"]) == {m["name"] for m in found["end_to_end"]}
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    assert res["metrics"]["setup_s"] == {"value": 2.5, "unit": "s"}
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == set(run.parts(found)[2].LIMITS)
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    if found["config"]["kind"] == "world":
        assert res["checks"] == {"cells_off": {"value": 0, "limit": 0}}
    json.loads(json.dumps(res))


@pytest.mark.parametrize("workload", CELLS)
def test_traced_result_line(workload, cpu_threads):
    res = run.run_cell(tiny_cell(workload), 11, 0.2, True, torch.device("cpu"), lambda: 1.0,
                       log=lambda s: None)
    assert list(res)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["metrics"]) <= {m["name"] for m in run.load_benchmark()["per_layer"]}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("workload", CELLS)
def test_no_card_no_result(workload):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "nfbench", "--workload", workload,
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_seeds_beyond_32_bits_derive_31_bit_keys():
    for seed in (0, 2**31 + 5, 2**40 + 3, 12345678901234):
        s = run.derived_seed(seed)
        assert 0 <= s < 2**30
        assert s == run.derived_seed(seed)
    assert run.derived_seed(1) != run.derived_seed(2)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload, cuda_device):
    out = subprocess.run([sys.executable, "-m", "nfbench", "--workload", workload,
                          "--seed", "4242", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
