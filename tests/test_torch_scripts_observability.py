"""The port's observability drivers (scripts/torch_{costbook,telemetry}_
smoke.py, torch_{export,capture}_trace.py, torch_roofline_report.py) on
the CPU, and the device default and exit code of every port script.

The cost-book smoke passes every check under the JAX script's names, at
run time beside the JAX script's own run (~12 s in the tier-1 run) and in
the two scripts' text; the telemetry smoke's checks are the JAX script's
dict by its AST.  The trace drivers and the roofline report run at small
sizes: the span file, the profiler trace with the ``nf.*`` ranges, the
merge, the tarred 1M-tick capture's layout, and a roofline fold with a
``tick`` stage.  Every script's entry point without ``device`` means
``"cuda"`` and raises without a card, and every smoke's ``main`` exits 1
when a check fails."""

from __future__ import annotations

import json
import sys
import tarfile

import pytest
import torch

from test_torch_parity import one_intra_op_thread  # noqa: F401
from test_torch_scripts_cluster import all_true, check_names, load


def test_costbook_smoke_equals_jax(tmp_path):
    out = tmp_path / "step.json"
    port = load("torch_costbook_smoke")
    checks = port.run(device="cpu", out_path=out)
    ref = load("costbook_smoke")
    jchecks = ref.run()
    all_true(checks)
    all_true(jchecks)
    assert list(checks) == list(jchecks) and len(checks) == 15
    assert check_names("torch_costbook_smoke") == check_names("costbook_smoke")
    assert port.EXPECTED_GAME_ENTRIES == ref.EXPECTED_GAME_ENTRIES
    step = json.loads(out.read_text())["kernel.step"]
    assert step["compiles"] >= 1 and step["last"]["cost_ms"] > 0
    assert all(step["last"][k] > 0 for k in ("flops", "bytes_accessed", "temp_bytes"))


def test_telemetry_smoke_passes_the_jax_checks():
    checks = load("torch_telemetry_smoke").run(device="cpu")
    all_true(checks)
    assert check_names("torch_telemetry_smoke") == check_names("telemetry_smoke")
    assert len(checks) == 6


def test_export_trace_spans_profile_and_merge(tmp_path):
    mod = load("torch_export_trace")
    info = mod.run(entities=256, ticks=4, out=tmp_path / "spans.json",
                   profile=tmp_path / "prof", device="cpu")
    assert info["spans"] > 4 and info["device"] == "cpu"
    spans = json.loads((tmp_path / "spans.json").read_text())["traceEvents"]
    assert sum(1 for e in spans if e.get("name") == "tick") == 4
    prof = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    names = {str(e.get("name")) for e in prof}
    assert "nf.schedule" in names and "nf.diff" in names
    assert any(n.startswith("nf.phase.") for n in names)
    n = mod.merge_files([tmp_path / "spans.json"] * 2, [0.0, 5.0], tmp_path / "merged.json")
    merged = json.loads((tmp_path / "merged.json").read_text())["traceEvents"]
    ticks = sorted(e["ts"] for e in merged if e.get("name") == "tick")
    first = sorted(e["ts"] for e in spans if e.get("name") == "tick")
    assert n == len(merged) and ticks == sorted(first + [t + 5.0 for t in first])


def test_capture_trace_archive(tmp_path):
    info = load("torch_capture_trace").run(entities=2048, ticks=1, out=tmp_path / "t.tar.gz",
                                           device="cpu")
    assert info["device"] == "cpu" and info["engine"] == 1 and info["bytes"] > 0
    with tarfile.open(tmp_path / "t.tar.gz") as tar:
        assert "trace/trace/trace.json" in tar.getnames()
    # the plain fold runs on the CPU: no hand kernel is in the trace
    assert info["kernels_named"] == {"combat_fold": 0, "fused_neighborhood": 0}


def test_roofline_report_folds_the_tick_stage():
    out = load("torch_roofline_report").run(entities=2000, sessions=8, ticks=10, device="cpu")
    fold = out["roofline"]
    assert fold["platform"] == "cpu" and fold["provisional"]
    tick = fold["stages"]["tick"]
    assert tick["entries"] == ["kernel.step"]
    assert tick["device_s_per_frame"] > 0 and tick["frac_of_peak_bytes"] > 0
    assert out["kernel_step"]["flops"] > 0 and out["kernel_step"]["uncounted_ops"] == {}
    assert "interest" in fold["stages"]


ENTRY_POINTS = {
    "torch_chaos_smoke": lambda m, tmp: m.run(tmp),
    "torch_failover_smoke": lambda m, tmp: m.run(tmp),
    "torch_failover_smoke.surge": lambda m, tmp: m.surge(tmp),
    "torch_persist_smoke": lambda m, tmp: m.run(tmp),
    "torch_replay_smoke": lambda m, tmp: m.run(tmp),
    "torch_pipeline_smoke": lambda m, tmp: m.run(tmp),
    "torch_costbook_smoke": lambda m, tmp: m.run(),
    "torch_telemetry_smoke": lambda m, tmp: m.run(),
    "torch_export_trace": lambda m, tmp: m.run(out=tmp / "t.json"),
    "torch_capture_trace": lambda m, tmp: m.run(entities=64, out=tmp / "t.tar.gz"),
    "torch_roofline_report": lambda m, tmp: m.run(),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_scripts_default_to_cuda(entry, monkeypatch, tmp_path):
    """Without ``device`` every entry point means "cuda" and raises
    without a card: nothing ticks on the CPU unless asked for by name."""
    mod = load(entry.split(".")[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[entry](mod, tmp_path)


@pytest.mark.parametrize("name", ["torch_chaos_smoke", "torch_failover_smoke",
                                  "torch_persist_smoke", "torch_replay_smoke",
                                  "torch_pipeline_smoke", "torch_costbook_smoke",
                                  "torch_telemetry_smoke"])
def test_smoke_main_exits_nonzero_on_a_failed_check(name, monkeypatch, capsys):
    mod = load(name)
    monkeypatch.setattr(mod, "run", lambda *a, **kw: {"held": True, "broken": False})
    monkeypatch.setattr(sys, "argv", [name, "--device", "cpu"])
    assert mod.main() == 1
    assert "FAIL broken" in capsys.readouterr().out
