"""The yardstick: the fold's least time at the benchmark geometries, the
step's least bytes, and a share over 100 % failing the run."""

import pytest

from nfbench import run
from nfbench.metrics import combat_fold_roofline_pct, device_idle_pct, step_hbm_roofline_pct
from nfbench.roofline import fold_bound_s, fold_bytes, step_bytes

from .conftest import tiny_cell


def test_fold_bound_at_1m_is_perf_md_bound():
    # 395 x 395 cells, kv 16, ka 6: 0.0287 ms, bytes-bound
    assert fold_bytes(395 * 395, 16, 6) == 96_111_400
    assert fold_bound_s(395 * 395, 16, 6, pairs=2e6) * 1e3 == pytest.approx(0.0287, abs=5e-5)


def test_fold_bound_for_16k_rooms():
    assert fold_bound_s(16384 * 100, 8, 6) * 1e3 == pytest.approx(0.1917, abs=5e-5)


def test_fold_bound_turns_compute_bound_with_enough_pairs():
    assert fold_bound_s(1, 1, 1, pairs=1e12) == pytest.approx(5e12 / 67e12)


@pytest.mark.parametrize("workload", ["world_1m.frames"])
def test_step_bytes_from_the_config(workload):
    cfg = run.find_cell(run.load_benchmark(), workload)["config"]
    per_row = dict(cfg["step_bytes_per_row"], **{"empty row": cfg["step_bytes_empty_row"]})
    assert set(cfg["step_columns"]) == set(per_row)
    for cname, cols in cfg["step_columns"].items():
        for side in ("read", "written"):
            assert sum(cols[side].values()) == per_row[cname][side]
    total = step_bytes(cfg["rows"], cfg["occupied_rows"], cfg["step_bytes_per_row"],
                       cfg["step_bytes_empty_row"])
    # 1,000,000 NPCs of 1,333 bytes, 48,576 empty NPC rows and 64 empty
    # Player rows of one alive byte each
    assert total == 1_000_000 * 1_333 + 48_576 + 64


def test_empty_rows_cost_their_alive_byte_only():
    per_row = {"NPC": {"read": 10, "written": 5}, "Player": {"read": 7, "written": 3}}
    empty = {"read": 1, "written": 0}
    rows = {"NPC": 100, "Player": 8}
    assert step_bytes(rows, {"NPC": 100, "Player": 8}, per_row, empty) == 1500 + 80
    assert step_bytes(rows, {"NPC": 50, "Player": 0}, per_row, empty) == 750 + 50 + 8
    with pytest.raises(ValueError):
        step_bytes(rows, {"NPC": 101, "Player": 0}, per_row, empty)


def _run(fold_s, busy_s=0.008, frames=10, window_s=0.15):
    found = run.find_cell(run.load_benchmark(), "world_1m.frames")
    # 20 untraced frames of 10 ms around 10 traced frames of 15 ms
    frame_s = [0.010] * 5 + [0.015] * frames + [0.010] * 15
    return {"config": found["config"], "pairs_per_frame": 2e6, "frame_s": frame_s,
            "traced_frames": (5, 5 + frames),
            "trace": {"busy_s": busy_s * frames, "window_s": window_s, "frames": frames,
                      "device_s": {"combat_fold_kernel(float const*)": fold_s * frames}}}


def test_shares_from_a_trace():
    r = _run(fold_s=0.0574e-3)
    assert combat_fold_roofline_pct.read(r) == pytest.approx(50.0, rel=0.01)
    # 1.333 GB at 3.35 TB/s is 0.398 ms of an 8 ms frame
    assert step_hbm_roofline_pct.read(r) == pytest.approx(4.974, abs=0.001)
    assert combat_fold_roofline_pct.read({**r, "trace": None}) is None


def test_idle_share_over_the_untraced_frames():
    # 8 ms busy a frame over the untraced frames' 10 ms; the traced
    # frames' 15 ms (the profiler's own slowing) do not count
    assert device_idle_pct.read(_run(fold_s=1e-5)) == pytest.approx(20.0)
    assert device_idle_pct.read({**_run(fold_s=1e-5), "trace": None}) is None


@pytest.mark.parametrize("workload", ["world_1m.frames"])
def test_a_share_over_100_fails_the_run(workload, monkeypatch, cpu_threads):
    import torch

    import nfbench.metrics.device_idle_pct as m

    monkeypatch.setattr(m, "read", lambda r: 150.0)
    found = tiny_cell(workload)
    with pytest.raises(RuntimeError, match="above 100"):
        run.run_cell(found, 5, 0.2, True, torch.device("cpu"), lambda: 1.0, log=lambda s: None)
