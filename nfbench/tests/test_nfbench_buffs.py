"""The buff fold's yardstick and reader: the least bytes at the 1M
configuration, the share from a trace, and nothing to read where no
``buff_fold_kernel`` ran (a program without the kernel)."""

import pytest

from nfbench import run
from nfbench.metrics import buff_fold_roofline_pct
from nfbench.roofline_buffs import buff_fold_bound_s, buff_fold_bytes


def _config():
    return run.find_cell(run.load_benchmark(), "world_1m.middleware")["config"]


def test_fold_bytes_at_1m():
    cfg = _config()
    # 2^20 NPC rows and 64 Player rows, 72 B read and 124 B written each
    assert buff_fold_bytes(cfg["rows"], cfg["buff_fold_bytes_per_row"]) == (2**20 + 64) * 196
    assert buff_fold_bound_s(cfg["rows"], cfg["buff_fold_bytes_per_row"]) * 1e3 == pytest.approx(
        0.06135, abs=5e-6)


def test_share_from_a_trace():
    run_ = {"config": _config(),
            "trace": {"frames": 10, "device_s": {
                "(anonymous namespace)::buff_fold_kernel(int const*, unsigned char const*)":
                    10 * 0.1226e-3,
                "memcpy32_post": 1.0}}}
    assert buff_fold_roofline_pct.read(run_) == pytest.approx(50.0, rel=0.01)
    assert buff_fold_roofline_pct.read({**run_, "trace": None}) is None
    assert buff_fold_roofline_pct.read(
        {**run_, "trace": {"frames": 10, "device_s": {"memcpy32_post": 1.0}}}) is None
