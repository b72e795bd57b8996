"""The end-to-end arithmetic over synthetic frame times: the rate takes
all the work and all the time, the p95 every frame; one stall moves
both."""

import pytest

from nfbench.metrics import entity_ticks_per_s, frame_ms_p95
from nfbench.stats import percentile, rate, spread


def window(frame_s, entities=1000):
    return {"entities": entities, "frames": len(frame_s), "window_s": sum(frame_s),
            "frame_s": frame_s}


def test_rate_is_all_work_over_all_time():
    assert rate(1_000_000, 120, 1.0) == 120_000_000
    with pytest.raises(ValueError):
        rate(1, 1, 0.0)


def test_percentile_interpolates_between_ranks():
    xs = list(range(1, 101))
    assert percentile(xs, 95) == pytest.approx(95.05)
    assert percentile([5.0], 95) == 5.0


def test_stalls_move_rate_and_p95():
    steady = [0.010] * 400
    stalled = list(steady)
    for i in range(0, 400, 19):
        stalled[i] = 0.060
    a, b = window(steady), window(stalled)
    assert entity_ticks_per_s.read(b) < entity_ticks_per_s.read(a)
    assert frame_ms_p95.read(b) > frame_ms_p95.read(a) * 2
    assert frame_ms_p95.read(a) == pytest.approx(10.0)


def test_spread_is_the_quartile_gap_over_the_median():
    assert spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert spread([9.0, 10.0, 10.0, 11.0]) == pytest.approx(0.15)
