"""The end-to-end arithmetic against hand counts: rates over the whole
window, the tail over every request, and a window with a stall that a
median of chunks would hide."""

import statistics

import numpy as np
import pytest

from benchmark.harness import report, stats


def readings(unit_s, batch):
    starts, t = [], 0.0
    for d in unit_s:
        starts.append(t)
        t += d
    lat = [d for d in unit_s for _ in range(batch)]
    return dict(setup_s=50.0, requests=batch * len(unit_s), window_s=t,
                latencies_s=lat)


def test_rate_is_all_work_over_all_time():
    r = readings([2.0] * 10, 12)
    assert report.E2E["answers_per_s"](r) == pytest.approx(120 / 20.0)
    assert report.E2E["images_per_s"](readings([4.0] * 5, 8)) \
        == pytest.approx(2.0)


def test_a_stall_shows():
    steady = readings([2.0] * 20, 12)
    stalled = readings([2.0] * 19 + [20.0], 12)
    # a median of per-unit rates reads the same for both windows
    assert statistics.median([12 / 2.0] * 19 + [12 / 20.0]) == 6.0
    assert report.E2E["answers_per_s"](steady) == pytest.approx(6.0)
    assert report.E2E["answers_per_s"](stalled) == pytest.approx(240 / 58)
    # the stalled unit's 12 requests are the top 5% of 240
    assert report.E2E["answer_ms_p95"](stalled) > 2000.0


def test_percentile_matches_numpy():
    rng = np.random.RandomState(0)
    xs = list(rng.rand(277))
    for q in (50, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)))
    assert stats.percentile([3.0], 95) == 3.0


def test_p95_by_hand():
    lat = [1.0] * 19 + [2.0]
    # rank (20 - 1) * 0.95 = 18.05: 5% of the way from 1.0 to 2.0
    assert stats.percentile(lat, 95) == pytest.approx(1.05)


def test_empty_window():
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    with pytest.raises(ValueError):
        stats.percentile([], 95)
