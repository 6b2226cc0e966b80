"""Latency samples: timed from the due time; a missing block sorts above
every answered one; quantiles by nearest rank; the quartile spread."""

import math

import numpy as np

from benchmark.lib import stats


def test_latency_is_from_due_time_and_missing_sorts_above():
    due = np.array([0.0, 0.01, 0.02, 0.03])
    arrived = np.array([0.004, 0.05, np.nan, 0.2])  # the last comes after the close
    lat = stats.block_latencies(due, arrived, t_close=0.1)
    assert lat[0] == 0.004 and math.isclose(lat[1], 0.04)
    # missing: the larger of due → close and the slowest answered block
    assert math.isclose(lat[2], 0.08) and math.isclose(lat[3], 0.07)
    assert min(lat[2], lat[3]) >= max(lat[0], lat[1])


def test_missing_block_due_at_the_close_still_sorts_above():
    due = np.array([0.0, 0.099])
    lat = stats.block_latencies(due, np.array([0.05, np.nan]), t_close=0.1)
    assert lat[1] >= lat[0] == 0.05


def test_nearest_rank_returns_an_observed_value():
    v = list(range(1, 101))
    assert stats.nearest_rank(v, 0.99) == 99
    assert stats.nearest_rank(v, 0.50) == 50
    assert stats.nearest_rank([3.0], 0.99) == 3.0


def test_spread_uses_statistics_quartiles():
    assert math.isclose(stats.spread([1, 2, 3, 4, 5, 6]), (5.25 - 1.75) / 3.5)
