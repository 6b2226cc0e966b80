"""Latency samples and the statistics the benchmark reports."""

from __future__ import annotations

import math
import statistics
from typing import Sequence

import numpy as np


def block_latencies(due: np.ndarray, arrived: np.ndarray, t_close: float) -> np.ndarray:
    """Seconds from each block's due time to the arrival of its reply's
    last byte.  A block with no reply by the window's close (`t_close`) is
    missing: its sample is the larger of the time from its due time to the
    close and the slowest answered block, so it sorts above every answered
    one.  `due` and `arrived` hold every block due in the window, NaN where
    no reply came."""
    due = np.asarray(due, np.float64)
    arrived = np.asarray(arrived, np.float64)
    answered = np.isfinite(arrived) & (arrived <= t_close)
    lat = np.where(answered, arrived - due, np.nan)
    slowest = float(np.max(lat[answered])) if answered.any() else 0.0
    missing = np.maximum(t_close - due, slowest)
    return np.where(answered, lat, missing)


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The q-quantile by nearest rank: a value that was observed."""
    v = np.sort(np.asarray(values, np.float64))
    if v.size == 0:
        raise ValueError("no samples")
    return float(v[max(0, math.ceil(q * v.size) - 1)])


def spread(values: Sequence[float]) -> float:
    """(Q3 − Q1) / median, quartiles as statistics.quantiles(n=4) gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
