"""Latency statistics.

A copy of ``calculate_statistics`` from
``gpuaudiobench_tpu/harness/statistics.py`` (the reference's
cuda/bench_utils.cu:358-414): mean, median (mid-pair average for even
n), sample std-dev (n-1), min/max, and linearly interpolated p95/p99
over (n-1)-scaled indices; and of the JSON writer's ``csv_percentile``,
``detect_outliers`` and ``stability_rating``. Kept here so the port
never imports the reference package; ``tests/test_torch_harness.py``
and ``tests/test_torch_cli.py`` hold them equal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass
class LatencyStats:
    mean: float = 0.0
    median: float = 0.0
    std_dev: float = 0.0
    min_val: float = 0.0
    max_val: float = 0.0
    p95: float = 0.0
    p99: float = 0.0
    count: int = 0


def interpolated_percentile(sorted_vals: Sequence[float], p: float) -> float:
    """Linear-interpolated percentile (cuda/bench_utils.cu:396-409)."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    index = p / 100.0 * (n - 1)
    lower = int(math.floor(index))
    upper = int(math.ceil(index))
    if lower == upper:
        return sorted_vals[lower]
    weight = index - lower
    return sorted_vals[lower] * (1.0 - weight) + sorted_vals[upper] * weight


def csv_percentile(sorted_vals: Sequence[float], p: float) -> float:
    """Truncated-index percentile of the JSON writer
    (cuda/globals.cu:86-88): sorted[int(n*p)], clamped to the last."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    return sorted_vals[min(int(n * p), n - 1)]


def detect_outliers(values: Sequence[float], k: float = 1.5):
    """IQR outliers: (outliers, low_fence, high_fence)."""
    if len(values) < 4:
        return [], 0.0, 0.0
    s = sorted(values)
    q1 = interpolated_percentile(s, 25.0)
    q3 = interpolated_percentile(s, 75.0)
    lo, hi = q1 - k * (q3 - q1), q3 + k * (q3 - q1)
    return [v for v in values if v < lo or v > hi], lo, hi


def stability_rating(values: Sequence[float]):
    """(coefficient of variation %, rating): < 5 excellent, < 15 good,
    < 30 fair, else poor."""
    stats = calculate_statistics(values)
    if stats.mean == 0:
        return 0.0, "n/a"
    cv = stats.std_dev / stats.mean * 100.0
    for limit, rating in ((5.0, "excellent"), (15.0, "good"), (30.0, "fair")):
        if cv < limit:
            return cv, rating
    return cv, "poor"


def calculate_statistics(latencies: Sequence[float]) -> LatencyStats:
    n = len(latencies)
    if n == 0:
        return LatencyStats()
    sorted_vals = sorted(latencies)
    mean = sum(latencies) / n

    mid = n // 2
    if n % 2 == 0:
        median = (sorted_vals[mid - 1] + sorted_vals[mid]) / 2.0
    else:
        median = sorted_vals[mid]

    if n > 1:
        variance = sum((v - mean) ** 2 for v in latencies) / (n - 1)
    else:
        variance = 0.0

    return LatencyStats(
        mean=mean,
        median=median,
        std_dev=math.sqrt(variance),
        min_val=sorted_vals[0],
        max_val=sorted_vals[-1],
        p95=interpolated_percentile(sorted_vals, 95.0),
        p99=interpolated_percentile(sorted_vals, 99.0),
        count=n,
    )
