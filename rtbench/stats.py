"""The benchmark's own statistics: frozen copies, so that a change to the
program cannot change how it is measured.

``interpolated_percentile`` is a copy of
``gpuaudiobench_tpu_torch/harness/statistics.py:interpolated_percentile``
(cuda/bench_utils.cu:396-409): linear interpolation over (n-1)-scaled
indices. ``merged`` is the busy-time union of
``gpuaudiobench_tpu_torch/harness/profiler.py:summarize``.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def interpolated_percentile(sorted_vals: Sequence[float], p: float) -> float:
    """Linear-interpolated percentile of ascending ``sorted_vals``."""
    n = len(sorted_vals)
    if n == 0:
        raise ValueError("percentile of no values")
    index = p / 100.0 * (n - 1)
    lower = int(math.floor(index))
    upper = int(math.ceil(index))
    if lower == upper:
        return sorted_vals[lower]
    weight = index - lower
    return sorted_vals[lower] * (1.0 - weight) + sorted_vals[upper] * weight


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of closed intervals (start, end) as disjoint intervals in
    ascending order."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out
