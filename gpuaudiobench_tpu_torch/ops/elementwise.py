"""Elementwise and reduction ops of the basic tier: no-op copy, gain, gain
plus per-track statistics.

PyTorch counterpart of ``gpuaudiobench_tpu/ops/elementwise.py``, which
has no Pallas kernel: these are plain PyTorch, as they were plain XLA.

* ``copy_op``: out = in, materialized (NoOpKernel, cuda/bench_noop.cu:9-16).
* ``gain_op``: out = gain * in (GainKernel, cuda/bench_gain.cu:6-24).
* ``gain_stats_op``: out = gain * in plus per-track [mean, max] of the
  *input* (GainStatsKernel, cuda/bench_gainstats.cu:7-31).

``data_transfer_op`` comes with the datacopy benchmarks (ROADMAP.md
queue 1, item 5).
"""

from __future__ import annotations

from typing import Tuple

import torch


def copy_op(x: torch.Tensor) -> torch.Tensor:
    """Validatable no-op: a fresh copy of x."""
    return x.clone()


def gain_op(x: torch.Tensor, gain: float) -> torch.Tensor:
    return gain * x


def gain_stats_op(x: torch.Tensor,
                  gain: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (tracks, S) -> (gain * x, stats (tracks, 2)) with
    stats[t] = [mean(x[t]), max(x[t])] (NSTATS = 2)."""
    stats = torch.stack([x.mean(dim=1), x.amax(dim=1)], dim=1)
    return gain * x, stats
