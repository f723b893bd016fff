"""Elementwise and reduction ops of the basic tier and the datacopy
family: no-op copy, gain, gain plus per-track statistics, data transfer.

PyTorch counterpart of ``gpuaudiobench_tpu/ops/elementwise.py``, which
has no Pallas kernel: these are plain PyTorch, as they were plain XLA.

* ``copy_op``: out = in, materialized (NoOpKernel, cuda/bench_noop.cu:9-16).
* ``gain_op``: out = gain * in (GainKernel, cuda/bench_gain.cu:6-24).
* ``gain_stats_op``: out = gain * in plus per-track [mean, max] of the
  *input* (GainStatsKernel, cuda/bench_gainstats.cu:7-31).
* ``data_transfer_op``: copy the input portion, synthesize
  0.5 + 0.5*sin(i*0.001) beyond it (DataTransferKernel,
  cuda/bench_datatransfer.cu:15-25).
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def data_transfer_op(x: torch.Tensor, out_size: int, lo: int = 0,
                     hi: Optional[int] = None) -> torch.Tensor:
    """out[i] = x[i] for i < len(x), else 0.5 + 0.5*sin(i*0.001), in
    float32, for i in [lo, hi) (hi None: out_size); x is the 1-D input
    portion. The result is a fresh tensor even where it only copies x.
    The index i is the float32 of an int32 iota: past 2^24 it rounds to
    the nearest float32, as ``np.arange(n, dtype=np.float32)`` and the
    reference's iota do."""
    hi = out_size if hi is None else hi
    in_size = x.shape[0]
    if hi <= in_size:
        return x[lo:hi].clone()
    start = max(lo, in_size)
    idx = torch.arange(start, hi, dtype=torch.int32, device=x.device)
    synth = 0.5 + 0.5 * torch.sin(idx.to(torch.float32) * 0.001)
    return torch.cat([x[lo:start], synth])
