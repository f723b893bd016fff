"""Saturated/streaming measurement: ``depth`` chained blocks per timing.

PyTorch counterpart of ``gpuaudiobench_tpu/harness/streaming.py``. The
chip's steady-state capability is the per-block cost with the launch
queue kept full: ``depth`` calls of the benchmark's ``step_fn`` with
state carried from block to block, each emitting a (1,) probe of its
output. The probes are stacked and copied to the host in ONE read,
which waits for the device (the counterpart of
``np.asarray(chained(carry))``), so the wall time covers all the work.

The chain here is a Python loop that launches every block from the host;
capturing the depth in one CUDA graph (the counterpart of the
reference's single ``lax.scan`` executable) is left for a later change.

PyTorch runs eagerly, so nothing can hoist a loop-invariant block: every
``step_fn`` call launches its kernels.
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import torch


def probe(y: torch.Tensor) -> torch.Tensor:
    """Tiny per-block residue: mean |value| of the output block, (1,).
    It keeps every output element in use and gives soaks a
    state-integrity signal that tracks the whole block. The mean is taken
    in float32, so an integer output (SOL_MXU_int8) has a probe too."""
    return torch.mean(torch.abs(y), dtype=torch.float32).reshape(1)


def run_chained(step_fn: Callable, carry, depth: int) -> torch.Tensor:
    """Run ``depth`` chained blocks from ``carry``; returns the stacked
    probes on the host, which waits for the device."""
    probes = []
    for _ in range(depth):
        carry, p = step_fn(carry)
        probes.append(p)
    return torch.cat(probes).cpu()


def measure_saturated(
    step_fn: Callable,
    carry,
    depth: int,
    reps: int = 5,
) -> List[float]:
    """Per-block wall latencies (ms) over ``reps`` runs of a
    ``depth``-block chain, after one untimed warm pass."""
    return measure_saturated_multi(step_fn, carry, [depth], reps)[0]


def measure_saturated_marginal(
    step_fn: Callable,
    carry,
    depth: int,
    reps: int = 5,
    lo_depth: int = 0,
) -> Tuple[List[float], List[float], int]:
    """Amortized AND marginal per-block cost from one interleaved
    two-depth measurement: ``(amortized_ms, marginal_ms, lo_depth)``.

    * ``amortized_ms[i]`` = wall(depth)/depth for rep i.
    * ``marginal_ms[i]`` = (wall(depth) - wall(lo_depth)) /
      (depth - lo_depth) for rep i: every depth-independent cost (the
      probe read and its synchronisation, the first launches) cancels.

    Per-rep marginals of sub-noise bodies can go slightly negative; they
    are reported raw.
    """
    lo = lo_depth or max(1, depth // 4)
    if lo >= depth:
        raise ValueError(f"lo_depth ({lo}) must be < depth ({depth})")
    per_lo, per_hi = measure_saturated_multi(
        step_fn, carry, [lo, depth], reps
    )
    marginal = [
        (h * depth - l * lo) / (depth - lo)
        for l, h in zip(per_lo, per_hi)
    ]
    return per_hi, marginal, lo


def measure_saturated_multi(
    step_fn: Callable,
    carry,
    depths: List[int],
    reps: int = 5,
) -> List[List[float]]:
    """Per-block wall latencies (ms) for SEVERAL chain depths, timed
    round-robin WITHIN each rep (d1, d2, d1, d2, ...) so drift over the
    window cancels in depth-differencing consumers. One untimed warm
    pass per depth comes before any timing. Returns one latency list per
    depth, in the order of ``depths``."""
    for d in depths:
        run_chained(step_fn, carry, d)

    out: List[List[float]] = [[] for _ in depths]
    for _ in range(max(1, reps)):
        for i, d in enumerate(depths):
            t0 = time.perf_counter()
            run_chained(step_fn, carry, d)
            out[i].append((time.perf_counter() - t0) / d * 1000.0)
    return out
