"""Device-side timing: the CudaEventTimer analog (cuda/bench_utils.cu:28-95).

PyTorch counterpart of ``gpuaudiobench_tpu/harness/device_timing.py``,
whose xplane trace method becomes CUDA events. Methods, in order:

1. **cuda-events** (a CUDA device): one event pair on the current stream
   around each ``device_iterate()``, for up to 20 runs after one warm
   run. Before the start event a spin kernel (``torch.cuda._sleep``) of
   ``SPIN_MS`` holds the stream, sized from the SM clock measured once per
   process: the host enqueues the body's launches (the wrappers' checks
   and allocations, each launch) while the spin runs, so the body's
   kernels start back to back behind the start event and the pair
   brackets device work alone. A body that takes longer than the spin to
   enqueue, or that waits for the device inside, still shows its host
   time.
2. **pipeline-slope**: for a benchmark with a stream body and no
   ``device_iterate``, (wall(d2) - wall(d1)) / (d2 - d1) of two chain
   depths, which cancels every fixed cost.
3. **wall**: only for CPU tensors (where the tests run), the host clock
   around ``device_iterate()``; labelled so that no reader takes it for
   a device time.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import torch

from gpuaudiobench_tpu_torch.harness.streaming import measure_saturated_multi

MAX_RUNS = 20  # the reference's trace-size guard (device_timing.py:149)
# The spin that holds the stream while the host enqueues a body: longer
# than the slowest enqueue of a block seen on the H100 (~0.1 ms).
SPIN_MS = 1.0

_SPIN_CYCLES_PER_MS = {}


def spin_cycles_per_ms() -> int:
    """Clock cycles of ``torch.cuda._sleep`` per ms on the current card,
    measured once per process and device with a CUDA event pair."""
    dev = torch.cuda.current_device()
    if dev not in _SPIN_CYCLES_PER_MS:
        cycles = 10_000_000
        torch.cuda._sleep(cycles // 10)  # warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _SPIN_CYCLES_PER_MS[dev] = int(cycles / start.elapsed_time(end))
    return _SPIN_CYCLES_PER_MS[dev]


def event_device_times(body: Callable[[], None], n_runs: int,
                       spin_ms: float = SPIN_MS) -> List[float]:
    """Per-run device times (ms) from a CUDA event pair around each call
    of ``body``, after one warm call, each pair behind a ``spin_ms`` spin
    (``spin_ms=0``: no spin, so the pair also times the enqueue)."""
    body()
    torch.cuda.synchronize()
    cycles = int(spin_ms * spin_cycles_per_ms()) if spin_ms > 0 else 0
    pairs = []
    for _ in range(n_runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if cycles:
            torch.cuda._sleep(cycles)
        start.record()
        body()
        end.record()
        end.synchronize()
        pairs.append(start.elapsed_time(end))
    return pairs


def wall_times(body: Callable[[], None], n_runs: int) -> List[float]:
    """Host-clock times (ms) of ``body`` on the CPU, after one warm call."""
    body()
    out = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        body()
        out.append((time.perf_counter() - t0) * 1000.0)
    return out


def slope_device_times(step_fn: Callable, carry, reps: int,
                       d1: int = 32, d2: int = 256) -> List[float]:
    """Marginal per-block time (ms) by depth differencing of the stream
    body, interleaved within each rep; clamped at 0."""
    per1, per2 = measure_saturated_multi(step_fn, carry, [d1, d2],
                                         reps=max(1, reps))
    return [max(0.0, (b2 * d2 - b1 * d1) / (d2 - d1))
            for b1, b2 in zip(per1, per2)]


def measure_device_times(benchmark, cfg) -> Tuple[Optional[List[float]], str]:
    """Best device timing for one benchmark: (latencies_ms, method)."""
    n = min(cfg.n_runs, MAX_RUNS)
    on_cuda = benchmark.device.type == "cuda"
    try:
        if on_cuda:
            return event_device_times(benchmark.device_iterate, n), "cuda-events"
        return wall_times(benchmark.device_iterate, n), "wall"
    except NotImplementedError:
        pass
    body = benchmark.stream_body()
    if body is None:
        return None, "unsupported"
    reps = min(cfg.saturated_reps, max(3, n // 4))
    return slope_device_times(*body, reps=reps), "pipeline-slope"
