"""Iteration runner: warmup -> timed loop (DAW-sim paced when asked) ->
device tier -> saturated pass -> overlapped-infeed pass -> statistics ->
validation, all inside a ``torch.profiler`` trace under ``capture``.

PyTorch counterpart of ``gpuaudiobench_tpu/harness/runner.py`` (port of
GPUABenchmark::runWithIteration, cuda/bench_base.cu:59-118). Timing is
wall clock around one iteration that ends in a copy of the output to
the host, which waits for the device: the reference's measurement
boundary around transfer, launch, sync and transfer back.

On CUDA, warmup also absorbs the kernels' build and first load, the
saturated tier runs each depth's chain as one CUDA graph where the body
is capturable (``metadata.chainForm``: "cuda-graph" or "loop"), and the
metadata gains the ``roofline`` section (``roofline_section``). Each
tier runs inside a ``torch.profiler.record_function`` range named after
the reference's phase ("warmup", "timed", "device-timing", "saturated",
"overlap", "validate"), so a ``capture`` trace shows where each begins
and ends.

Under ``data_parallel`` > 1 every rank runs every tier in the same
order (a rank that skipped a collective would leave the others
waiting): the device tier times the rank's own device, the round trip
includes the gather of the output, validation reads the whole host
output, the overlapped-infeed tier is skipped as the reference skips
it, and ``metadata.collectiveInventory`` lists the collectives the first
timed round trip issued (``parallel.collectives.COLLECTIVES``), where
the JAX package writes its interconnect model.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch
from torch.profiler import record_function

from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.base import Benchmark, BenchmarkResult
from gpuaudiobench_tpu_torch.harness.dawsim import deadline_miss_rate
from gpuaudiobench_tpu_torch.harness.device_timing import measure_device_times
from gpuaudiobench_tpu_torch.harness.overlap import measure_overlap
from gpuaudiobench_tpu_torch.harness.profiler import capture_trace, trace_dir
from gpuaudiobench_tpu_torch.harness.statistics import calculate_statistics
from gpuaudiobench_tpu_torch.harness.streaming import (
    chain_form,
    measure_saturated,
    measure_saturated_marginal,
)
from gpuaudiobench_tpu_torch.parallel.collectives import COLLECTIVES
from gpuaudiobench_tpu_torch.utils.native import make_dawsim
from gpuaudiobench_tpu_torch.utils.roofline import roofline_metrics


def roofline_section(benchmark: Benchmark, result: BenchmarkResult):
    """The algorithmic cost over the measured time of a block against the
    card's peaks (``utils/roofline.py``), or None. The block time is the
    first above 0 of the device tier (CUDA events behind a spin, or the
    pipeline slope), the saturated marginal and the saturated amortized
    p50; ``basis`` names it. Only on a CUDA device: a CPU run gets no
    share of the card's peaks."""
    if benchmark.device.type != "cuda":
        return None
    cost = benchmark.cost_model()
    if cost is None:
        return None
    candidates = []
    if (result.device_statistics is not None
            and result.device_timing_method in ("cuda-events",
                                                "pipeline-slope")):
        candidates.append((result.device_statistics.median,
                           f"device:{result.device_timing_method}"))
    if result.saturated_marginal_statistics is not None:
        candidates.append((result.saturated_marginal_statistics.median,
                           "saturated-marginal"))
    if result.saturated_statistics is not None:
        candidates.append((result.saturated_statistics.median, "saturated"))
    block_ms, basis = next(((ms, b) for ms, b in candidates if ms > 0),
                           (0.0, ""))
    if block_ms <= 0:
        return None
    rl = roofline_metrics(
        cost, block_ms,
        device_kind=torch.cuda.get_device_name(benchmark.device))
    rl["basis"] = basis
    return rl


def run_benchmark(
    benchmark: Benchmark,
    cfg: Optional[BenchConfig] = None,
    verbose: bool = True,
    progress_cb: Optional[Callable[[str], None]] = None,
) -> BenchmarkResult:
    """``progress_cb``, when given, is called with the name of each tier
    as it starts ("warmup", "timed", "device-timing", "saturated",
    "overlap", "validate"), the reference's phases; an exception in it is
    ignored (the web UI shows the phase of a running job)."""
    cfg = cfg or benchmark.cfg
    if cfg.data_parallel > 1 and not benchmark._dp_ready:
        raise ValueError(
            f"{benchmark.name} does not support --dataParallel "
            "(no sharded axis declared in setup)"
        )
    capture = (capture_trace(trace_dir(cfg.capture_dir), benchmark.device,
                             benchmark.name)
               if cfg.capture else contextlib.nullcontext())
    with capture:
        return _run(benchmark, cfg, verbose, progress_cb)


def _run(benchmark: Benchmark, cfg: BenchConfig, verbose: bool,
         progress_cb: Optional[Callable[[str], None]]) -> BenchmarkResult:
    def phase(name: str) -> None:
        if progress_cb is not None:
            try:
                progress_cb(name)
            except Exception:  # noqa: BLE001 - progress is best-effort
                pass

    result = BenchmarkResult(
        benchmark_name=benchmark.name,
        buffer_size=benchmark.buffer_size,
        track_count=benchmark.track_count,
        iterations=cfg.n_runs,
    )

    # Warmup (bench_base.cu:70-81). An exception here propagates: a
    # failing iteration is a fault, not noise to be timed around.
    if cfg.warmup > 0:
        phase("warmup")
        if verbose:
            print(f"Running {cfg.warmup} warmup iterations...")
        with record_function("warmup"):
            for _ in range(cfg.warmup):
                benchmark.iterate()
        if verbose:
            print("Warmup complete, starting timed iterations...")

    # Timed iterations (bench_base.cu:89-94), each paced to the next
    # buffer boundary under DAW-sim (the wait is outside the timing).
    daw = None
    if cfg.dawsim:
        daw = make_dawsim(cfg.buffer_size, cfg.fs, cfg.dawsim_mode,
                          cfg.dawsim_jitter_us, cfg.seed)
        result.dawsim_pacer = daw.pacer
        daw.reset()
    latencies = []
    inventory = None
    phase("timed")
    with record_function("timed"):
        for _ in range(cfg.n_runs):
            if daw is not None:
                daw.wait()
            mark = len(COLLECTIVES)
            t0 = time.perf_counter()
            benchmark.iterate()
            latencies.append((time.perf_counter() - t0) * 1000.0)
            if inventory is None:
                inventory = [dict(c) for c in COLLECTIVES[mark:]]
    result.latencies = latencies
    result.statistics = calculate_statistics(latencies)

    # Device tier: CUDA events around device_iterate() on resident
    # buffers (harness/device_timing.py).
    if cfg.device_timing:
        phase("device-timing")
        with record_function("device-timing"):
            dev_latencies, method = measure_device_times(benchmark, cfg)
        if dev_latencies:
            result.device_latencies = dev_latencies
            result.device_statistics = calculate_statistics(dev_latencies)
            result.device_timing_method = method

    # Saturated/streaming pass: per-block cost with the launch queue kept
    # full (pipeline_depth chained blocks, state carried), each depth's
    # chain one CUDA graph where the body is capturable.
    form = None
    if cfg.pipeline_depth > 1:
        body = benchmark.stream_body()
        if body is None:
            if verbose:
                print(f"Note: {benchmark.name} has no streaming mode "
                      "(round-trip is the workload); skipping saturated pass.")
        else:
            step_fn, carry = body
            form = chain_form(benchmark.device, benchmark.stream_capturable)
            result.pipeline_depth = cfg.pipeline_depth
            phase("saturated")
            with record_function("saturated"):
                if cfg.saturated_marginal and cfg.pipeline_depth >= 4:
                    sat, marg, lo = measure_saturated_marginal(
                        step_fn, carry, cfg.pipeline_depth,
                        cfg.saturated_reps, form=form, name=benchmark.name,
                    )
                    result.saturated_lo_depth = lo
                    result.saturated_marginal_latencies = marg
                    result.saturated_marginal_statistics = (
                        calculate_statistics(marg))
                else:
                    sat = measure_saturated(
                        step_fn, carry, cfg.pipeline_depth,
                        cfg.saturated_reps, form=form, name=benchmark.name,
                    )
            result.saturated_latencies = sat
            result.saturated_statistics = calculate_statistics(sat)

    # Overlapped-infeed pass: the input upload double-buffered against
    # compute, beside its serial twin in the same reps.
    if cfg.overlap_depth > 1 and cfg.data_parallel > 1:
        if verbose:
            print("Note: overlapped-infeed pass is single-device "
                  "(uploads target one chip's HBM); skipping under "
                  "--dataParallel.")
    elif cfg.overlap_depth > 1:
        body = benchmark.overlap_body()
        if body is None:
            if verbose:
                print(f"Note: {benchmark.name} has no per-block input "
                      "upload; skipping overlapped-infeed pass.")
        else:
            step_fn, host_blocks, carry = body
            phase("overlap")
            with record_function("overlap"):
                ser, ovl = measure_overlap(step_fn, host_blocks, carry,
                                           cfg.overlap_depth,
                                           cfg.overlap_reps,
                                           benchmark.device)
            result.overlap_depth = cfg.overlap_depth
            result.overlap_serial_latencies = ser
            result.overlap_latencies = ovl
            result.overlap_serial_statistics = calculate_statistics(ser)
            result.overlap_statistics = calculate_statistics(ovl)

    # Derived metrics (bench_base.cu:110-115).
    result.bytes_processed = benchmark.bytes_processed()
    result.mean_latency_ms = result.statistics.mean
    if result.mean_latency_ms > 0:
        mean_sec = result.mean_latency_ms / 1000.0
        result.throughput_gbps = (result.bytes_processed / (1024.0**3)) / mean_sec
        result.samples_per_sec = benchmark.total_elements() / mean_sec
    if cfg.dawsim:
        result.deadline_miss_rate = deadline_miss_rate(
            latencies, cfg.buffer_size, cfg.fs)

    phase("validate")
    with record_function("validate"):
        result.validation = benchmark.validate()
    result.metadata = benchmark.metadata()
    if form is not None:
        result.metadata["chainForm"] = form
    if benchmark.dp_ranks > 1:
        result.metadata["collectiveInventory"] = inventory or []
    roofline = roofline_section(benchmark, result)
    if roofline is not None:
        result.metadata["roofline"] = roofline
    # The reference's co-located projection exists only for its relay and
    # is not ported.
    mem = benchmark.memory_report()
    if mem:
        result.metadata["memory"] = mem
    return result
