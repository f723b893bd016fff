"""Benchmark base class: the plugin API of the suite.

PyTorch counterpart of ``gpuaudiobench_tpu/harness/base.py``. The
reference's four override points (setupBenchmark / runKernel /
performBenchmarkIteration / validate) map to:

* ``setup()``      -- generate seeded host data, place it on the device,
                      compute the NumPy golden.
* ``iterate()``    -- ONE measured iteration: device compute plus the
                      output's copy back to the host (which waits for the
                      device). This is the hot path timed by the runner.
* ``device_iterate()`` -- device compute on resident buffers, enqueued
                      on the current stream; the caller waits (the
                      device tier records CUDA events around it).
* ``validate()``   -- compare the last iteration's host output against
                      the golden with the benchmark's tolerance/metric.

Every benchmark holds the ``torch.device`` it runs on; nothing uses a
global default device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.statistics import LatencyStats
from gpuaudiobench_tpu_torch.harness.validation import ValidationData


@dataclasses.dataclass
class BenchmarkResult:
    benchmark_name: str = ""
    buffer_size: int = 0
    track_count: int = 0
    iterations: int = 0
    latencies: List[float] = dataclasses.field(default_factory=list)
    statistics: LatencyStats = dataclasses.field(default_factory=LatencyStats)
    # Device tier (harness/device_timing.py): per-run device times and
    # how they were taken ("cuda-events", "pipeline-slope", or "wall" on
    # the CPU).
    device_latencies: List[float] = dataclasses.field(default_factory=list)
    device_statistics: Optional[LatencyStats] = None
    device_timing_method: str = ""
    # Derived performance metrics (cuda/bench_base.cu:110-115).
    bytes_processed: int = 0
    mean_latency_ms: float = 0.0
    throughput_gbps: float = 0.0
    samples_per_sec: float = 0.0
    # Validation outcome + per-benchmark metadata.
    validation: Optional[ValidationData] = None
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Saturated/streaming pass (pipeline_depth): wall per block with
    # ``depth`` blocks chained between two host synchronisations.
    pipeline_depth: int = 0
    saturated_latencies: List[float] = dataclasses.field(default_factory=list)
    saturated_statistics: Optional[LatencyStats] = None
    # Marginal tier: depth-differenced per-block cost, with every
    # depth-independent cost (launch queue fill, the probe read) cancelled.
    saturated_lo_depth: int = 0
    saturated_marginal_latencies: List[float] = dataclasses.field(
        default_factory=list)
    saturated_marginal_statistics: Optional[LatencyStats] = None
    # DAW-sim pacing (harness/dawsim.py): the percentage of timed
    # iterations past the buffer deadline, and the pacer that ran
    # ("native" | "python").
    deadline_miss_rate: Optional[float] = None
    dawsim_pacer: Optional[str] = None
    # Overlapped-infeed pass (overlap_depth): per-block ms with the input
    # upload double-buffered against compute, and the serial twin
    # measured in the same reps (harness/overlap.py).
    overlap_depth: int = 0
    overlap_serial_latencies: List[float] = dataclasses.field(
        default_factory=list)
    overlap_latencies: List[float] = dataclasses.field(default_factory=list)
    overlap_serial_statistics: Optional[LatencyStats] = None
    overlap_statistics: Optional[LatencyStats] = None


class Benchmark:
    """Base class for all benchmark workloads."""

    name: str = "Benchmark"

    def __init__(self, cfg: BenchConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.buffer_size = cfg.buffer_size
        self.track_count = cfg.n_tracks
        self._allocations: Dict[str, int] = {}

    def resolve_impl(self) -> str:
        """``"cuda-kernel"`` (the hand kernel) exactly on a CUDA device,
        ``"torch-plain"`` (the plain PyTorch twin) on the CPU. Impl xla
        on a CUDA device raises: the plain twin never runs the main path
        on the card."""
        if self.device.type == "cpu":
            return "torch-plain"
        if self.device.type != "cuda":
            raise ValueError(f"{self.name}: no implementation for {self.device}")
        if self.cfg.impl == "xla":
            raise ValueError(
                f"{self.name}: impl 'xla' (the plain PyTorch twin) does not "
                "run on a CUDA device; call the twin directly to A/B it")
        return "cuda-kernel"

    # -- allocation tracking (BufferManager.totalMemoryAllocated analog) --
    def track_alloc(self, name: str, nbytes: int) -> None:
        self._allocations[name] = int(nbytes)

    def memory_report(self) -> Dict[str, int]:
        if not self._allocations:
            return {}
        report = dict(self._allocations)
        report["totalBytes"] = sum(self._allocations.values())
        return report

    # -- lifecycle ---------------------------------------------------------
    def setup(self) -> None:
        raise NotImplementedError

    def iterate(self) -> None:
        raise NotImplementedError

    def device_iterate(self) -> None:
        """Device-only compute on resident buffers, enqueued on the
        current stream without waiting (the caller synchronises)."""
        raise NotImplementedError

    def stream_body(self):
        """Optional streaming hook (pipeline_depth): return
        ``(step_fn, carry)`` where ``step_fn(carry) -> (carry', probe)``
        runs ONE block on device-resident data, carrying state where the
        benchmark has it, and ``probe`` is a (1,) tensor
        (``streaming.probe``). None = unsupported.

        On a CUDA device the saturated tier captures ``depth`` steps as
        one CUDA graph (``harness/graph.py:ChainGraph``) unless
        ``stream_capturable`` is False. A capturable step never waits for
        the device (no ``.item()``, no read to the host, no branch on a
        tensor's value), allocates the same shapes on every call, and
        keeps its Python state (a ring head, a phase) in the carry, where
        only the step advances it: the graph fixes every Python value as
        the capture saw it."""
        return None

    # Whether stream_body's step obeys the capture rules above; a body
    # that does not runs the saturated tier as a loop of host launches.
    stream_capturable: bool = True

    def overlap_body(self):
        """Optional overlapped-infeed hook (overlap_depth): return
        ``(step_fn, host_blocks, carry)`` where ``step_fn(x_dev, carry)
        -> (y, carry')`` runs ONE block of device compute on an uploaded
        input block, ``host_blocks`` is a list of >= 2 distinct host
        payloads (numpy arrays or pinned tensors) of one shape cycled
        across blocks, and ``carry`` is the initial device-resident state
        (() for stateless blocks). The harness measures serial against
        double-buffered steady state (harness/overlap.py). None =
        unsupported (e.g. modal synthesis, which uploads nothing per
        block)."""
        return None

    def validate(self) -> ValidationData:
        raise NotImplementedError

    def metadata(self) -> Dict[str, Any]:
        return {}

    def cost_model(self):
        """Algorithmic per-block cost: {"flops", "hbm_bytes", "unit"} or
        None. flops = required arithmetic; hbm_bytes = minimum device
        memory traffic assuming perfect on-chip reuse."""
        return None

    def transfer_model(self) -> Dict[str, int]:
        """Per-iteration host<->device traffic of one ``iterate()``.
        Default = the standard in/out buffer pair."""
        n4 = self.total_elements() * 4
        return {"h2d_bytes": n4, "d2h_bytes": n4}

    def cleanup(self) -> None:
        pass

    # -- metrics helpers ---------------------------------------------------
    def total_elements(self) -> int:
        return self.buffer_size * self.track_count

    def bytes_processed(self) -> int:
        """Bytes counted for throughput (bench_base.cu:110-111)."""
        return self.total_elements() * 4
