"""Benchmark base class: the plugin API of the suite.

PyTorch counterpart of ``gpuaudiobench_tpu/harness/base.py``. The
reference's four override points (setupBenchmark / runKernel /
performBenchmarkIteration / validate) map to:

* ``setup()``      -- generate seeded host data, place it on the device,
                      compute the NumPy golden.
* ``iterate()``    -- ONE measured iteration: device compute plus the
                      output's copy back to the host (which waits for the
                      device). This is the hot path timed by the runner.
                      Every subclass's ``iterate`` runs inside one
                      ``gpuab.iterate`` span (``harness/profiler.py``),
                      the root of its round trip's spans.
* ``device_iterate()`` -- device compute on resident buffers, enqueued
                      on the current stream; the caller waits (the
                      device tier records CUDA events around it).
* ``validate()``   -- compare the last iteration's host output against
                      the golden with the benchmark's tolerance/metric.

Every benchmark holds the ``torch.device`` it runs on; nothing uses a
global default device.

Under ``--dataParallel N`` (N > 1) every rank of an N-rank process
group runs the same benchmark (``parallel/launch.py:spmd``) on its
shard of one axis, which ``setup_sharding`` declares: ``put_sharded``
and ``put_spec`` place the rank's slice of the host array on its device,
``put_replicated`` the whole array, and ``to_host`` reads a sharded
output back whole, gathered over the ranks, as the JAX package's
``np.asarray`` of a sharded array does. The host arrays (the seeded
input, the goldens) stay whole on every rank. Each rank runs the hand
kernel on its shard: unlike the JAX package's ``resolve_impl``, nothing
switches to the plain twin under sharding.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.profiler import span
from gpuaudiobench_tpu_torch.harness.statistics import LatencyStats
from gpuaudiobench_tpu_torch.harness.validation import ValidationData
from gpuaudiobench_tpu_torch.utils import device as dev


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

    def __init_subclass__(cls, **kwargs):
        """Wrap the subclass's own ``iterate`` in a ``gpuab.iterate``
        span."""
        super().__init_subclass__(**kwargs)
        iterate = cls.__dict__.get("iterate")
        if iterate is None:
            return

        @functools.wraps(iterate)
        def spanned(self):
            with span("gpuab.iterate"):
                return iterate(self)

        cls.iterate = spanned

    def __init__(self, cfg: BenchConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.buffer_size = cfg.buffer_size
        self.track_count = cfg.n_tracks
        self._allocations: Dict[str, int] = {}
        # The ("dp",) mesh of --dataParallel N > 1 (setup_sharding), and
        # whether set-up declared an axis or refused the flag: the runner
        # refuses a benchmark that did neither, so the flag never
        # silently does nothing.
        self._mesh = None
        self._dp_ready = False

    # -- data-parallel sharding (--dataParallel: one shard a rank) ---------
    def setup_sharding(self, axis_size: int, axis_label: str = "nTracks") -> None:
        """Declare the benchmark's data-parallel axis; call from setup()
        with the size of the axis that shards over the dp mesh. Under
        N > 1 ranks the saturated chain is a loop (collectives inside a
        captured graph are not tried)."""
        self._dp_ready = True
        self._mesh = None
        n = self.cfg.data_parallel
        if n > 1:
            if axis_size % n != 0:
                raise ValueError(
                    f"{axis_label} ({axis_size}) must be divisible by "
                    f"--dataParallel ({n})"
                )
            from gpuaudiobench_tpu_torch.parallel.mesh import dp_mesh

            self._mesh = dp_mesh(n, self.device)
            self.stream_capturable = False

    def reject_data_parallel(self, reason: str) -> None:
        """Benchmarks with no shardable dp axis call this from setup():
        under --dataParallel it raises ``reason`` (their own message);
        otherwise it records that the flag was consciously refused."""
        if self.cfg.data_parallel > 1:
            raise ValueError(reason)
        self._dp_ready = True

    @property
    def dp_ranks(self) -> int:
        """The ranks the dp axis spans (1 when unsharded)."""
        return 1 if self._mesh is None else self._mesh.size

    @property
    def dp_rank(self) -> int:
        return 0 if self._mesh is None else self._mesh.axis_index("dp")

    def dp_slice(self, n: int) -> slice:
        """This rank's part of an axis of ``n`` (the whole when
        unsharded)."""
        k = n // self.dp_ranks
        return slice(self.dp_rank * k, (self.dp_rank + 1) * k)

    def shard(self, a: np.ndarray, axis: int = 0) -> np.ndarray:
        """This rank's slice of host array ``a`` along ``axis``."""
        if self._mesh is None:
            return a
        index = [slice(None)] * a.ndim
        index[axis] = self.dp_slice(a.shape[axis])
        return a[tuple(index)]

    def put_sharded(self, host_array: np.ndarray, axis: int = 0) -> torch.Tensor:
        """H2D copy of this rank's slice along ``axis`` (the whole array
        when unsharded)."""
        return dev.to_device(self.shard(host_array, axis), self.device)

    def put_replicated(self, a: np.ndarray) -> torch.Tensor:
        """H2D copy of the whole array, on every rank."""
        return dev.to_device(a, self.device)

    def put_spec(self, a: np.ndarray, *axes) -> torch.Tensor:
        """Placement by a PartitionSpec on the dp mesh: "dp" or None per
        axis, at most one "dp"."""
        dims = [i for i, ax in enumerate(axes) if ax == "dp"]
        if len(dims) > 1 or any(ax not in ("dp", None) for ax in axes):
            raise ValueError(f"put_spec: unsupported spec {axes}")
        return (self.put_sharded(a, dims[0]) if dims
                else self.put_replicated(a))

    def dp_psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the dp ranks, on every rank (one counted
        ``psum``; ``t`` itself when unsharded)."""
        if self._mesh is None:
            return t
        from gpuaudiobench_tpu_torch.parallel.collectives import psum

        return psum(t, self._mesh, "dp")

    def dp_pmax(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over the dp ranks, on every rank
        (one counted ``pmax``; ``t`` itself when unsharded)."""
        if self._mesh is None:
            return t
        from gpuaudiobench_tpu_torch.parallel.collectives import pmax

        return pmax(t, self._mesh, "dp")

    def to_host(self, t: torch.Tensor, axis: int = 0) -> np.ndarray:
        """The whole host array of ``t``, sharded on ``axis`` over dp:
        the ranks' shards gathered along it in rank order (every rank
        gets the whole; the gather is the round trip's read-back, so
        ``collectives.COLLECTIVES`` does not count it)."""
        if self._mesh is None:
            return dev.from_device(t)
        from gpuaudiobench_tpu_torch.parallel.collectives import unshard

        dims = [None] * t.dim()
        dims[axis] = "dp"
        return dev.from_device(unshard(t, self._mesh, dims))

    def to_host_parts(self, parts) -> List[np.ndarray]:
        """Several outputs in ONE device-to-host copy: ``parts`` is a list
        of (tensor, dp axis), the axis None for a tensor every rank holds
        whole. Each rank's tensors go into one flat buffer, the buffers
        are gathered as rows (one a rank), and each output is cut out of
        the rows and joined along its axis: a fused or interleaved
        buffer is never joined end to end."""
        flat = torch.cat([t.reshape(-1) for t, _ in parts])
        rows = self.to_host(flat[None])
        ranks, out, at = rows.shape[0], [], 0
        for t, axis in parts:
            n, shape = t.numel(), tuple(t.shape)
            if axis is None:
                out.append(rows[0, at:at + n].reshape(shape))
            else:
                a = np.moveaxis(rows[:, at:at + n].reshape((ranks,) + shape),
                                0, axis)
                whole = list(shape)
                whole[axis] *= ranks
                out.append(a.reshape(whole))
            at += n
        return out

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
