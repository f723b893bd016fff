"""Shared benchmark scaffolding: the standard (tracks x bufferSize)
float32 buffer pair with seeded +-1 uniform input.

PyTorch counterpart of ``gpuaudiobench_tpu/models/common.py`` (the
reference's BufferSet, cuda/bench_base.cuh:50-74). The track axis is the
data-parallel axis: under ``--dataParallel`` each rank's device holds its
slice of the tracks (``Benchmark.put_sharded``), and ``to_host`` reads an
output back whole.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.base import Benchmark
from gpuaudiobench_tpu_torch.harness.streaming import probe
from gpuaudiobench_tpu_torch.harness.validation import (
    ValidationData,
    compare_abs,
    spot_indices,
)
from gpuaudiobench_tpu_torch.utils.data import generate_random_audio


def check_full_fp32(name: str = "") -> None:
    """Raises when float32 matmuls may run in TF32: the benchmarks whose
    GEMMs stand for the reference's f32 contract (DAWSessionMix's bus and
    mixdown, NeuralAmp's f32 mode) run them in full FP32 ('highest')."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            f"{name or 'this benchmark'}: float32 matmuls are set to TF32 "
            f"({torch.get_float32_matmul_precision()!r}); its GEMMs run in "
            "full FP32 ('highest')")


def expand_rows(part: np.ndarray, rows: Optional[np.ndarray], shape,
                axis: int = 0) -> np.ndarray:
    """``part`` computed for the tracks ``rows`` (along ``axis``) placed
    in a NaN-filled array of ``shape``; ``part`` itself when rows is
    None (every track)."""
    if rows is None:
        return part
    full = np.full(shape, np.nan, part.dtype)
    index = [slice(None)] * len(shape)
    index[axis] = rows
    full[tuple(index)] = part
    return full


class StandardBufferBenchmark(Benchmark):
    """Track-major (tracks, bufferSize) float32 input and output."""

    tolerance: float = 1e-5

    def __init__(self, cfg: BenchConfig, device: torch.device):
        super().__init__(cfg, device)
        self.host_input: Optional[np.ndarray] = None
        self.host_output: Optional[np.ndarray] = None
        self.golden: Optional[np.ndarray] = None
        self._resident_input: Optional[torch.Tensor] = None

    def make_input(self) -> np.ndarray:
        data = generate_random_audio(self.total_elements(), self.cfg.seed)
        return data.reshape(self.track_count, self.buffer_size)

    def put_input(self, host_array: np.ndarray) -> torch.Tensor:
        """H2D copy of one input block, the track axis dp-sharded."""
        return self.put_sharded(host_array)

    def set_input(self, host_input: np.ndarray) -> None:
        """Take ``host_input`` as the input block and keep a resident
        device copy of it (for the device tier and the stream)."""
        want = (self.track_count, self.buffer_size)
        if host_input.shape != want or host_input.dtype != np.float32:
            raise ValueError(
                f"{self.name}: input must be float32 {want}, got "
                f"{host_input.dtype} {host_input.shape}")
        self.host_input = host_input
        self._resident_input = self.put_input(host_input)
        nbytes = host_input.nbytes
        self.track_alloc("hostInput", nbytes)
        self.track_alloc("hostOutput", nbytes)
        self.track_alloc("deviceInput", nbytes)
        self.track_alloc("deviceOutput", nbytes)

    def setup_standard_buffers(self) -> None:
        self.setup_sharding(self.track_count)
        self.set_input(self.make_input())

    def overlap_blocks(self):
        """Two distinct host payloads for the overlapped-infeed tier
        (harness/overlap.py): the input and its negation, so every
        per-block upload is a real transfer, not a repeat."""
        a = self.host_input
        return [a, np.negative(a)]

    def stateless_overlap(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        """``overlap_body`` of a benchmark without state: each block runs
        ``fn`` on its uploaded input."""
        return (lambda x, c: (fn(x), c)), self.overlap_blocks(), ()

    def stateless_stream(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        """``stream_body`` of a benchmark without state: each block runs
        ``fn`` on the resident input and emits the probe of its output."""
        def step(x):
            return x, probe(fn(x))

        return step, self._resident_input

    def checked_tracks(self, state_shape=None) -> Optional[np.ndarray]:
        """The tracks whose output or state samples a spot check reads
        (sorted), or None when the check reads them all. A state has the
        track axis second to last, ``(..., tracks, 2)``; a benchmark
        without one passes None. The goldens are computed for these
        tracks only: a spot check at full width then replays a few
        thousand tracks on the host, not every one."""
        if self.cfg.verification != "spot":
            return None
        limit, s = self.cfg.spot_sample_limit, self.buffer_size
        rows = spot_indices(self.track_count * s, limit) // s
        if state_shape is None:
            return np.unique(rows)
        n_state = int(np.prod(state_shape))
        state_rows = (spot_indices(n_state, limit) // 2) % self.track_count
        return np.union1d(rows, state_rows)

    def validate(self) -> ValidationData:
        return compare_abs(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name,
        )
