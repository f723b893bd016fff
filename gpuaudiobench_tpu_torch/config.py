"""Benchmark configuration: the knobs of the ported path.

A copy of the reference's ``BenchConfig`` (``gpuaudiobench_tpu/config.py``)
cut down to the fields this package reads, with the same names and
defaults, so the port never imports the reference package
(``tests/test_torch_harness.py`` holds the two against each other).

``impl`` maps onto this package as follows:

* ``"auto"`` and ``"pallas"``: the hand-written CUDA kernel on a CUDA
  device (metadata ``impl: "cuda-kernel"``);
* ``"xla"``: refused on a CUDA device, where only the kernel runs; the
  plain PyTorch twin is called directly for A/B timing.

On the CPU every impl runs the plain twin (metadata ``"torch-plain"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    buffer_size: int = 512
    n_tracks: int = 128
    n_runs: int = 100
    warmup: int = 3

    # Validation: "none" | "spot" | "full"; spot checks <= limit samples.
    verification: str = "full"
    spot_sample_limit: int = 1024

    # Runner tiers not ported yet: asking for one raises (runner.py).
    dawsim: bool = False
    capture: bool = False
    device_timing: bool = True
    data_parallel: int = 1
    overlap_depth: int = 0

    seed: int = 42
    # ModalFilterBank: None = min(1024*nTracks, 1M) modes.
    modal_num_modes: Optional[int] = None
    # Streaming-only: rescale each phasor to its initial magnitude after
    # every block (off = the reference's unrenormalized drift).
    modal_renorm: bool = False

    impl: str = "auto"

    # Saturated pass: pipeline_depth chained blocks per timing (0/1 =
    # off), saturated_reps timings, and the depth-differenced marginal
    # tier at depth // 4.
    pipeline_depth: int = 0
    saturated_reps: int = 21
    saturated_marginal: bool = True

    def replace(self, **kw) -> "BenchConfig":
        return dataclasses.replace(self, **kw)


__all__ = ["BenchConfig"]
