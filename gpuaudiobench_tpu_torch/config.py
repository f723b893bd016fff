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
    fs: int = 48000
    buffer_size: int = 512
    n_tracks: int = 128
    n_runs: int = 100
    warmup: int = 3

    # Output control (cli.py): progress chatter off, a JSON file path,
    # JSON instead of the printed summary.
    quiet: bool = False
    output_file: str = ""
    json_output: bool = False

    # Validation: "none" | "spot" | "full"; spot checks <= limit samples.
    verification: str = "full"
    spot_sample_limit: int = 1024

    # The device tier: CUDA events around device_iterate()
    # (harness/device_timing.py).
    device_timing: bool = True
    # Runner tiers not ported yet: asking for one raises (runner.py).
    dawsim: bool = False
    capture: bool = False
    data_parallel: int = 1
    overlap_depth: int = 0

    seed: int = 42
    # ModalFilterBank: None = min(1024*nTracks, 1M) modes.
    modal_num_modes: Optional[int] = None
    # Streaming-only: rescale each phasor to its initial magnitude after
    # every block (off = the reference's unrenormalized drift).
    modal_renorm: bool = False
    # IIRFilter recurrence form: "scan" (the per-sample recurrence, the
    # default) | "blockstate" (m samples per step through precomputed
    # Toeplitz taps, ops/iir.py). iir_block_m = 0 means auto (128 on the
    # CUDA kernel, as on the reference's Pallas path; 16 on the plain
    # twin, as on its XLA path), clamped to a divisor of buffer_size.
    iir_form: str = "scan"
    iir_block_m: int = 0

    # Conv1D / Conv1D_accel: IR length (None = the benchmark's default,
    # 1024 for Conv1D and 512 for Conv1D_accel) and Conv1D's edge mode,
    # "clamp" (the window stays in its track) | "bleed" (the flat
    # track-major buffer, the CUDA reference's indexing).
    ir_length: Optional[int] = None
    conv_edge_mode: str = "clamp"

    impl: str = "auto"

    # Saturated pass: pipeline_depth chained blocks per timing (0/1 =
    # off), saturated_reps timings, and the depth-differenced marginal
    # tier at depth // 4.
    pipeline_depth: int = 0
    saturated_reps: int = 21
    saturated_marginal: bool = True

    def deadline_ms(self) -> float:
        """Real-time deadline: 1000*BUFSIZE/FS ms (cuda/globals.cu:55,89)."""
        return 1000.0 * self.buffer_size / self.fs

    def replace(self, **kw) -> "BenchConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        """Raises ``ValueError`` with the reference's messages
        (``gpuaudiobench_tpu/config.py:212-275``) for the fields here."""
        if self.buffer_size <= 0 or self.n_tracks <= 0:
            raise ValueError("buffer_size and n_tracks must be positive")
        if self.fs <= 0:
            raise ValueError("fs must be positive")
        if self.n_runs <= 0:
            raise ValueError("n_runs must be positive")
        if self.verification not in ("none", "spot", "full"):
            raise ValueError(f"invalid verification mode: {self.verification}")
        if self.conv_edge_mode not in ("clamp", "bleed"):
            raise ValueError(f"invalid conv edge mode: {self.conv_edge_mode}")
        if self.iir_form not in ("scan", "blockstate"):
            raise ValueError(f"invalid iir form: {self.iir_form}")
        if self.iir_block_m != 0 and not 2 <= self.iir_block_m <= 128:
            raise ValueError(
                f"iir_block_m ({self.iir_block_m}) must be 0 (auto) "
                "or in [2, 128]")
        if self.iir_form == "blockstate":
            cap = min(self.iir_block_m or 128, self.buffer_size)
            if not any(self.buffer_size % m == 0
                       for m in range(2, cap + 1)):
                raise ValueError(
                    f"blockstate needs a buffer_size divisor in "
                    f"[2, {cap}]; {self.buffer_size} has none -- "
                    "use iir_form scan")
        if self.impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"invalid impl: {self.impl}")


__all__ = ["BenchConfig"]
