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

    # Output control (cli.py): progress chatter off, the CSV path (the
    # JSON's with json_output), JSON instead of the printed summary, and
    # the raw latency dump ("" = <temp dir>/<name>_latencies.txt).
    quiet: bool = False
    output_file: str = ""
    json_output: bool = False
    latencies_file: str = ""
    write_latencies: bool = True

    # Validation: "none" | "spot" | "full"; spot checks <= limit samples.
    verification: str = "full"
    spot_sample_limit: int = 1024

    # The device tier: CUDA events around device_iterate()
    # (harness/device_timing.py).
    device_timing: bool = True
    # DAW-load simulation (harness/dawsim.py): pace each timed iteration
    # to the next buffer boundary by spinning or sleeping, with uniform
    # +-jitter.
    dawsim: bool = False
    dawsim_mode: str = "spin"  # "spin" | "sleep"
    dawsim_jitter_us: float = 0.0
    # A torch.profiler trace of the run (the Metal --capture /
    # MTLCaptureManager analog, harness/profiler.py), written to
    # capture_dir ("" = <temp dir>/tpuaudiobench_trace).
    capture: bool = False
    capture_dir: str = ""
    # --dataParallel: above 1, the run goes over that many ranks
    # (parallel/launch.py:spmd), each holding one shard of the axis its
    # benchmark declares (harness/base.py:setup_sharding) on a one-axis
    # ("dp",) mesh; the benchmarks without such an axis refuse it.
    data_parallel: int = 1
    # The device mesh of MultiChipSuite and ICIBandwidth, "dp,tp,sp"
    # (parallel/mesh.py); more than one rank runs every rank in lock step
    # under parallel/launch.py:spmd.
    mesh: str = "1,1,1"
    # Overlapped-infeed pass (harness/overlap.py): overlap_depth blocks
    # with the input upload double-buffered against compute, beside the
    # serial twin, overlap_reps times (0/1 = off).
    overlap_depth: int = 0
    overlap_reps: int = 5

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
    # PartConv: the frequency-domain delay line's form, "shift" (every
    # slot moves a block, the default) | "ring" (one slot written, the
    # doubled H read through a window) | "nupols" (a K-slot uniform head
    # and K*B-tap tail partitions, K = partconv_tail_chunk); the IR
    # spectra's storage dtype, "f32" | "f16" (the MAC runs in f32).
    partconv_form: str = "shift"
    partconv_tail_chunk: int = 8
    partconv_h_dtype: str = "f32"
    # DAWSessionMix: the per-track EQ cascade's depth (1-16 stages); the
    # reverb's IR length is ir_length.
    session_eq_stages: int = 4

    # NeuralAmp / NeuralAmpLSTM: channels (the LSTM's hidden size), the
    # TCN's dilated layers, and the GEMM dtype, "f32" (full FP32) |
    # "bf16" | "int8" (TCN only).
    neuralamp_channels: int = 128
    neuralamp_layers: int = 10
    neuralamp_dtype: str = "f32"

    # RndMemRead: the sample pool in MiB and the per-track loop-length
    # range (bench_rndmem.cuh: 512 MiB, loop wrap 1000-48000).
    rndmem_pool_mb: int = 512
    rndmem_min_loop: int = 1000
    rndmem_max_loop: int = 48000
    # DWG1DNaive / DWG1DAccel: delay-line length range (bench_dwg.cuh
    # defaults 100-2000).
    dwg_min_length: int = 100
    dwg_max_length: int = 2000
    # FDTD3D: one receiver cell per track (default: the single broadcast
    # receiver), and the room in cells per axis (grid = room + 2 ghost
    # cells; 50 is the CUDA/Metal reference, bench_fdtd3d.cuh:12-38).
    fdtd_per_track_receivers: bool = False
    fdtd_room: int = 50
    # datacopy*: the pool in MiB the five ratios split (the CUDA default
    # 10; the poster's tab5/tab8 also measured 100 MiB and 1 GiB).
    transfer_mib: int = 10

    # Speed-of-light benchmarks (SOL_*, models/speedoflight.py): FMA passes
    # an element, the FMA, stream and shared-memory working sets in MiB, and
    # the square matmul dimension (the reference's defaults).
    sol_fma_k: int = 512
    sol_fma_mib: int = 8
    sol_stream_mib: int = 64
    sol_vmem_mib: int = 2
    sol_matmul_dim: int = 4096

    impl: str = "auto"
    # CSV schema: "cuda" (globals.cu:69-122) | "metal" (main.swift:256).
    csv_schema: str = "cuda"

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
        (``gpuaudiobench_tpu/config.py:212-284``) for the fields here."""
        if self.buffer_size <= 0 or self.n_tracks <= 0:
            raise ValueError("buffer_size and n_tracks must be positive")
        if self.fs <= 0:
            raise ValueError("fs must be positive")
        if self.n_runs <= 0:
            raise ValueError("n_runs must be positive")
        if self.verification not in ("none", "spot", "full"):
            raise ValueError(f"invalid verification mode: {self.verification}")
        if self.dawsim_mode not in ("spin", "sleep"):
            raise ValueError(f"invalid dawsim mode: {self.dawsim_mode}")
        if self.conv_edge_mode not in ("clamp", "bleed"):
            raise ValueError(f"invalid conv edge mode: {self.conv_edge_mode}")
        if not 8 <= self.fdtd_room <= 128:
            raise ValueError(
                f"fdtd_room must be in [8, 128], got {self.fdtd_room}")
        if not 2 <= self.partconv_tail_chunk <= 64:
            raise ValueError(
                "partconv_tail_chunk must be in [2, 64], got "
                f"{self.partconv_tail_chunk}")
        if self.partconv_form not in ("ring", "shift", "nupols"):
            raise ValueError(
                f"invalid partconv form: {self.partconv_form}")
        if self.partconv_h_dtype not in ("f32", "f16"):
            raise ValueError(
                f"invalid partconv H dtype: {self.partconv_h_dtype}")
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
        if not 1 <= self.session_eq_stages <= 16:
            # Staggered cutoffs 0.25 - 0.0125*k stay positive through 16
            # stages, the systolic kernel's limit (csrc/iir.cu).
            raise ValueError(
                f"session_eq_stages ({self.session_eq_stages}) must be "
                "in [1, 16]")
        if self.neuralamp_dtype not in ("f32", "bf16", "int8"):
            raise ValueError(
                f"invalid NeuralAmp dtype: {self.neuralamp_dtype}")
        if not 1 <= self.neuralamp_channels <= 512:
            raise ValueError(
                f"neuralamp_channels ({self.neuralamp_channels}) must be "
                "in [1, 512]")
        if not 1 <= self.neuralamp_layers <= 12:
            # Carried-tail memory doubles a layer ((K-1)*2^l samples a
            # track); 12 layers = 16 s receptive field.
            raise ValueError(
                f"neuralamp_layers ({self.neuralamp_layers}) must be "
                "in [1, 12]")
        if self.impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"invalid impl: {self.impl}")
        if self.csv_schema not in ("cuda", "metal"):
            raise ValueError(f"invalid csv schema: {self.csv_schema}")
        if self.dwg_min_length < 4:
            raise ValueError("dwg_min_length must be >= 4")
        if self.dwg_max_length < self.dwg_min_length:
            raise ValueError(
                f"dwg_max_length ({self.dwg_max_length}) must be >= "
                f"dwg_min_length ({self.dwg_min_length})"
            )


__all__ = ["BenchConfig"]
