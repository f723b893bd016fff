#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure exits
nonzero:

1. Toolchain: torch, CUDA, nvcc, triton (optional) and the card's
   nvidia-smi name and power limit.
2. Build: the CUDA kernels from ``gpuaudiobench_tpu_torch/csrc``, one
   nvcc per source, all started together.
3. The two modal kernels (rotation and Gordon-Smith resonator) vs their
   plain twins on the card, under every contract of the modal bank, with
   the states chained over 2 blocks, at ten shapes up to the main path's
   (1,048,576 modes, 512 samples, 32 tracks), three of them with T_out
   not dividing 32 (12 and 3; 12,288 x 512 x 12 is the CLI path's own),
   three at the persistent grid's edges (fewer tiles than SMs, a ragged
   last tile, 4,194,304 modes in several passes), each with its schedule
   (grid, modes a thread, passes, partials bytes); CUDA-event times of
   each kernel and its twin at the main shape.
4. The four IIR kernels vs their plain twins, states chained over 3
   blocks, at 8 x 64, 640 x 128, 65,536 x 512 and 1,000 x 96 (tracks x
   samples; 1,000 is no multiple of the blockstate kernel's 8-track
   group), the blockstate kernel at block_m 12, 16 and 128 (m = 12 and 96
   at 96 samples), and the systolic cascade vs the chain cascade at 1e-6;
   the systolic cascade vs its twin and the chain at its schedule's edges
   (K = 16 at 1,000 x 96, K = 10 at 33 x 4 with no steady step, K = 1 at
   640 x 128), each with its schedule (grid, step ranges, chunks), and
   the chain cascade vs its twin at those and at its own edges (S % 4 !=
   0 on its staged route at 1,001 x 45, 77 x 7 (K = 16) and 129 x 30,
   track counts no block divides), bit for bit on an unaligned x (the
   staged route at every shape); CUDA-event times of each kernel and twin at 65,536 x 512, the chain
   kernel's share of its bound, and of ``torch.matmul`` on the
   blockstate chunk products as a yardstick.
5. The Conv1D FIR kernel vs its plain twin in both edge modes at five
   (tracks, samples, taps) shapes up to the main path's 19,456 x 512 x
   1,024, among them each CLI path's own and one with L - 1 > S in
   bleed, on N(0, 0.1^2) IRs within 1e-5 absolute; at the main shape
   also on the benchmark's own IR bank within 1e-5 of the twin's peak;
   CUDA-event times of the kernel, the twin and
   ``torch.nn.functional.conv1d`` (cuDNN, TF32 off) at the main shape.
6. The RndMem gather vs its plain twin, bit for bit, at 21 edge and
   clamped playheads from a 64 Ki-sample pool and at the main path's
   65,536 tracks x 512 samples from a 512 MiB pool; CUDA-event times of
   the kernel, the twin and one advanced-indexing gather.
7. The DWG block vs its plain twin from random rails U(0, 0.1), chained
   over 2 blocks: rails bit for bit the twin's, the mono output bit for
   bit ``ops.dwg.dwg_mono_in_order`` (the kernel's summation order in
   NumPy) and within 1e-5 of the twin's peak, and a rerun bit for bit,
   each shape with its schedule (``ops.dwg.dwg_schedule``), at 6 x 48
   (unaligned lengths); the edge lengths 1, 2, S - 1, S, S + 1, 2S - 1,
   odd, an out tap at or past S and in tap = out tap at S = 48, 512 and
   2,000; 1,000 x 512, 2,048 x 2,000, the main path's 32,768 x 512 x
   Lmax 2,000 with random and power-of-two lengths, and 70,000 x 512 x
   Lmax 600 (past 65,535 waveguides); CUDA-event times at 32,768 x 512.
8. The FDTD kernels vs their twins bit for bit: the divergence form on
   both routes (``ops.fdtd3d.fdtd_schedule``: the cluster kernel where
   the room fits one thread-block cluster, the plane kernel, a
   cooperative launch of a block a plane, everywhere) and the field
   form's plane kernel with 128 per-track receivers (the first on the
   source cell) and with the broadcast receiver, and the divergence form
   vs the field form within 1e-5 of the peak, fields chained over 2
   blocks, at rooms 8 (64 samples), 50 (512), 82 and 128 (32 each, the
   plane route only), so the two div routes also equal each other at
   rooms 8 and 50; CUDA-event times of the cluster kernel and the field
   kernel at room 50, of the plane kernel and the field kernel at room
   82 and of the plane kernel at room 128, 128 tracks x 512 samples (the
   field form with per-track receivers), and of the cluster barrier
   alone.
9. The two speed-of-light kernels (``fma_chain``, ``fma_vmem``) vs their
   plain twin within 1e-4 absolute and vs the closed form within 5e-4, at
   37 x 1,000 (k = 24), 64 x 1,024 (k = 130) and each SOL benchmark's
   default shape at k = 512; CUDA-event times of each kernel and the twin
   at the defaults.
10. Main paths, each with every launch count reset just before and read
   just after, and the plain twins counted (none may run):
   ``gpuaudiobench_tpu_torch.bench.main()`` at its defaults; 512 chained
   resonator blocks at the main modal shape, the first checked against
   ``modal_reference_gs`` on spot tracks; then the CLI on IIRFilter (scan
   and blockstate) and BiquadChain at 65,536 tracks, IIRFilter at the
   CLI's default 128 tracks, ModalFilterBank at 12 tracks (T_out 12),
   Conv1D at 19,456 tracks (clamp) and 128 (bleed), Conv1D_accel at
   19,456, FFT1D, gain, GainStats and NoOp at 65,536, RndMemRead at
   65,536 tracks and at the CLI's defaults (no ``--benchmark``: 128
   tracks, 100 runs, full verification), DWG1DNaive and DWG1DAccel at
   32,768 waveguides, and FDTD3D at room 50 with 128 tracks, with and
   without ``--fdtdPerTrackReceivers`` (with it the field kernel must
   launch; without it the cluster kernel, not the plane kernel), and at
   room 82 x 64 samples (the plane kernel); each
   validates against the NumPy golden; then the CLI on the six SOL
   benchmarks at their defaults
   (``fma_chain`` must launch on SOL_VPU, ``fma_vmem`` on SOL_VMEM). On
   every CLI path the JSON's ``metadata.roofline`` must name its
   ``peak_source`` and ``basis``, and no share of a peak may pass 105 %.
   The DWG, FDTD and SOL paths run fewer round trips and a shallower
   saturated tier (``DWG_CLI``, ``FDTD_CLI``): a DWG round trip at 32,768
   waveguides moves ~1 GB of rails through pageable memory and its host
   golden replays every iteration, and one FDTD block takes milliseconds
   (1,536 substeps, each waiting on neighbours), so the default depth of
   512 x 21 reps would take minutes (``SOL_CLI``: a SOL_MXU_f32 block is
   ~2.5 ms).
11. Pinned staging, DAW-sim pacing and the overlapped-infeed tier, still
   with the plain twins counted (none may run): the CLI on the five
   datacopy benchmarks at ``--transferMiB 100`` (30 runs, full
   verification), each validated, uploading from pinned memory (else it
   fails), its p50/p95 beside the PC's tab5 row and its
   ``transferMemoryClass`` A/B (pinned against pageable, H2D and D2H);
   ModalFilterBank at bench's 1,048,576 modes onto 32 tracks with pacing
   off, ``--dawsim --dawsim-mode sleep`` and ``spin`` beside tab7 (p50,
   p95, miss rate), and datacopy0199 at 100 MiB paced by spinning, its
   p50 over the unpaced one beside tab8's x1.049 (each paced run must
   name the native pacer); ``--overlapDepth 32 --overlapReps 3`` on every
   benchmark with an ``overlap_body`` at ``CLI_RUNS``' widths (IIRFilter
   scan and blockstate, BiquadChain, gain, GainStats and FFT1D at 65,536
   tracks, Conv1D and Conv1D_accel at 19,456, DWG1DNaive at 32,768,
   datacopy5050 at 100 MiB), serial and overlapped p50 a block, each
   path's kernel launched at least once a block of the pass; and the
   overlapped loop's last output and carry after 32 blocks bit for bit
   the serial loop's from one starting carry, for IIRFilter at 65,536,
   DWG1DNaive at 32,768 and DAWSessionMix at 65,536
   (``harness.overlap.run_serial`` / ``run_overlapped``).
12. PartConv and DAWSessionMix, still with the plain twins counted (none
   may run): the CLI on PartConv at 1,536 tracks x 512 with the
   48,000-tap IR (the JAX package's certified capacity) in the shift,
   ring and nupols (``--partconvTailChunk 8``) forms and shift with f16
   spectra (``PARTCONV_CLI``: 10 runs, depth 64, 5 reps), each printed
   against its cost-model bound, and the shift / ring A/B; DAWSessionMix
   at 65,536 strips (4 EQ stages, 48,000 taps; ``SESSION_CLI``: 5 runs)
   and with 16 stages at 128, the systolic cascade launched exactly once
   a session block; each validated against its NumPy golden, its
   roofline shares at most 105 %. The PartConv shift and the 65,536-strip
   session runs go without ``--json``: their CSV (header and row) must
   equal what ``csv_from_json_results`` derives from the same run's JSON,
   and the latency file must hold every round trip; ``--csvSchema metal``
   writes its own header, and appending the cuda schema to that file
   exits nonzero. The overlap tier on PartConv at 1,536 and the session
   at 65,536 (the session's kernel at least once a block; its overlapped
   loop bit for bit the serial one after 32 blocks is in phase 11's
   check). Then 64 chained stream blocks of each PartConv form and of
   both session paths after a warm pass, under
   ``torch.cuda.set_sync_debug_mode("error")``: none may wait for the
   device.
13. NeuralAmp and NeuralAmpLSTM (no kernel of the 14: cuBLAS GEMMs and
   elementwise ops; the LSTM block one CUDA graph replay), still with the
   plain twins counted (none may run): the CLI on NeuralAmp at the JAX
   package's widths (C = 128, L = 10) in f32, bf16 and int8 at 128 tracks
   and in f32 at 256 (``NEURAL_CLI``: 10 runs, depth 64, 5 reps), and on
   NeuralAmpLSTM (H = 128) in f32 and bf16 at 128 (``LSTM_CLI``: 5 runs,
   depth 16), each validated in full against its f64 golden, with its
   device, saturated and round-trip p50 and its max error, its cost-model
   bound at the data-sheet peak of its dtype, ``matmulPrecision:
   "highest"``, and on the LSTM ``blockForm: "cuda-graph"`` with exactly
   one graph replay (``ops.neuralamp.GRAPH_REPLAYS``) for every block the
   run made; the overlap tier on NeuralAmp and NeuralAmpLSTM f32 at 128
   (the LSTM replaying at least once a block) and their overlapped loops
   bit for bit the serial ones; one LSTM block replayed through its graph
   bit for bit the same block run eagerly on the card, in f32 and bf16,
   with the CUDA-event times of both; and 64 chained stream blocks of
   each of the six paths under ``torch.cuda.set_sync_debug_mode("error")``.
14. Calibration: ``gpuaudiobench_tpu_torch.calibrate_peaks`` into a
   temporary file; fails unless all six peaks are there, none above 105 %
   of its data-sheet value, and the shared-memory rate not above 105 % of
   132 x 128 B x nvidia-smi's ``clocks.max.sm``.
15. ``torch.profiler`` names the kernels of one call of each cascade
   wrapper at 1,000 x 96: the chain wrapper must launch the chain kernel
   alone (its coefficients' copy to the constant bank is a memcpy), the
   systolic wrapper the systolic kernel alone. It runs after everything
   timed (a profiler session slows the process's later launches).
16. A ``{"kernels": [...]}`` line (14 kernels), the nvidia-smi line, and
   last the ``{"ok": true, "device": {...}}`` line.

Needs one CUDA device; exits 1 without printing a result when there is
none, or when the port's package is not beside this script.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

MAIN_SHAPE = (1048576, 512, 32)
# (12288, 512, 12) is ModalFilterBank's CLI path at 12 tracks. The
# persistent grid's edges: (2048, 64, 32) has fewer tiles than SMs,
# (70048, 64, 32) a ragged last tile and blocks of 8 and 9 tiles, and
# (4194304, 64, 32) more tiles than one pass of the grid takes.
SHAPES = [(4096, 32, 32), (960, 64, 32), (256, 32, 8), (3000, 64, 12),
          (999, 32, 3), (12288, 512, 12), (2048, 64, 32), (70048, 64, 32),
          (4194304, 64, 32), MAIN_SHAPE]
OUT_RTOL = 1e-5  # max|kernel - plain| <= OUT_RTOL * max|plain|
STATE_ATOL = 1e-4
TIMING_REPS = 20
KERNEL_SOURCE = "gpuaudiobench_tpu_torch/csrc/modal_bank.cu"
REPLACES = "gpuaudiobench_tpu/ops/modal_pallas.py:55"
RES_REPLACES = "gpuaudiobench_tpu/ops/modal_pallas.py:104"
# The resonator path: blocks chained at MAIN_SHAPE, and the tracks whose
# first block is held against modal_reference_gs at 1e-5 of its peak
# (the reference's bar, tests/test_pallas_ops.py:432).
RES_BLOCKS = 512
RES_SPOT_TRACKS = (0, 13, 31)
RES_GS_RTOL = 1e-5

# The Conv1D FIR kernel (csrc/conv1d.cu), (tracks, samples, taps): kernel
# vs twin within 1e-5 absolute in both edge modes, on N(0, 0.1^2) IRs
# whose outputs are of unit scale (FMA contraction, ~1e-7 there);
# (6, 16, 40) has L - 1 > S, and (128, 512, 1024) is the CLI's bleed path.
# The benchmark's own IR bank (windowed sinc over L) gives outputs near
# 1e-3 rms, where 1e-5 absolute would pass a TF32 kernel; at CONV_FULL it
# is held within 1e-5 of the twin's peak instead.
CONV_FULL = (19456, 512, 1024)
CONV_SHAPES = [(130, 48, 16), (8, 64, 7), (6, 16, 40), (128, 512, 1024),
               CONV_FULL]
CONV_ATOL = 1e-5
CONV_BANK_RTOL = 1e-5
CONV_SOURCE = "gpuaudiobench_tpu_torch/csrc/conv1d.cu"
CONV_REPLACES = "gpuaudiobench_tpu/ops/conv_pallas.py:40"

# The IIR kernels (csrc/iir.cu), (tracks, samples) shapes. Kernel vs twin:
# 1e-5 absolute, outputs and states (FMA contraction and the blockstate
# product's summation order, ~1e-7 on unit-scale signals; the reference's
# bar for blockstate vs scan). Systolic vs chain: 1e-6 absolute and
# relative, the reference's cross-check.
IIR_FULL = (65536, 512)
IIR_SHAPES = [(8, 64), (640, 128), IIR_FULL, (1000, 96)]
IIR_BLOCK_M = (12, 16, 128)  # the blockstate kernel's; the others at 128
IIR_ATOL = 1e-5
CASCADE_TOL = 1e-6
IIR_STAGES = 10
# (K, tracks, samples) at the systolic cascade schedule's edges: the
# deepest instance, S < K - 1 (warm-up and drain only), no lag; and at
# the chain cascade's: S % 4 != 0 (its staged route: 45 with a ragged
# last chunk, 7, 30), track counts no 128-track block divides (1,001, 77,
# 129), K = 16. At each the chain also runs on an unaligned copy of x
# (the staged route by the rule), bit for bit its output on the rule's
# route.
CASCADE_EDGES = [(16, 1000, 96), (10, 33, 4), (1, 640, 128), (10, 1001, 45),
                 (16, 77, 7), (2, 129, 30)]
IIR_SOURCE = "gpuaudiobench_tpu_torch/csrc/iir.cu"
PROFILE_SESSIONS = 3  # chain_kernel_names: sessions for one trace
IIR_REPLACES = {
    "iir_biquad": "gpuaudiobench_tpu/ops/iir.py:49",
    "iir_biquad_blockstate": "gpuaudiobench_tpu/ops/iir.py:407",
    "iir_cascade": "gpuaudiobench_tpu/ops/iir.py:161",
    "iir_cascade_chain": "gpuaudiobench_tpu/ops/iir.py:130",
}
# The RndMem gather (csrc/rndmem.cu), bit for bit against its twin: the
# edge playheads of the reference's test (tests/test_pallas_ops.py:69-71),
# clamped ones, and the main path's (tracks, samples, pool samples).
RNDMEM_EDGE_POOL = 64 * 1024
RNDMEM_EDGE = [0, 1024, 513, 1000, RNDMEM_EDGE_POOL - 512, 2047, 12345, 777,
               128, 127, 129, RNDMEM_EDGE_POOL - 513, RNDMEM_EDGE_POOL - 640,
               255, RNDMEM_EDGE_POOL - 768, 511, RNDMEM_EDGE_POOL - 1,
               RNDMEM_EDGE_POOL + 99, -1, -70000, 2 ** 31 - 1]
RNDMEM_FULL = (65536, 512, 512 * 1024 * 1024 // 4)
RNDMEM_SOURCE = "gpuaudiobench_tpu_torch/csrc/rndmem.cu"
RNDMEM_REPLACES = "gpuaudiobench_tpu/ops/rndmem_pallas.py:62"

# The DWG block (csrc/dwg.cu), (waveguides, samples, Lmax, lengths tiled
# over the rows or None for U[100, Lmax), power-of-two lengths, in tap =
# out tap on every 7th row), from rails U(0, 0.1): rails bit for bit the
# twin's, the mono output bit for bit ops.dwg.dwg_mono_in_order and within
# 1e-5 of the twin's peak (the twin sums in another order).
DWG_FULL = (32768, 512, 2000)
DWG_EDGE_48 = (1, 2, 47, 48, 49, 95, 7, 33, 3, 70, 64, 5)
DWG_EDGE_512 = (1, 2, 511, 512, 513, 1023, 101, 777, 3, 640, 1000, 100)
DWG_EDGE_2000 = (1, 2, 1999, 2000, 2001, 3999, 101, 2667, 3, 777, 3000)
DWG_SHAPES = [(6, 48, 40, (5, 8, 12, 16, 33, 40), False, False),
              (300, 48, 100, DWG_EDGE_48, False, True),
              (1000, 512, 1100, DWG_EDGE_512, False, True),
              (333, 2000, 4000, DWG_EDGE_2000, False, True),
              (1000, 512, 2000, None, False, False),
              (2048, 2000, 2000, None, False, False),
              (*DWG_FULL, None, False, False), (*DWG_FULL, None, True, False),
              (70000, 512, 600, None, False, False)]
DWG_OUT_RTOL = 1e-5
DWG_SOURCE = "gpuaudiobench_tpu_torch/csrc/dwg.cu"
DWG_REPLACES = "gpuaudiobench_tpu/ops/dwg_pallas.py:40"

# The FDTD kernels (csrc/fdtd3d.cu), (room, samples): outputs and fields
# kernel vs twin bit for bit on every route, divergence vs field within
# 1e-5 of the peak. The cluster kernel and the field kernel are timed at
# FDTD_MAIN, the plane kernel (``fdtd3d_div_coop``) at FDTD_COOP (a room
# no cluster holds; its time goes into the kernels line) and at FDTD_BIG
# (the largest room the config allows), the field kernel also at
# FDTD_COOP; the last two are printed with their bounds, under
# FDTD_BIG_KEY and FDTD_FIELD_82_KEY.
FDTD_MAIN = (50, 512, 128)  # room, samples, tracks: the CLI path's
FDTD_COOP = (82, 512, 128)
FDTD_BIG = (128, 512, 128)
FDTD_BIG_KEY = "fdtd3d_div_coop room 128"
FDTD_FIELD_82_KEY = "fdtd3d_field room 82"
FDTD_SHAPES = [(8, 64), (50, 512), (82, 32), (128, 32)]
FDTD_RTOL = 1e-5
FDTD_SOURCE = "gpuaudiobench_tpu_torch/csrc/fdtd3d.cu"
FDTD_REPLACES = {"fdtd3d_div": "gpuaudiobench_tpu/ops/fdtd3d_pallas.py:149",
                 "fdtd3d_field": "gpuaudiobench_tpu/ops/fdtd3d_pallas.py:77",
                 "fdtd3d_div_coop": "gpuaudiobench_tpu/ops/fdtd3d_pallas.py:149"}

# The speed-of-light kernels (csrc/speedoflight.cu), (rows, width, k):
# kernel vs twin within 1e-4 absolute (one rounding a pass against two:
# at most k * 2^-23 * 2 on O(1) values, 1e-4 at k = 512), kernel vs the
# closed form within the benchmarks' 5e-4. The default shapes are
# SOL_VPU's 8 MiB and SOL_VMEM's 2 MiB at k = 512.
SOL_FMA_FULL = (2048, 1024, 512)
SOL_VMEM_FULL = (512, 1024, 512)
SOL_SHAPES = [(37, 1000, 24), (64, 1024, 130), SOL_VMEM_FULL, SOL_FMA_FULL]
SOL_ATOL = 1e-4
SOL_GOLDEN_ATOL = 5e-4
SOL_SOURCE = "gpuaudiobench_tpu_torch/csrc/speedoflight.cu"
SOL_REPLACES = {"fma_chain": "gpuaudiobench_tpu/ops/speedoflight.py:89",
                "fma_vmem": "gpuaudiobench_tpu/ops/speedoflight.py:120"}
SOL_NAMES = ["SOL_VPU", "SOL_VMEM", "SOL_HBM", "SOL_MXU_bf16", "SOL_MXU_f32",
             "SOL_MXU_int8"]
# No share of a peak, and no calibrated rate against its data-sheet value,
# may read above this.
SHARE_CAP_PCT = 105.0

# The published H100 SXM peaks the bounds divide by (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# The CLI runs of the IIR slice: (label, argv, kernels that must launch).
CLI_COMMON = ["--nRuns", "30", "--warmup", "5", "--pipelineDepth", "512",
              "--verification", "spot", "--json"]
CLI_RUNS = [
    ("IIRFilter scan, 65536 tracks",
     ["--benchmark", "IIRFilter", "--nTracks", "65536"] + CLI_COMMON,
     ["iir_biquad"]),
    ("IIRFilter blockstate, 65536 tracks",
     ["--benchmark", "IIRFilter", "--nTracks", "65536", "--iirForm",
      "blockstate"] + CLI_COMMON,
     ["iir_biquad_blockstate"]),
    ("BiquadChain, 65536 tracks",
     ["--benchmark", "BiquadChain", "--nTracks", "65536"] + CLI_COMMON,
     ["iir_cascade", "iir_cascade_chain"]),
    ("IIRFilter scan, 128 tracks",
     ["--benchmark", "IIRFilter"] + CLI_COMMON,
     ["iir_biquad"]),
    ("ModalFilterBank, 12 tracks (T_out 12)",
     ["--benchmark", "ModalFilterBank", "--nTracks", "12"] + CLI_COMMON,
     ["modal_bank"]),
    ("Conv1D clamp, 19456 tracks",
     ["--benchmark", "Conv1D", "--nTracks", "19456"] + CLI_COMMON,
     ["conv1d"]),
    ("Conv1D bleed, 128 tracks",
     ["--benchmark", "Conv1D", "--convEdgeMode", "bleed"] + CLI_COMMON,
     ["conv1d"]),
    ("Conv1D_accel, 19456 tracks",
     ["--benchmark", "Conv1D_accel", "--nTracks", "19456"] + CLI_COMMON,
     []),
] + [(f"{name}, 65536 tracks",
      ["--benchmark", name, "--nTracks", "65536"] + CLI_COMMON, [])
     for name in ("FFT1D", "gain", "GainStats", "NoOp")]
# Fewer round trips and a shallower saturated tier for the DWG and FDTD
# paths (see the docstring).
DWG_CLI = ["--nRuns", "5", "--warmup", "1", "--pipelineDepth", "64",
           "--saturatedReps", "5", "--verification", "spot", "--json"]
FDTD_CLI = ["--nRuns", "10", "--warmup", "2", "--pipelineDepth", "32",
            "--saturatedReps", "5", "--verification", "spot", "--json"]
# Room 82 on the plane kernel: 64-sample blocks (its NumPy golden
# at 512 samples would take most of a minute), 5 runs, depth 16.
FDTD_ROOM82 = ["--fdtdRoom", "82", "--bufferSize", "64", "--nRuns", "5",
               "--warmup", "1", "--pipelineDepth", "16", "--saturatedReps",
               "3", "--verification", "spot", "--json"]
# Kernels a CLI path must not launch: room 50 fits a cluster.
CLI_ABSENT = {"FDTD3D room 50, 128 tracks": ["fdtd3d_div_coop"]}
SOL_CLI = ["--nRuns", "10", "--warmup", "2", "--pipelineDepth", "64",
           "--saturatedReps", "5", "--verification", "spot", "--json"]
SOL_KERNELS = {"SOL_VPU": ["fma_chain"], "SOL_VMEM": ["fma_vmem"]}
CLI_RUNS += [
    ("RndMemRead, 65536 tracks",
     ["--benchmark", "RndMemRead", "--nTracks", "65536"] + CLI_COMMON,
     ["rndmem_gather"]),
    ("RndMemRead, the CLI's defaults (128 tracks)", ["--json"],
     ["rndmem_gather"]),
    ("DWG1DNaive, 32768 waveguides",
     ["--benchmark", "DWG1DNaive", "--nTracks", "32768"] + DWG_CLI,
     ["dwg_block"]),
    ("DWG1DAccel, 32768 waveguides",
     ["--benchmark", "DWG1DAccel", "--nTracks", "32768"] + DWG_CLI,
     ["dwg_block"]),
    ("FDTD3D room 50, 128 tracks",
     ["--benchmark", "FDTD3D"] + FDTD_CLI, ["fdtd3d_div"]),
    ("FDTD3D room 50, 128 tracks, per-track receivers",
     ["--benchmark", "FDTD3D", "--fdtdPerTrackReceivers"] + FDTD_CLI,
     ["fdtd3d_field"]),
    ("FDTD3D room 82, 128 tracks x 64",
     ["--benchmark", "FDTD3D"] + FDTD_ROOM82, ["fdtd3d_div_coop"]),
] + [(f"{name}, the defaults", ["--benchmark", name] + SOL_CLI,
      SOL_KERNELS.get(name, [])) for name in SOL_NAMES]

# The pinned-staging, DAW-sim and overlapped-infeed phase. The datacopy
# family at the poster's 100 MiB pool, 30 round trips, full verification;
# the PC rows (i7-12700 + RTX 4070, BASELINE.md) beside each: tab5 p50 /
# p95 ms, tab7 p50 / p95 ms (1M modes; pacing off, sleep, spin) and
# tab8's DAW-sim p50 multiplier for 100 MiB I/O 1/99.
DATACOPY_NAMES = ["datacopy0199", "datacopy2080", "datacopy5050",
                  "datacopy8020", "datacopy9901"]
DATACOPY_CLI = ["--transferMiB", "100", "--nRuns", "30", "--warmup", "5",
                "--verification", "full", "--json"]
TAB5_PC = {"datacopy0199": (10.06, 11.82), "datacopy2080": (9.84, 11.68),
           "datacopy5050": (9.57, 11.5), "datacopy8020": (9.37, 11.1),
           "datacopy9901": (9.09, 10.59)}
# ModalFilterBank at bench's shape: 1,048,576 modes onto 32 tracks.
DAWSIM_MODAL = ["--benchmark", "ModalFilterBank", "--nTracks", "1024",
                "--nRuns", "30", "--warmup", "5", "--verification", "spot",
                "--json"]
DAWSIM_MODES = {"off": [], "sleep": ["--dawsim", "--dawsim-mode", "sleep"],
                "spin": ["--dawsim", "--dawsim-mode", "spin"]}
TAB7_PC = {"off": (2.87, 3.73), "sleep": (7.37, 10.94), "spin": (2.87, 8.07)}
TAB8_PC_IO_0199 = 1.049
# The overlapped-infeed tier on every overlap_body path at CLI_RUNS'
# widths: 32 blocks a loop, 3 reps of serial and overlapped, so each
# kernel must launch at least OVERLAP_BLOCKS times in the run. One round
# trip only: CLI_RUNS times those, and DWG's golden replays each one.
OVERLAP_DEPTH, OVERLAP_REPS = 32, 3
OVERLAP_BLOCKS = 2 * OVERLAP_DEPTH * OVERLAP_REPS + 1
OVERLAP_CLI = ["--nRuns", "1", "--warmup", "0", "--verification", "spot",
               "--overlapDepth", str(OVERLAP_DEPTH), "--overlapReps",
               str(OVERLAP_REPS), "--json"]
OVERLAP_RUNS = [
    ("IIRFilter scan, 65536 tracks",
     ["--benchmark", "IIRFilter", "--nTracks", "65536"], ["iir_biquad"]),
    ("IIRFilter blockstate, 65536 tracks",
     ["--benchmark", "IIRFilter", "--nTracks", "65536", "--iirForm",
      "blockstate"], ["iir_biquad_blockstate"]),
    ("BiquadChain, 65536 tracks",
     ["--benchmark", "BiquadChain", "--nTracks", "65536"], ["iir_cascade"]),
    ("Conv1D clamp, 19456 tracks",
     ["--benchmark", "Conv1D", "--nTracks", "19456"], ["conv1d"]),
    ("Conv1D_accel, 19456 tracks",
     ["--benchmark", "Conv1D_accel", "--nTracks", "19456"], []),
    ("DWG1DNaive, 32768 waveguides",
     ["--benchmark", "DWG1DNaive", "--nTracks", "32768"], ["dwg_block"]),
    ("datacopy5050, 100 MiB", ["--benchmark", "datacopy5050",
                               "--transferMiB", "100"], []),
] + [(f"{name}, 65536 tracks", ["--benchmark", name, "--nTracks", "65536"],
      []) for name in ("gain", "GainStats", "FFT1D")]
# Overlapped against serial loop, bit for bit, from one starting carry.
OVERLAP_CHECKS = [("IIRFilter", 65536), ("DWG1DNaive", 32768),
                  ("DAWSessionMix", 65536)]

# PartConv and DAWSessionMix (phase 12). PartConv at the JAX package's
# certified capacity, 1,536 tracks with the 48,000-tap IR
# (docs/RESULTS_r4_capacity.md:10), in each form and with f16 spectra,
# on a shallower tier (a block is milliseconds); DAWSessionMix at 65,536
# strips (docs/RESULTS_r3_capacity.md:56) with few round trips (its golden
# replays the EQ of every block on the host), and 16 EQ stages at the
# CLI's default 128 strips.
PARTCONV_CLI = ["--nRuns", "10", "--warmup", "2", "--pipelineDepth", "64",
                "--saturatedReps", "5", "--verification", "spot"]
PARTCONV_WIDE = ["--benchmark", "PartConv", "--nTracks", "1536",
                 "--irLength", "48000"]
PARTCONV_FORMS = {"shift": [], "ring": ["--partconvForm", "ring"],
                  "nupols": ["--partconvForm", "nupols",
                             "--partconvTailChunk", "8"],
                  "shift f16": ["--partconvHDtype", "f16"]}
SESSION_CLI = ["--nRuns", "5", "--warmup", "1", "--pipelineDepth", "64",
               "--saturatedReps", "5", "--verification", "spot"]
SESSION_WIDE = ["--benchmark", "DAWSessionMix", "--nTracks", "65536"]
SESSION_K16 = ["--benchmark", "DAWSessionMix", "--sessionEqStages", "16"]
# The overlapped-infeed tier on both at those widths.
SESSION_OVERLAP_RUNS = [
    ("PartConv shift, 1536 tracks", PARTCONV_WIDE, []),
    ("DAWSessionMix, 65536 strips", SESSION_WIDE, ["iir_cascade"]),
]
# NeuralAmp and NeuralAmpLSTM (phase 13) at the JAX package's default
# widths (C = H = 128, L = 10; gpuaudiobench_tpu/config.py:81-83): the TCN
# at 128 tracks in each dtype and at 256 in f32 (its certified capacity,
# docs/RESULTS_r4_capacity.md:10) on PartConv's tier; the LSTM, whose block
# is one graph replay of 512 dependent steps, at 128 tracks on a shallower
# one. Full verification against the f64 goldens.
NEURAL_CLI = ["--nRuns", "10", "--warmup", "2", "--pipelineDepth", "64",
              "--saturatedReps", "5", "--json"]
LSTM_CLI = ["--nRuns", "5", "--warmup", "1", "--pipelineDepth", "16",
            "--saturatedReps", "5", "--json"]
NEURAL_PATHS = [("NeuralAmp", "f32", 128), ("NeuralAmp", "bf16", 128),
                ("NeuralAmp", "int8", 128), ("NeuralAmp", "f32", 256),
                ("NeuralAmpLSTM", "f32", 128), ("NeuralAmpLSTM", "bf16", 128)]
NEURAL_RUNS = [
    (f"{name} {dtype}, {tracks} tracks",
     ["--benchmark", name, "--nTracks", str(tracks), "--neuralampDtype",
      dtype] + (LSTM_CLI if name == "NeuralAmpLSTM" else NEURAL_CLI))
    for name, dtype, tracks in NEURAL_PATHS]
NEURAL_OVERLAP_RUNS = [
    ("NeuralAmp f32, 128 tracks", ["--benchmark", "NeuralAmp"], []),
    ("NeuralAmpLSTM f32, 128 tracks", ["--benchmark", "NeuralAmpLSTM"],
     ["lstm_block"]),
]
NEURAL_OVERLAP_CHECKS = [("NeuralAmp", 128), ("NeuralAmpLSTM", 128)]
# The eager LSTM block against its graph: CUDA-event reps of one eager
# block (~3,600 launches from the host) and of GRAPH_CALLS replays.
EAGER_REPS, GRAPH_REPS, GRAPH_CALLS = 3, 5, 10
# Chained blocks under torch.cuda.set_sync_debug_mode("error"), after a
# warm pass: none may wait for the device.
SYNC_FREE_BLOCKS = 64
SYNC_FREE_PATHS = [
    (f"PartConv {form}, 1536 tracks", "PartConv",
     {"n_tracks": 1536, "ir_length": 48000, **knobs})
    for form, knobs in (("shift", {}), ("ring", {"partconv_form": "ring"}),
                        ("nupols", {"partconv_form": "nupols"}),
                        ("shift f16", {"partconv_h_dtype": "f16"}))
] + [("DAWSessionMix, 65536 strips", "DAWSessionMix", {"n_tracks": 65536}),
     ("DAWSessionMix K=16, 128 strips", "DAWSessionMix",
      {"session_eq_stages": 16})]
NEURAL_SYNC_FREE_PATHS = [
    (f"{name} {dtype}, {tracks} tracks", name,
     {"n_tracks": tracks, "neuralamp_dtype": dtype})
    for name, dtype, tracks in NEURAL_PATHS]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def toolchain(torch, build, dev) -> str:
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    nvcc = build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    print(f"nvcc {nvcc}: {ver.stdout.strip().splitlines()[-1]}")
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton not importable (not needed)")
    smi = dev.nvidia_smi_identity()
    if smi is None:
        fail("nvidia-smi gave no name and power limit")
    print(f"card: {smi}")
    return smi


def make_inputs(torch, m: int, seed: int, device):
    import numpy as np

    g = np.random.Generator(np.random.MT19937(seed))
    amp = g.random(m, dtype=np.float32)
    w = (np.float32(2 * np.pi) * g.random(m, dtype=np.float32)
         * np.float32(0.45)).astype(np.float32)
    tabs = {
        "amp": amp,
        "cos_w": np.cos(w).astype(np.float32),
        "sin_w": np.sin(w).astype(np.float32),
        "re": (g.random(m, dtype=np.float32) * 2 - 1).astype(np.float32),
        "im": (g.random(m, dtype=np.float32) * 2 - 1).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in tabs.items()}


def compare(torch, ops, shape, device):
    """Every contract of both kernels, 2 chained blocks; returns max
    |kernel - plain| of the outputs, (rotation, resonator)."""
    m, s, t = shape
    x = make_inputs(torch, m, seed=m + s + t, device=device)
    before = dict(ops.KERNEL_LAUNCHES)
    worst = {"rotation": 0.0, "res": 0.0}

    def check_out(name, got, want, form="rotation"):
        if tuple(got.shape) != tuple(want.shape):
            fail(f"{shape} {name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
        if not torch.isfinite(got).all():
            fail(f"{shape} {name}: non-finite output")
        err = (got - want).abs().max().item()
        peak = want.abs().max().item()
        if err > OUT_RTOL * peak:
            fail(f"{shape} {name}: max|d| {err:.3g} > {OUT_RTOL:g} * {peak:.4g}")
        worst[form] = max(worst[form], err)
        return err / peak

    # Streaming contract: rotated states carried from block to block.
    re_k, im_k = x["amp"] * x["re"], x["amp"] * x["im"]
    re_p, im_p = re_k, im_k
    rel = []
    for blk in range(2):
        out_k, re_k, im_k = ops.modal_folded_step(
            x["cos_w"], x["sin_w"], re_k, im_k, s, t)
        out_p, re_p, im_p = ops.modal_folded_step_plain(
            x["cos_w"], x["sin_w"], re_p, im_p, s, t)
        rel.append(check_out(f"folded block {blk}", out_k, out_p))
    serr = max((re_k - re_p).abs().max().item(),
               (im_k - im_p).abs().max().item())
    if not serr <= STATE_ATOL:
        fail(f"{shape} rotated states: max|d| {serr:.3g} > {STATE_ATOL:g}")

    # Round-trip contract: input states come back unchanged.
    sre, sim = x["re"], x["im"]
    for blk in range(2):
        out_k, sre2, sim2 = ops.modal_bank(
            x["amp"], x["cos_w"], x["sin_w"], sre, sim, s, t)
        if sre2 is not sre or sim2 is not sim:
            fail(f"{shape} modal_bank did not return its input states")
        out_p, _, _ = ops.modal_bank_plain(
            x["amp"], x["cos_w"], x["sin_w"], sre, sim, s, t)
        rel.append(check_out(f"bank block {blk}", out_k, out_p))

    # The resonator: its streaming step chained, then the round trip.
    eps, yk, qk = ops.res_init(x["cos_w"], x["sin_w"], x["amp"] * x["re"],
                               x["amp"] * x["im"])
    yp, qp = yk, qk
    for blk in range(2):
        out_k, yk, qk = ops.modal_res_step(eps, yk, qk, s, t)
        out_p, yp, qp = ops.modal_res_step_plain(eps, yp, qp, s, t)
        rel.append(check_out(f"res block {blk}", out_k, out_p, "res"))
    rerr = max((yk - yp).abs().max().item(), (qk - qp).abs().max().item())
    if not rerr <= STATE_ATOL:
        fail(f"{shape} resonator states: max|d| {rerr:.3g} > {STATE_ATOL:g}")
    out_k, sre2, _ = ops.modal_bank(x["amp"], x["cos_w"], x["sin_w"], sre,
                                    sim, s, t, algorithm="res")
    out_p, _, _ = ops.modal_bank_plain(x["amp"], x["cos_w"], x["sin_w"],
                                       sre, sim, s, t, algorithm="res")
    if sre2 is not sre:
        fail(f"{shape} modal_bank res did not return its input states")
    rel.append(check_out("res bank", out_k, out_p, "res"))
    torch.cuda.synchronize()
    launched = tuple(ops.KERNEL_LAUNCHES[k] - before[k]
                     for k in ("modal_bank", "modal_res"))
    if launched != (4, 3):
        fail(f"{shape}: {launched} (rotation, resonator) kernel launches, "
             "expected (4, 3)")
    sched = ops._schedule(ops._lib(), "rotation", m, t, device)
    print(f"compare M={m} S={s} T_out={t}: ok  max rel-to-peak "
          f"{max(rel):.3g}  state max|d| {max(serr, rerr):.3g}; schedule: "
          f"grid {sched.grid}, {sched.modes_per_thread} modes a thread, "
          f"{sched.passes} passes, partials {sched.n_partials * s * t * 4:,} B")
    return worst["rotation"], worst["res"]


def median_ms(torch, fn, reps: int, calls: int) -> float:
    """Median over ``reps`` of the CUDA-event time of ``calls``
    back-to-back calls, per call (so host launch gaps overlap the
    device's work, as they do on the main path)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    times.sort()
    return times[len(times) // 2]


def time_main_shape(torch, ops, device):
    m, s, t = MAIN_SHAPE
    x = make_inputs(torch, m, seed=1, device=device)
    re_f, im_f = x["amp"] * x["re"], x["amp"] * x["im"]
    args = (x["cos_w"], x["sin_w"], re_f, im_f, s, t)
    before = dict(ops.KERNEL_LAUNCHES)

    def plain():
        return ops.modal_folded_step_plain(*args)

    def kernel():
        return ops.modal_folded_step(*args)

    # In turns (plain, kernel, kernel, plain) so drift shows as a spread.
    plain1 = median_ms(torch, plain, TIMING_REPS // 2, 1)
    kern1 = median_ms(torch, kernel, TIMING_REPS, 10)
    kern2 = median_ms(torch, kernel, TIMING_REPS, 10)
    plain2 = median_ms(torch, plain, TIMING_REPS // 2, 1)
    bank = median_ms(torch, lambda: ops.modal_bank(
        x["amp"], x["cos_w"], x["sin_w"], x["re"], x["im"], s, t),
        TIMING_REPS, 10)
    res_args = (*ops.res_init(x["cos_w"], x["sin_w"], re_f, im_f), s, t)
    res_p1 = median_ms(torch, lambda: ops.modal_res_step_plain(*res_args),
                       TIMING_REPS // 2, 1)
    res_k1 = median_ms(torch, lambda: ops.modal_res_step(*res_args),
                       TIMING_REPS, 10)
    res_k2 = median_ms(torch, lambda: ops.modal_res_step(*res_args),
                       TIMING_REPS, 10)
    res_p2 = median_ms(torch, lambda: ops.modal_res_step_plain(*res_args),
                       TIMING_REPS // 2, 1)
    for k in ("modal_bank", "modal_res"):
        if ops.KERNEL_LAUNCHES[k] == before[k]:
            fail(f"timing launched no {k} kernel")
    kern, plain = min(kern1, kern2), min(plain1, plain2)
    print(f"time M={m} S={s} T_out={t} (CUDA events, median of reps): "
          f"folded-step kernel {kern1:.4f} / {kern2:.4f} ms, plain twin "
          f"{plain1:.3f} / {plain2:.3f} ms; modal_bank kernel {bank:.4f} ms; "
          f"resonator step kernel {res_k1:.4f} / {res_k2:.4f} ms, plain "
          f"twin {res_p1:.3f} / {res_p2:.3f} ms")
    return {"modal_bank": (kern, plain),
            "modal_res": (min(res_k1, res_k2), min(res_p1, res_p2))}


def bound(bytes_moved: float, flops: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the FP32 operations over the FP32 peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def modal_bound():
    """modal_folded_step at the main shape: cos, sin, re, im read, re', im'
    written, (S, T_out) out; 7 FLOP per mode-sample (the rotation's 4
    multiplies and 2 adds, and the fold's add)."""
    m, s, t = MAIN_SHAPE
    return bound(4 * (6 * m + s * t), 7 * m * s)


def res_bound():
    """modal_res_step at the main shape: eps, y, q read, y', q' written,
    (S, T_out) out; 5 FLOP per mode-sample (2 multiplies, a subtraction
    and an add for the shears, and the fold's add)."""
    m, s, t = MAIN_SHAPE
    return bound(4 * (5 * m + s * t), 5 * m * s)


def conv_bound():
    """conv1d_direct at CONV_FULL: x and the IRs read, out written;
    2 FLOP (a multiply and an add) per output and tap."""
    tracks, s, l = CONV_FULL
    return bound(4 * (2 * tracks * s + tracks * l), 2 * tracks * s * l)


def iir_bounds(block_m: int):
    """Bounds at IIR_FULL. Every kernel reads x and writes y once, reads
    and writes its states and reads its coefficients. The biquad does 9
    FLOP per sample (w: 2 multiplies, 2 subtractions; y: 3 multiplies,
    2 adds), a cascade 9 per stage and sample. The blockstate product is
    lower-triangular: (m + 1) FLOP per sample on average, plus 4 for the
    state term and 5 for y; its tables are read too."""
    tracks, s = IIR_FULL
    n = tracks * s
    io = 4 * (2 * n)
    k = IIR_STAGES
    m = block_m
    return {
        "iir_biquad": bound(io + 4 * (4 * tracks + 5), 9 * n),
        "iir_biquad_blockstate": bound(
            io + 4 * (4 * tracks + 5 + m * m + 2 * m), (m + 10) * n),
        "iir_cascade": bound(io + 4 * (4 * k * tracks + 5 * k), 9 * k * n),
        "iir_cascade_chain": bound(io + 4 * (4 * k * tracks + 5 * k),
                                   9 * k * n),
    }


def iir_inputs(torch, tracks, s, device, stages=None, seed=11):
    """Seeded x (tracks, s) in [-1, 1), the fs/4 lowpass (or ``stages``
    staggered lowpasses) and a small nonzero state."""
    import numpy as np

    from gpuaudiobench_tpu_torch.utils.data import biquad_lowpass_coefficients

    g = np.random.Generator(np.random.MT19937(seed))
    x = (g.random((tracks, s), dtype=np.float32) * 2 - 1).astype(np.float32)
    if stages is None:
        c = np.array(biquad_lowpass_coefficients(0.25), np.float32)
        z = (g.random((tracks, 2), dtype=np.float32) - 0.5).astype(np.float32)
    else:
        c = np.array([biquad_lowpass_coefficients(0.25 - 0.0125 * i)
                      for i in range(stages)], np.float32)
        z = ((g.random((stages, tracks, 2), dtype=np.float32) - 0.5)
             * 0.2).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, c, z)]


def blockstate_tables(torch, iops, c, s, block_m, device):
    m = iops.blockstate_effective_m(s, block_m)
    taps, u = iops.blockstate_tables(c.cpu().numpy(), m)
    return torch.from_numpy(taps).to(device), torch.from_numpy(u).to(device)


def iir_fns(torch, iops, tracks, s, device, block_m=128):
    """{kernel name: (kernel, twin)} at one shape, each a function of
    (x, state) -> (y, state'), and the inputs (x, z1, zk) with z1 a
    single-stage and zk a cascade state."""
    x, c1, z1 = iir_inputs(torch, tracks, s, device)
    _, ck, zk = iir_inputs(torch, tracks, s, device, stages=IIR_STAGES)
    taps, u = blockstate_tables(torch, iops, c1, s, block_m, device)
    fns = {
        "iir_biquad": (lambda xx, z: iops.iir_biquad(xx, c1, z),
                       lambda xx, z: iops.iir_biquad_plain(xx, c1, z)),
        "iir_biquad_blockstate": (
            lambda xx, z: iops.iir_biquad_blockstate(xx, c1, taps, u, z),
            lambda xx, z: iops.iir_biquad_blockstate_plain(
                xx, c1, taps, u, z)),
        "iir_cascade": (lambda xx, z: iops.iir_cascade(xx, ck, z),
                        lambda xx, z: iops.iir_cascade_plain(xx, ck, z)),
        "iir_cascade_chain": (
            lambda xx, z: iops.iir_cascade_chain(xx, ck, z),
            lambda xx, z: iops.iir_cascade_plain(xx, ck, z)),
    }
    return fns, x, z1, zk


def compare_iir(torch, iops, tracks, s, device):
    """Each IIR kernel against its twin over 3 chained blocks (blockstate
    at every IIR_BLOCK_M), then systolic vs chain; returns max |kernel -
    twin| per kernel, outputs and states."""
    worst = {}
    sys_vs_chain = 0.0
    for block_m in IIR_BLOCK_M:
        fns, x, z1, zk = iir_fns(torch, iops, tracks, s, device, block_m)
        kinds = (["iir_biquad_blockstate"] if block_m != 128 else list(fns))
        outs = {}
        for kind in kinds:
            kern, plain = fns[kind]
            z0 = zk if kind.startswith("iir_cascade") else z1
            z0_copy = z0.clone()
            before = iops.KERNEL_LAUNCHES[kind]
            zkern, zplain = z0, z0
            err = 0.0
            for blk in range(3):
                yk, zkern = kern(x, zkern)
                yp, zplain = plain(x, zplain)
                if not (torch.isfinite(yk).all() and torch.isfinite(zkern).all()):
                    fail(f"{kind} {tracks}x{s}: non-finite output")
                e = max((yk - yp).abs().max().item(),
                        (zkern - zplain).abs().max().item())
                if not e <= IIR_ATOL:
                    fail(f"{kind} {tracks}x{s} m={block_m} block {blk}: "
                         f"max|kernel - twin| {e:.3g} > {IIR_ATOL:g}")
                err = max(err, e)
                outs.setdefault(kind, []).append((yk, zkern))
            torch.cuda.synchronize()
            if iops.KERNEL_LAUNCHES[kind] - before != 3:
                fail(f"{kind}: {iops.KERNEL_LAUNCHES[kind] - before} "
                     "launches for 3 blocks")
            if not torch.equal(z0, z0_copy):
                fail(f"{kind}: the input state was written")
            worst[kind] = max(worst.get(kind, 0.0), err)
        if block_m == 128:
            for (ys, zs), (yc, zc) in zip(outs["iir_cascade"],
                                          outs["iir_cascade_chain"]):
                for a, b in ((ys, yc), (zs, zc)):
                    d = (a - b).abs()
                    if not (d <= CASCADE_TOL + CASCADE_TOL * b.abs()).all():
                        fail(f"systolic vs chain {tracks}x{s}: max|d| "
                             f"{d.max().item():.3g} > {CASCADE_TOL:g} "
                             "abs + rel")
                    sys_vs_chain = max(sys_vs_chain, d.max().item())
    print(f"compare IIR {tracks}x{s}: ok  " + "  ".join(
        f"{k} {v:.3g}" for k, v in worst.items())
        + f"  systolic-vs-chain {sys_vs_chain:.3g}")
    return worst


def schedule_text(iops, tracks, s, k):
    sc = iops.cascade_schedule(tracks, s, k)
    return (f"grid {sc.grid} x {sc.warps} warps, warm-up steps {sc.warmup}, "
            f"steady {sc.steady}, drain {sc.drain}, {sc.chunks} chunks")


def unaligned_copy(torch, x):
    """x's values in a contiguous tensor 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    u = buf[1:].view(x.shape)
    u.copy_(x)
    return u


def compare_cascade_edges(torch, iops, device):
    """Over 3 chained blocks at each of CASCADE_EDGES: the systolic
    cascade against its twin (IIR_ATOL) and the chain cascade
    (CASCADE_TOL abs + rel); the chain against its twin (IIR_ATOL), and
    bit for bit on an unaligned copy of x (the staged route). Returns
    max |kernel - twin| of each cascade."""
    worst = {"iir_cascade": 0.0, "iir_cascade_chain": 0.0}
    for k, tracks, s in CASCADE_EDGES:
        x, _, _ = iir_inputs(torch, tracks, s, device)
        xu = unaligned_copy(torch, x)
        _, c, z = iir_inputs(torch, tracks, s, device, stages=k)
        zs, zc, zp = z, z, z
        err = chain_err = chain_d = 0.0
        before = dict(iops.CHAIN_ROUTE_LAUNCHES)
        for blk in range(3):
            ys, zs_next = iops.iir_cascade(x, c, zs)
            yc, zc_next = iops.iir_cascade_chain(x, c, zc)
            yp, zp = iops.iir_cascade_plain(x, c, zp)
            yu, zu = iops.iir_cascade_chain(xu, c, zc)
            if not (torch.equal(yu, yc) and torch.equal(zu, zc_next)):
                fail(f"iir_cascade_chain K={k} {tracks}x{s} block {blk}: "
                     "an unaligned x (the staged route) gives other bits")
            zs, zc = zs_next, zc_next
            if not (torch.isfinite(ys).all() and torch.isfinite(zs).all()):
                fail(f"iir_cascade K={k} {tracks}x{s}: non-finite output")
            e = max((ys - yp).abs().max().item(), (zs - zp).abs().max().item())
            ec = max((yc - yp).abs().max().item(), (zc - zp).abs().max().item())
            if not (e <= IIR_ATOL and ec <= IIR_ATOL):
                fail(f"K={k} {tracks}x{s} block {blk}: max|kernel - twin| "
                     f"systolic {e:.3g}, chain {ec:.3g} > {IIR_ATOL:g}")
            for a, b in ((ys, yc), (zs, zc)):
                d = (a - b).abs()
                if not (d <= CASCADE_TOL + CASCADE_TOL * b.abs()).all():
                    fail(f"systolic vs chain K={k} {tracks}x{s}: max|d| "
                         f"{d.max().item():.3g} > {CASCADE_TOL:g} abs + rel")
                chain_d = max(chain_d, d.max().item())
            err, chain_err = max(err, e), max(chain_err, ec)
        worst["iir_cascade"] = max(worst["iir_cascade"], err)
        worst["iir_cascade_chain"] = max(worst["iir_cascade_chain"], chain_err)
        routes = {r: n - before[r] for r, n in iops.CHAIN_ROUTE_LAUNCHES.items()}
        sc = iops.chain_schedule(tracks, s, x.data_ptr())
        print(f"compare iir_cascade K={k} {tracks}x{s}: ok  twin {err:.3g}  "
              f"chain {chain_d:.3g}; schedule: "
              + schedule_text(iops, tracks, s, k)
              + f"; chain twin {chain_err:.3g}, route {sc.route} (grid "
              f"{sc.grid} x {sc.warps} warps, {sc.chunks} chunks), unaligned "
              f"x bit for bit, launches by route {routes}")
    return worst


def chain_kernel_names(torch, iops, device):
    """Each cascade wrapper, called once under torch.profiler at 1,000 x
    96, K = 10, launches its own kernel and no other: the chain wrapper
    the chain kernel (its coefficients' copy to the constant bank is a
    memcpy), the systolic wrapper the systolic kernel."""
    from torch.profiler import ProfilerActivity, profile

    x, c, z = iir_inputs(torch, 1000, 96, device, stages=IIR_STAGES)
    seen = {}
    for name, fn, want in (
            ("iir_cascade_chain", iops.iir_cascade_chain, "iir_cascade_chain_kernel"),
            ("iir_cascade", iops.iir_cascade, "iir_cascade_systolic_kernel")):
        fn(x, c, z)
        torch.cuda.synchronize()
        # A session whose trace came back without a single device event
        # (seen once on the H100, for the systolic wrapper, whose call
        # copies nothing) is taken again, up to PROFILE_SESSIONS times;
        # a trace with device events is judged as it is.
        for _ in range(PROFILE_SESSIONS):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(x, c, z)
                torch.cuda.synchronize()
            device_events = [e.name for e in prof.events()
                             if "CUDA" in str(getattr(e, "device_type", ""))]
            if device_events:
                break
            print(f"profiler: {name}: a session recorded no device event")
        kernels = sorted({n for n in device_events
                          if not n.startswith(("Memcpy", "Memset"))})
        if not kernels:
            fail(f"{name}: the profiler saw no kernel (its events: "
                 f"{[(e.name[:48], str(e.device_type)) for e in prof.events()]})")
        if not all(want in n for n in kernels):
            fail(f"{name} launched {kernels}, not {want} alone")
        seen[name] = (kernels, sorted({n for n in device_events} - set(kernels)))
    print("profiler: " + "; ".join(
        f"{name} launched {[n[:72] for n in k]}" + (f", copies {c}" if c else "")
        for name, (k, c) in seen.items()))


def time_iir(torch, iops, device):
    """CUDA-event times (ms) at IIR_FULL of each kernel and its twin, in
    turns (twin, kernel, kernel, twin), and of torch.matmul on the
    blockstate chunk products: {name: (ms, plain_ms, library_ms)}."""
    tracks, s = IIR_FULL
    fns, x, z1, zk = iir_fns(torch, iops, tracks, s, device)
    out = {}
    plain_cascade = None
    for kind, (kern, plain) in fns.items():
        z = zk if kind.startswith("iir_cascade") else z1
        reps = 3 if kind.startswith("iir_cascade") else 5
        if kind == "iir_cascade_chain" and plain_cascade is not None:
            p1 = p2 = plain_cascade  # the same twin as iir_cascade's
        else:
            p1 = median_ms(torch, lambda: plain(x, z), reps, 1)
        k1 = median_ms(torch, lambda: kern(x, z), TIMING_REPS, 10)
        k2 = median_ms(torch, lambda: kern(x, z), TIMING_REPS, 10)
        if not (kind == "iir_cascade_chain" and plain_cascade is not None):
            p2 = median_ms(torch, lambda: plain(x, z), reps, 1)
        if kind == "iir_cascade":
            plain_cascade = min(p1, p2)
        library = None
        if kind == "iir_biquad_blockstate":
            m = 128
            _, c1, _ = iir_inputs(torch, tracks, s, device)
            taps, _ = blockstate_tables(torch, iops, c1, s, m, device)
            chunks = x.reshape(tracks * s // m, m)
            taps_t = taps.t().contiguous()
            library = median_ms(torch, lambda: torch.matmul(chunks, taps_t),
                                TIMING_REPS, 10)
        print(f"time {kind} {tracks}x{s} (CUDA events, median of reps): "
              f"kernel {k1:.4f} / {k2:.4f} ms, plain twin {p1:.3f} / "
              f"{p2:.3f} ms" + ("" if library is None else
                                f", torch.matmul chunk products "
                                f"{library:.4f} ms")
              + ("" if kind != "iir_cascade" else "; schedule: "
                 + schedule_text(iops, tracks, s, IIR_STAGES)))
        out[kind] = (min(k1, k2), min(p1, p2), library)
    return out


def res_path(torch, ops, models_modal, device):
    """The resonator's main path: RES_BLOCKS chained modal_res_step blocks
    at MAIN_SHAPE from res_init of the seeded bank. The first block is
    held against modal_reference_gs on RES_SPOT_TRACKS at RES_GS_RTOL of
    the golden's peak; every block must be finite. Returns the first
    block's max |kernel - golden| relative to the peak."""
    import numpy as np

    m, s, t = MAIN_SHAPE
    x = make_inputs(torch, m, seed=1, device=device)
    eps, y, q = ops.res_init(x["cos_w"], x["sin_w"], x["amp"] * x["re"],
                             x["amp"] * x["im"])
    outs = []
    for _ in range(RES_BLOCKS):
        out, y, q = ops.modal_res_step(eps, y, q, s, t)
        outs.append(out[:, list(RES_SPOT_TRACKS)])
    first = outs[0].cpu().numpy()
    if not (torch.isfinite(torch.stack(outs)).all()
            and torch.isfinite(y).all() and torch.isfinite(q).all()):
        fail("resonator path: non-finite output or state")
    # The golden on the spot tracks' modes only: mode j of the subset
    # folds onto j mod len(RES_SPOT_TRACKS), the position of its track.
    idx = np.stack([np.arange(k, m, t) for k in RES_SPOT_TRACKS],
                   axis=1).ravel()
    tabs = {k: v.cpu().numpy()[idx] for k, v in x.items()}
    gold = models_modal.modal_reference_gs(
        tabs["amp"], tabs["cos_w"], tabs["sin_w"], tabs["re"], tabs["im"],
        s, len(RES_SPOT_TRACKS)).T
    peak = float(np.abs(gold).max())
    rel = float(np.abs(first.astype(np.float64) - gold).max()) / peak
    if not rel <= RES_GS_RTOL:
        fail(f"resonator path: first block {rel:.3g} of the peak from "
             f"modal_reference_gs > {RES_GS_RTOL:g}")
    return rel


def conv_inputs(torch, tracks, s, l, device, bank=False, seed=5):
    """Seeded x (tracks, s) in [-1, 1) and N(0, 0.1^2) IRs, as the
    reference's kernel test draws them (tests/test_pallas_ops.py:248), or
    with ``bank`` the benchmark's windowed-sinc IR bank."""
    import numpy as np

    from gpuaudiobench_tpu_torch.utils.data import conv1d_impulse_responses

    g = np.random.Generator(np.random.MT19937(seed))
    x = (g.random((tracks, s), dtype=np.float32) * 2 - 1).astype(np.float32)
    if bank:
        ir = conv1d_impulse_responses(tracks, l)
    else:
        ir = (g.standard_normal((tracks, l), dtype=np.float32)
              * 0.1).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(ir).to(device)


def compare_conv(torch, cops, shape, device) -> float:
    """The FIR kernel vs its twin in both edge modes on N(0, 0.1^2) IRs,
    within CONV_ATOL; at CONV_FULL also on the benchmark's IR bank, within
    CONV_BANK_RTOL of the twin's peak. Returns max |kernel - twin| on the
    N(0, 0.1^2) IRs."""
    tracks, s, l = shape
    banks = (False, True) if shape == CONV_FULL else (False,)
    before = cops.KERNEL_LAUNCHES["conv1d"]
    worst = 0.0
    bank_rel = None
    for bank in banks:
        x, ir = conv_inputs(torch, tracks, s, l, device, bank=bank)
        for mode in ("clamp", "bleed"):
            got = cops.conv1d_direct(x, ir, mode)
            want = cops.conv1d_direct_plain(x, ir, mode)
            if (tuple(got.shape) != (tracks, s)
                    or not torch.isfinite(got).all()):
                fail(f"conv1d {shape} {mode}: shape {tuple(got.shape)} or "
                     "non-finite output")
            err = (got - want).abs().max().item()
            if bank:
                peak = want.abs().max().item()
                if not err <= CONV_BANK_RTOL * peak:
                    fail(f"conv1d {shape} {mode}, IR bank: max|kernel - "
                         f"twin| {err:.3g} > {CONV_BANK_RTOL:g} * {peak:.4g}")
                bank_rel = max(bank_rel or 0.0, err / peak)
                continue
            if not err <= CONV_ATOL:
                fail(f"conv1d {shape} {mode}: max|kernel - twin| {err:.3g} > "
                     f"{CONV_ATOL:g}")
            worst = max(worst, err)
    torch.cuda.synchronize()
    launched = cops.KERNEL_LAUNCHES["conv1d"] - before
    if launched != 2 * len(banks):
        fail(f"conv1d {shape}: {launched} launches, expected "
             f"{2 * len(banks)}")
    print(f"compare conv1d T={tracks} S={s} L={l}: ok  max|d| {worst:.3g} "
          "(clamp and bleed)" + ("" if bank_rel is None else
                                 f"; IR bank max|d| {bank_rel:.3g} of the "
                                 "twin's peak"))
    return worst


def time_conv(torch, cops, device):
    """CUDA-event times (ms) at CONV_FULL, clamp: the kernel, the twin and
    one ``torch.nn.functional.conv1d`` call on the padded window with
    groups = tracks (cuDNN, TF32 off as the port's FP32 needs; the
    flipped IRs make its correlation a convolution). Returns
    (ms, plain_ms, library_ms)."""
    import torch.nn.functional as F

    tracks, s, l = CONV_FULL
    x, ir = conv_inputs(torch, tracks, s, l, device, bank=True)
    xp = cops.padded_window(x, l, "clamp").unsqueeze(0).contiguous()
    w = ir.flip(1).unsqueeze(1).contiguous()
    p1 = median_ms(torch, lambda: cops.conv1d_direct_plain(x, ir), 3, 1)
    k1 = median_ms(torch, lambda: cops.conv1d_direct(x, ir), TIMING_REPS, 10)
    k2 = median_ms(torch, lambda: cops.conv1d_direct(x, ir), TIMING_REPS, 10)
    p2 = median_ms(torch, lambda: cops.conv1d_direct_plain(x, ir), 3, 1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib_out = F.conv1d(xp, w, groups=tracks)[0]
        lib_err = (lib_out - cops.conv1d_direct(x, ir)).abs().max().item()
        lib = median_ms(torch, lambda: F.conv1d(xp, w, groups=tracks), 5, 2)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"time conv1d {tracks}x{s}x{l} clamp (CUDA events, median of "
          f"reps): kernel {k1:.4f} / {k2:.4f} ms, plain twin {p1:.2f} / "
          f"{p2:.2f} ms, F.conv1d (cuDNN, TF32 off) {lib:.4f} ms "
          f"(max|F.conv1d - kernel| {lib_err:.3g})")
    return min(k1, k2), min(p1, p2), lib


def compare_rndmem(torch, rops, device):
    """The gather vs its twin, bit for bit, at the edge playheads and at
    RNDMEM_FULL; returns the full shape's (pool, playheads) and the max
    |kernel - twin| over both."""
    g = torch.Generator(device=device)
    g.manual_seed(7)
    tracks, s, pool_len = RNDMEM_FULL
    edge_pool = torch.rand(RNDMEM_EDGE_POOL, generator=g, device=device)
    edge_ph = torch.tensor(RNDMEM_EDGE, dtype=torch.int32, device=device)
    pool = torch.rand(pool_len, generator=g, device=device)
    ph = torch.randint(0, pool_len - s, (tracks,), generator=g,
                       device=device, dtype=torch.int32)
    before = rops.KERNEL_LAUNCHES["rndmem_gather"]
    worst = 0.0
    for label, (p, h) in (("edge", (edge_pool, edge_ph)),
                          ("full", (pool, ph))):
        got = rops.rndmem_gather(p, h, s)
        want = rops.rndmem_gather_plain(p, h, s)
        if tuple(got.shape) != (s, h.shape[0]):
            fail(f"rndmem_gather {label}: shape {tuple(got.shape)}")
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            fail(f"rndmem_gather {label} {h.shape[0]}x{s}: not bit-equal to "
                 f"its twin (max|d| {err:.3g})")
        worst = max(worst, err)
    torch.cuda.synchronize()
    if rops.KERNEL_LAUNCHES["rndmem_gather"] - before != 2:
        fail("rndmem_gather: expected 2 launches")
    print(f"compare rndmem_gather: ok, bit for bit at {len(RNDMEM_EDGE)} "
          f"edge and clamped playheads and at {tracks}x{s} from "
          f"{pool_len * 4 >> 20} MiB")
    return pool, ph, worst


def time_rndmem(torch, rops, pool, ph):
    """CUDA-event times (ms) at RNDMEM_FULL of the kernel, the twin and one
    advanced-indexing gather with its (S, T) index built beforehand:
    (ms, plain_ms, library_ms)."""
    s = RNDMEM_FULL[1]
    idx = (rops.clamped_starts(ph, pool.shape[0], s)[None, :]
           + torch.arange(s, device=pool.device)[:, None])
    if not torch.equal(pool[idx], rops.rndmem_gather(pool, ph, s)):
        fail("rndmem_gather: the indexing yardstick differs from the kernel")
    p1 = median_ms(torch, lambda: rops.rndmem_gather_plain(pool, ph, s), 5, 2)
    k1 = median_ms(torch, lambda: rops.rndmem_gather(pool, ph, s),
                   TIMING_REPS, 10)
    k2 = median_ms(torch, lambda: rops.rndmem_gather(pool, ph, s),
                   TIMING_REPS, 10)
    p2 = median_ms(torch, lambda: rops.rndmem_gather_plain(pool, ph, s), 5, 2)
    lib = median_ms(torch, lambda: pool[idx], TIMING_REPS, 10)
    print(f"time rndmem_gather {ph.shape[0]}x{s} (CUDA events, median of "
          f"reps): kernel {k1:.4f} / {k2:.4f} ms, plain twin {p1:.4f} / "
          f"{p2:.4f} ms, pool[idx] {lib:.4f} ms")
    return min(k1, k2), min(p1, p2), lib


def cost_bound(cost):
    """``bound`` of a benchmark's ``cost_model()`` count."""
    return bound(cost["hbm_bytes"], cost["flops"])


def rndmem_bound():
    """RndMemRead's count at RNDMEM_FULL (``models.rndmem.rndmem_cost``):
    each output sample read once from the pool and written once, the
    playheads read; no arithmetic."""
    from gpuaudiobench_tpu_torch.models.rndmem import rndmem_cost

    tracks, s, _ = RNDMEM_FULL
    return cost_bound(rndmem_cost(tracks, s))


def dwg_inputs(torch, g_count, s, lmax, lengths, pow2, device, seed=11,
               same_tap=False):
    """(x, fwd, bwd, lengths, in_taps, out_taps, gains, refl, damp) on the
    card: the benchmark's parameter draws, rails U(0, 0.1)."""
    import numpy as np

    g = np.random.Generator(np.random.MT19937(seed + g_count))
    if lengths is None:
        lengths = 100 + g.integers(0, lmax - 100, g_count)
    lengths = np.resize(np.asarray(lengths), g_count)
    if pow2:
        lengths = 2 ** np.floor(np.log2(lengths))
    lengths = lengths.astype(np.int32)
    in_taps = (lengths // 4).astype(np.int32)
    out_taps = (3 * lengths // 4).astype(np.int32)
    if same_tap:
        in_taps[::7] = out_taps[::7]
    f32 = np.float32
    arrays = [
        (g.random(s, dtype=f32) * 2 - 1).astype(f32),
        (g.random((g_count, lmax), dtype=f32) * f32(0.1)).astype(f32),
        (g.random((g_count, lmax), dtype=f32) * f32(0.1)).astype(f32),
        lengths, in_taps, out_taps,
        (0.1 + 0.9 * g.random(g_count, dtype=f32)).astype(f32),
        (0.99 + 0.01 * (g.random(g_count, dtype=f32) - 0.5)).astype(f32),
        (0.9999 + 1e-4 * (g.random(g_count, dtype=f32) - 0.5)).astype(f32),
    ]
    return [torch.from_numpy(a).to(device) for a in arrays]


def compare_dwg(torch, dops, shape, device) -> float:
    """The DWG kernel vs its twin over 2 chained blocks: rails bit for
    bit, the mono output bit for bit its NumPy emulation and within
    DWG_OUT_RTOL of the twin's peak, a rerun bit for bit; returns the max
    |kernel - twin| of the rails (0)."""
    import numpy as np

    g_count, s, lmax, lengths, pow2, same_tap = shape
    x, fwd, bwd, *params = dwg_inputs(torch, g_count, s, lmax, lengths, pow2,
                                      device, same_tap=same_tap)
    host = [p.cpu().numpy() for p in params]
    fk, bk, fp, bp = fwd.clone(), bwd.clone(), fwd.clone(), bwd.clone()
    before = dops.KERNEL_LAUNCHES["dwg_block"]
    worst, out_rel = 0.0, 0.0
    label = f"dwg_block {shape[:3]}{' pow2' if pow2 else ''}"
    for blk in range(2):
        want = dops.dwg_mono_in_order(x.cpu().numpy(), fk.cpu().numpy(),
                                      bk.cpu().numpy(), *host)
        ok, fk, bk = dops.dwg_block(x, fk, bk, *params)
        op_, fp, bp = dops.dwg_block_plain(x, fp, bp, *params)
        rail = max((fk - fp).abs().max().item(), (bk - bp).abs().max().item())
        if not (torch.equal(fk, fp) and torch.equal(bk, bp)):
            fail(f"{label} block {blk}: rails not bit for bit the twin's "
                 f"(max|d| {rail:.3g})")
        if not np.array_equal(ok.cpu().numpy(), want):
            fail(f"{label} block {blk}: mono output not bit for bit "
                 "dwg_mono_in_order")
        peak = op_.abs().max().item()
        err = (ok - op_).abs().max().item()
        if not (err <= DWG_OUT_RTOL * peak and peak > 0
                and torch.isfinite(fk).all()):
            fail(f"{label} block {blk}: out max|d| {err:.3g} "
                 f"against {DWG_OUT_RTOL:g} * {peak:.4g}, or non-finite rails")
        worst, out_rel = max(worst, rail), max(out_rel, err / peak)
    again = dops.dwg_block(x, fwd.clone(), bwd.clone(), *params)
    first = dops.dwg_block(x, fwd.clone(), bwd.clone(), *params)
    if not all(torch.equal(u, v) for u, v in zip(first, again)):
        fail(f"{label}: two runs differ")
    torch.cuda.synchronize()
    if dops.KERNEL_LAUNCHES["dwg_block"] - before != 4:
        fail("dwg_block: expected 4 launches")
    sc = dops.dwg_schedule(g_count, s, lmax)
    depth = -(-s // int(host[0].min()))  # the longest chain a thread walks
    print(f"compare {label}{' edge' if lengths is not None else ''}: ok  "
          f"rails max|d| {worst:.3g}, out bit for bit its emulated order, "
          f"{out_rel:.3g} of the twin's peak, rerun bit for bit; schedule: "
          f"{sc.segments} segment(s) a row, {sc.groups} mono groups, grid "
          f"{sc.grid}; depth {depth}")
    return worst


def time_dwg(torch, dops, device):
    """CUDA-event times (ms) at DWG_FULL, random lengths, of the kernel and
    the twin, each updating the rails in place:
    (ms, plain_ms, touched cell pairs)."""
    g_count, s, lmax = DWG_FULL
    args = dwg_inputs(torch, g_count, s, lmax, None, False, device)

    def kernel():
        dops.dwg_block(*args)

    def plain():
        dops.dwg_block_plain(*args)

    p1 = median_ms(torch, plain, 2, 1)
    k1 = median_ms(torch, kernel, TIMING_REPS, 5)
    k2 = median_ms(torch, kernel, TIMING_REPS, 5)
    p2 = median_ms(torch, plain, 2, 1)
    touched = int(torch.clamp(args[3], max=s).sum().item())
    print(f"time dwg_block {g_count}x{s} Lmax {lmax} (CUDA events, median of "
          f"reps): kernel {k1:.4f} / {k2:.4f} ms, plain twin {p1:.2f} / "
          f"{p2:.2f} ms ({touched} cell pairs touched)")
    return min(k1, k2), min(p1, p2), touched


def dwg_bound(touched: int):
    """The DWG benchmarks' count at DWG_FULL (``models.dwg.dwg_cost``):
    each touched fwd and bwd cell read and written once (16 B a cell
    pair), x read, out written, 24 B of parameters a waveguide; 10 FLOP a
    waveguide and sample."""
    from gpuaudiobench_tpu_torch.models.dwg import dwg_cost

    g_count, s, _ = DWG_FULL
    return cost_bound(dwg_cost(g_count, s, touched))


def fdtd_geometry(fops, room):
    return fops.grid_n(room), fops.source_pos(room), fops.receiver_pos(room)


def fdtd_x(torch, tracks, s, device, seed=3):
    import numpy as np

    g = np.random.Generator(np.random.MT19937(seed))
    x = (g.random((tracks, s), dtype=np.float32) * 2 - 1).astype(np.float32)
    return torch.from_numpy(x).to(device)


def fdtd_check(torch, label, got, want):
    """max |got - want|; fails above FDTD_RTOL of max |want|."""
    if tuple(got.shape) != tuple(want.shape) or not torch.isfinite(got).all():
        fail(f"{label}: shape {tuple(got.shape)} vs {tuple(want.shape)}, "
             "or non-finite values")
    peak = want.abs().max().item()
    err = (got - want).abs().max().item()
    if not err <= FDTD_RTOL * peak:
        fail(f"{label}: max|d| {err:.3g} > {FDTD_RTOL:g} * {peak:.4g}")
    return err


def fdtd_same(torch, label, got, want):
    """Fails unless every tensor of ``got`` equals ``want``'s bit for bit;
    returns the max |got - want| (0)."""
    for a, b in zip(got, want):
        if tuple(a.shape) != tuple(b.shape) or not torch.equal(a, b):
            err = ((a - b).abs().max().item()
                   if a.shape == b.shape else float("nan"))
            fail(f"{label}: not bit for bit the twin's (max|d| {err:.3g})")
    return 0.0


def fdtd_routes(fops, n):
    """{kernel key: block function} of the kernels an n^3 grid can take:
    the plane kernel and the field kernel always, the cluster kernel
    where it fits."""
    out = {"fdtd3d_div_coop": fops.fdtd3d_block_div_coop,
           "fdtd3d_field": fops.fdtd3d_block_field}
    if fops.fdtd_schedule(n, "div").route == "cluster":
        out["fdtd3d_div"] = fops.fdtd3d_block_div_cluster
    return out


def fdtd_receivers(torch, fops, n, src, tracks, device):
    """Per-track receivers along the line, track 0 on the source cell."""
    xs, ys, zs = fops.receiver_line(tracks, n)
    cells = (xs.astype("int64") * n + ys) * n + zs
    cells[0] = fops.flat_cell(src, n)
    return torch.from_numpy(cells.astype("int32")).to(device)


def compare_fdtd(torch, fops, room, s, device, tracks=128):
    """Each route's kernels vs their twins bit for bit (so the routes
    equal each other where both run), the field kernel with per-track
    receivers and with the broadcast receiver, and div vs field within
    FDTD_RTOL, over 2 chained blocks; returns {kernel: max |kernel -
    twin|}."""
    n, src, rcv = fdtd_geometry(fops, room)
    x = fdtd_x(torch, tracks, s, device)
    cells = fdtd_receivers(torch, fops, n, src, tracks, device)
    routes = fdtd_routes(fops, n)
    state = {k: (fops.zero_fields_div(n, device) if "div" in k
                 else fops.zero_fields(n, device)) for k in routes}
    dp, fp = fops.zero_fields_div(n, device), fops.zero_fields(n, device)
    before = dict(fops.KERNEL_LAUNCHES)
    cross = 0.0
    for blk in range(2):
        want_d = fops.fdtd3d_block_div_plain(x, *dp, src, rcv)
        want_f = fops.fdtd3d_block_field_plain(x, *fp, src, rcv)
        want_t = fops.fdtd3d_block_field_plain(x, *fp, src, rcv,
                                               receivers=cells)
        tag = f"room {room} S={s} block {blk}"
        for key, fn in routes.items():
            if "div" in key:
                got = fn(x, *state[key], src, rcv)
                fdtd_same(torch, f"{key} {tag}", got, want_d)
            else:
                fdtd_same(torch, f"{key} broadcast {tag}",
                          fn(x, *state[key], src, rcv), want_f)
                got = fn(x, *state[key], src, rcv, receivers=cells)
                fdtd_same(torch, f"{key} {tracks} per-track {tag}", got,
                          want_t)
            state[key] = got[1:]
        dp, fp = want_d[1:], want_f[1:]
        cross = max(cross,
                    fdtd_check(torch, f"div vs field {tag}", want_d[0],
                               want_f[0]),
                    fdtd_check(torch, f"div vs field p {tag}", want_d[1],
                               want_f[1]))
    if want_d[0].abs().max().item() <= 0:
        fail(f"fdtd room {room}: the receiver heard nothing")
    if len(set(want_t[0][:, -1].tolist())) < 2:
        fail(f"fdtd room {room}: every per-track receiver read the same")
    torch.cuda.synchronize()
    for k in routes:
        want = 2 if "div" in k else 4
        if fops.KERNEL_LAUNCHES[k] - before[k] != want:
            fail(f"{k}: expected {want} launches")
    print(f"compare fdtd room {room} S={s}: ok  {', '.join(sorted(routes))} "
          f"bit for bit the twins (the field kernel with {tracks} per-track "
          f"receivers, one on the source cell, and broadcast), div vs field "
          f"{cross:.3g}")
    return {k: 0.0 for k in routes}


# Where each kernel is timed: (room, samples, tracks), {kernel key: the
# name its time goes under}; the field form with per-track receivers.
FDTD_TIMED = [(FDTD_MAIN, {"fdtd3d_div": "fdtd3d_div",
                           "fdtd3d_field": "fdtd3d_field"}),
              (FDTD_COOP, {"fdtd3d_div_coop": "fdtd3d_div_coop",
                           "fdtd3d_field": FDTD_FIELD_82_KEY}),
              (FDTD_BIG, {"fdtd3d_div_coop": FDTD_BIG_KEY})]


def time_fdtd(torch, fops, device):
    """CUDA-event times (ms) at FDTD_TIMED, each kernel against its twin:
    ({name: (ms, plain_ms)}, us per cluster barrier alone at room 50's
    layout)."""
    out = {}
    for (room, s, tracks), keys in FDTD_TIMED:
        n, src, rcv = fdtd_geometry(fops, room)
        x = fdtd_x(torch, tracks, s, device)
        cells = fdtd_receivers(torch, fops, n, src, tracks, device)
        zd, zf = fops.zero_fields_div(n, device), fops.zero_fields(n, device)
        routes = fdtd_routes(fops, n)
        fns = {
            key: ((lambda key=key: routes[key](x, *zd, src, rcv),
                   lambda: fops.fdtd3d_block_div_plain(x, *zd, src, rcv))
                  if "div" in key else
                  (lambda key=key: routes[key](x, *zf, src, rcv,
                                               receivers=cells),
                   lambda: fops.fdtd3d_block_field_plain(x, *zf, src, rcv,
                                                         receivers=cells)))
            for key in keys}
        for key, (kern, plain) in fns.items():
            k1 = median_ms(torch, kern, 5, 2)
            p1 = median_ms(torch, plain, 1, 1)
            k2 = median_ms(torch, kern, 5, 2)
            print(f"time {key} room {room}, {tracks}x{s} (CUDA events, "
                  f"median of reps): kernel {k1:.4f} / {k2:.4f} ms, plain "
                  f"twin {p1:.2f} ms")
            out[keys[key]] = (min(k1, k2), p1)
    syncs = 3 * FDTD_MAIN[1]
    plan = fops.fdtd_schedule(fops.grid_n(FDTD_MAIN[0]), "div")
    cl = median_ms(torch, lambda: fops.cluster_probe(
        plan.blocks, plan.smem_bytes, syncs, device), 5, 2) / syncs * 1e3
    print(f"time cluster barrier alone, {syncs} in one launch "
          f"({plan.blocks} blocks, {plan.smem_bytes:,} B each): {cl:.4f} us")
    return out, cl


def fdtd_bounds():
    """FDTD3D's count of each form (``models.fdtd3d.fdtd3d_cost``) where
    each kernel is timed (FDTD_TIMED): a boundary cell 1 FLOP a substep,
    an interior cell of the div form 11, the field form 3 a face and 7 an
    interior cell; the source sum, injection and receiver scale; the input
    and output, the carried fields read and written once, and the field
    form's receivers."""
    from gpuaudiobench_tpu_torch.models.fdtd3d import fdtd3d_cost

    out = {}
    for (room, s, tracks), keys in FDTD_TIMED:
        for key, name in keys.items():
            out[name] = cost_bound(fdtd3d_cost(room, s, tracks,
                                               "field" in key))
    return out


def sol_inputs(torch, rows, width, device, seed=13):
    import numpy as np

    g = np.random.Generator(np.random.MT19937(seed + rows))
    x = (g.random((rows, width), dtype=np.float32) * 2 - 1).astype(np.float32)
    return x, torch.from_numpy(x).to(device)


def compare_sol(torch, sops, device):
    """Both FMA kernels vs the twin and the closed form at SOL_SHAPES;
    returns {kernel: max |kernel - twin|}."""
    before = dict(sops.KERNEL_LAUNCHES)
    worst = {"fma_chain": 0.0, "fma_vmem": 0.0}
    for rows, width, k in SOL_SHAPES:
        host, x = sol_inputs(torch, rows, width, device)
        want = sops.fma_chain_plain(x, k)
        golden = torch.from_numpy(sops.fma_golden(host, k)).to(device)
        for name in worst:
            got = getattr(sops, name)(x, k)
            if tuple(got.shape) != (rows, width) or not torch.isfinite(got).all():
                fail(f"{name} {rows}x{width} k={k}: shape "
                     f"{tuple(got.shape)} or non-finite output")
            err = (got - want).abs().max().item()
            gerr = (got - golden).abs().max().item()
            if not (err <= SOL_ATOL and gerr <= SOL_GOLDEN_ATOL):
                fail(f"{name} {rows}x{width} k={k}: max|kernel - twin| "
                     f"{err:.3g} (<= {SOL_ATOL:g}), max|kernel - golden| "
                     f"{gerr:.3g} (<= {SOL_GOLDEN_ATOL:g})")
            worst[name] = max(worst[name], err)
        if not torch.equal(sops.fma_chain(x, k), sops.fma_vmem(x, k)):
            fail(f"fma_chain and fma_vmem differ at {rows}x{width} k={k}")
    torch.cuda.synchronize()
    for name in worst:
        if sops.KERNEL_LAUNCHES[name] - before[name] != 2 * len(SOL_SHAPES):
            fail(f"{name}: expected {2 * len(SOL_SHAPES)} launches")
    print("compare fma_chain / fma_vmem at "
          + ", ".join(f"{r}x{w} k={k}" for r, w, k in SOL_SHAPES)
          + f": ok  max|kernel - twin| fma_chain {worst['fma_chain']:.3g}, "
          f"fma_vmem {worst['fma_vmem']:.3g}; the two bit-equal")
    return worst


def time_sol(torch, sops, device):
    """CUDA-event times (ms) of each FMA kernel and the twin at its
    benchmark's default shape, in turns (twin, kernel, kernel, twin):
    {kernel: (ms, plain_ms)}."""
    out = {}
    for name, (rows, width, k) in (("fma_chain", SOL_FMA_FULL),
                                   ("fma_vmem", SOL_VMEM_FULL)):
        _, x = sol_inputs(torch, rows, width, device)
        kern = getattr(sops, name)
        p1 = median_ms(torch, lambda: sops.fma_chain_plain(x, k), 3, 1)
        k1 = median_ms(torch, lambda: kern(x, k), TIMING_REPS, 20)
        k2 = median_ms(torch, lambda: kern(x, k), TIMING_REPS, 20)
        p2 = median_ms(torch, lambda: sops.fma_chain_plain(x, k), 3, 1)
        print(f"time {name} {rows}x{width} k={k} (CUDA events, median of "
              f"reps): kernel {k1:.4f} / {k2:.4f} ms, plain twin {p1:.3f} / "
              f"{p2:.3f} ms")
        out[name] = (min(k1, k2), min(p1, p2))
    return out


def sol_bounds():
    """The FMA kernels at their default shapes: x read and y written once,
    2 FLOP an element and pass. For fma_vmem this is the contract's bound
    of the function it computes (the FMAs); the shared-memory traffic its
    design forces (8 B an element and pass, 0.064 ms at 33.4 TB/s) is the
    bound of the kernel as built."""
    out = {}
    for name, (rows, width, k) in (("fma_chain", SOL_FMA_FULL),
                                   ("fma_vmem", SOL_VMEM_FULL)):
        n = rows * width
        out[name] = bound(2 * n * 4, 2 * k * n)
    return out


def check_roofline(label, rec):
    """The JSON's roofline section: present, with a peak source and a
    basis, and no share of a peak above SHARE_CAP_PCT. Returns it."""
    rl = rec.get("metadata", {}).get("roofline")
    if not rl or not rl.get("peak_source") or not rl.get("basis"):
        fail(f"{label}: no metadata.roofline with a peak_source and a basis")
    for key in ("hbm_pct_of_peak", "flops_pct_of_peak", "vmem_pct_of_peak"):
        if rl.get(key, 0.0) > SHARE_CAP_PCT:
            fail(f"{label}: roofline {key} {rl[key]:.1f} % > "
                 f"{SHARE_CAP_PCT:g} % [{rl['basis']}, {rl['peak_source']}]")
    return rl


def calibrate(cal, roofline, device_name):
    """Runs the calibration into a temporary file and checks it: all six
    peaks, none above SHARE_CAP_PCT of its data-sheet value, the
    shared-memory rate not above SHARE_CAP_PCT of 132 x 128 B x the
    card's maximum SM clock. Returns the payload."""
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cal.main(["--out", path, "--pipelineDepth", "0",
                           "--nRuns", "5", "--warmup", "1"])
        for ln in buf.getvalue().splitlines():
            print(f"calibrate: {ln}")
        if rc != 0:
            fail(f"calibrate_peaks returned {rc}")
        with open(path) as f:
            payload = json.load(f)
    finally:
        os.unlink(path)
    peaks = payload.get("peaks", {})
    if set(peaks) != set(roofline.SPEC_PEAK):
        fail(f"calibration peaks {sorted(peaks)} are not the six of "
             f"{sorted(roofline.SPEC_PEAK)}")
    if payload.get("device_kind") != device_name:
        fail(f"calibration device_kind {payload.get('device_kind')!r}")
    for key, rate in peaks.items():
        if rate > SHARE_CAP_PCT / 100 * roofline.SPEC_PEAK[key]:
            fail(f"calibrated {key} {rate:.4g} is above {SHARE_CAP_PCT:g} % "
                 f"of the data sheet's {roofline.SPEC_PEAK[key]:.4g}")
    clock = payload.get("clocks_max_sm") or ""
    try:
        mhz = float(clock.split()[0])
    except (ValueError, IndexError):
        fail(f"calibration: no maximum SM clock from nvidia-smi ({clock!r})")
    smem = 132 * 128 * mhz * 1e6
    if peaks["vmem_bytes_per_sec"] > SHARE_CAP_PCT / 100 * smem:
        fail(f"calibrated shared-memory rate {peaks['vmem_bytes_per_sec']:.4g}"
             f" B/s is above {SHARE_CAP_PCT:g} % of 132 x 128 B x {mhz} MHz")
    print("calibration: " + ", ".join(
        f"{k} {v:.4g} ({100 * v / roofline.SPEC_PEAK[k]:.1f} % of the data "
        "sheet)" for k, v in peaks.items())
        + f"; power limit {payload.get('power_limit')}, max SM clock {clock}")
    return payload


class TwinCalls:
    """Counts calls of every plain twin while the main paths run (none may
    run on the card): wraps the module functions, which the wrappers look
    up by name."""

    NAMES = {"modal": ("modal_bank_plain", "modal_folded_step_plain",
                       "modal_res_step_plain"),
             "iir": ("iir_biquad_plain", "iir_biquad_blockstate_plain",
                     "iir_cascade_plain"),
             "conv": ("conv1d_direct_plain",),
             "rndmem": ("rndmem_gather_plain",),
             "dwg": ("dwg_block_plain",),
             "fdtd": ("fdtd3d_block_div_plain", "fdtd3d_block_field_plain"),
             "sol": ("fma_chain_plain",)}

    def __init__(self, modules):
        self.modules = modules
        self.calls = 0
        self.saved = []

    def __enter__(self):
        for key, mod in self.modules.items():
            for name in self.NAMES[key]:
                fn = getattr(mod, name)
                self.saved.append((mod, name, fn))
                setattr(mod, name, self._counting(fn))
        return self

    def _counting(self, fn):
        def wrapped(*args, **kw):
            self.calls += 1
            return fn(*args, **kw)
        return wrapped

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def launch_counts(*modules):
    """Every wrapper's launch count, by kernel name (each ops module keeps
    its counts in a ``KERNEL_LAUNCHES`` dict)."""
    return {k: n for mod in modules for k, n in mod.KERNEL_LAUNCHES.items()}


def reset_counts(*modules):
    for mod in modules:
        for k in mod.KERNEL_LAUNCHES:
            mod.KERNEL_LAUNCHES[k] = 0


def quiet_main(cli, argv):
    """``cli.main(argv)`` with its output captured: (exit code, lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines()


def run_cli(cli, label, argv):
    """``quiet_main``; fails unless the CLI exits 0. Returns (the output
    lines, the wall seconds)."""
    t0 = time.perf_counter()
    rc, lines = quiet_main(cli, argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        for ln in lines[-20:]:
            print(f"cli: {ln}")
        fail(f"{label}: cli.main returned {rc}")
    return lines, wall


def cli_json(cli, label, argv):
    """One CLI run in-process, stdout captured; fails unless it exits 0
    and validation passed. Returns (the JSON result, the wall seconds)."""
    lines, wall = run_cli(cli, label, argv)
    try:
        start = lines.index("{")
        end = len(lines) - 1 - lines[::-1].index("}")
        rec = json.loads("\n".join(lines[start:end + 1]))
    except ValueError:
        fail(f"{label}: no JSON result in the CLI output")
    v = rec.get("validation", {})
    if v.get("status") != "SUCCESS":
        fail(f"{label}: validation {v}")
    return rec, wall


def cli_path(torch, cli, counts, label, argv, kernels, run=cli_json):
    """One CLI run (``run``: ``cli_json``, or ``cli_csv`` bound to its
    directory); fails unless the device tier used CUDA events and each of
    ``kernels`` launched. ``counts`` reads the launch counts, which the
    caller reset. Returns the launch counts of the run and its JSON."""
    rec, wall = run(cli, label, argv)
    launches = counts()
    v = rec["validation"]
    dstats = rec.get("device_statistics", {})
    if dstats.get("method") != "cuda-events":
        fail(f"{label}: device timing method {dstats.get('method')!r}")
    for k in kernels:
        if launches[k] <= 0:
            fail(f"{label}: {k} was not launched")
    rl = check_roofline(label, rec)
    st, sat = rec["statistics"], rec.get("saturated", {})
    marg = sat.get("marginal") or {}
    print(f"cli {label}: {wall:.1f} s, round trip p50 {st['p50_ms']:.4f} / "
          f"p99 {st['p99_ms']:.4f} ms, device p50 {dstats['median_ms']:.4f} "
          f"ms [cuda-events], saturated p50 {sat.get('p50_ms', 0):.4f} ms, "
          f"marginal p50 {marg.get('p50_ms', 0):.4f} ms "
          f"({sat.get('blocks_per_sec', 0):.1f} blocks/s "
          f"[{sat.get('blocks_per_sec_basis')}]), validation max error "
          f"{v['max_error']:.3g}, roofline [{rl['basis']}] "
          + ", ".join(f"{k} {rl[k]:.1f} %" for k in (
              "hbm_pct_of_peak", "flops_pct_of_peak", "vmem_pct_of_peak")
              if k in rl)
          + f" ({rl['bound']}), launches "
          + ", ".join(f"{k} {n}" for k, n in launches.items() if n))
    return launches, rec


def datacopy_phase(cli):
    """The five datacopy benchmarks at 100 MiB through the CLI; each must
    validate and upload from pinned memory. Returns datacopy0199's p50."""
    p50 = {}
    for name in DATACOPY_NAMES:
        rec, wall = cli_json(cli, name, ["--benchmark", name] + DATACOPY_CLI)
        tmc = rec["metadata"]["transferMemoryClass"]
        if tmc.get("h2d_path_used") != "pinned":
            fail(f"{name}: uploads took the {tmc.get('h2d_path_used')} path")
        check_roofline(name, rec)
        st = rec["statistics"]
        p50[name] = st["p50_ms"]
        pc50, pc95 = TAB5_PC[name]
        print(f"datacopy {name} at 100 MiB: {wall:.1f} s, round trip p50 "
              f"{st['p50_ms']:.4f} / p95 {st['p95_ms']:.4f} ms (tab5 PC "
              f"{pc50} / {pc95}), device p50 "
              f"{rec['device_statistics']['median_ms']:.4f} ms, validation "
              f"max error {rec['validation']['max_error']:.3g}; A/B of "
              f"{tmc['ab_mib']} MiB: H2D pageable {tmc['h2d_pageable_ms']} / "
              f"pinned {tmc['h2d_pinned_ms']} ms, D2H pageable "
              f"{tmc['d2h_pageable_ms']} / pinned {tmc['d2h_pinned_ms']} ms")
    return p50["datacopy0199"]


def paced(cli, label, argv):
    """A DAW-sim run: its JSON, after checking that the native pacer ran."""
    rec, wall = cli_json(cli, label, argv)
    pacer = rec["deadline"].get("pacer")
    if pacer != "native":
        fail(f"{label}: the {pacer} pacer ran, not the native one")
    return rec, wall


def dawsim_phase(cli, counts, reset, launches, datacopy0199_p50):
    """ModalFilterBank at 1M modes with pacing off, sleep and spin beside
    tab7 (each must launch the modal kernel; adds the launches), and
    datacopy0199 at 100 MiB paced by spinning beside tab8."""
    for mode, flags in DAWSIM_MODES.items():
        label = f"ModalFilterBank 1M modes, DAW-sim {mode}"
        run = paced if flags else cli_json
        reset()
        rec, wall = run(cli, label, DAWSIM_MODAL + flags)
        n = counts()
        if n["modal_bank"] <= 0:
            fail(f"{label}: modal_bank was not launched")
        for k, v in n.items():
            launches[k] += v
        st, dl = rec["statistics"], rec["deadline"]
        pc50, pc95 = TAB7_PC[mode]
        paced_part = (f", miss rate {dl['miss_rate_percent']:.1f} % "
                      f"({dl['pacer']} pacer)" if flags else "")
        print(f"dawsim {label}: {wall:.1f} s, p50 {st['p50_ms']:.4f} / p95 "
              f"{st['p95_ms']:.4f} ms (tab7 PC {pc50} / {pc95}){paced_part}")
    label = "datacopy0199 100 MiB, DAW-sim spin"
    rec, wall = paced(cli, label, ["--benchmark", "datacopy0199"]
                      + DATACOPY_CLI + DAWSIM_MODES["spin"])
    p50 = rec["statistics"]["p50_ms"]
    print(f"dawsim {label}: {wall:.1f} s, p50 {p50:.4f} ms against "
          f"{datacopy0199_p50:.4f} unpaced: x{p50 / datacopy0199_p50:.3f} "
          f"(tab8 PC x{TAB8_PC_IO_0199}), miss rate "
          f"{rec['deadline']['miss_rate_percent']:.1f} %")


def overlap_phase(cli, counts, reset, launches, runs=OVERLAP_RUNS):
    """The overlapped-infeed tier on each path of ``runs``; the path's
    kernel must launch at least once a block. Adds the launches."""
    for label, argv, kernels in runs:
        reset()
        rec, wall = cli_json(cli, label, argv + OVERLAP_CLI)
        n = counts()
        for k in kernels:
            if n[k] < OVERLAP_BLOCKS:
                fail(f"{label}: {k} launched {n[k]} times, fewer than the "
                     f"{OVERLAP_BLOCKS} blocks of the overlap pass")
        for k, v in n.items():
            launches[k] += v
        ov = rec.get("overlapped")
        if not ov or ov["depth"] != OVERLAP_DEPTH or ov["reps"] != OVERLAP_REPS:
            fail(f"{label}: overlapped section {ov}")
        print(f"overlap {label}: {wall:.1f} s, a block serial p50 "
              f"{ov['serial_p50_ms']:.4f} ms, overlapped p50 "
              f"{ov['overlapped_p50_ms']:.4f} / p95 "
              f"{ov['overlapped_p95_ms']:.4f} ms (x"
              f"{ov['speedup_vs_serial']:.2f}), launches "
              + ", ".join(f"{k} {v}" for k, v in n.items() if v))


def overlap_check(torch, registry, config, overlap, device,
                  checks=OVERLAP_CHECKS):
    """The overlapped loop's last output and carry after OVERLAP_DEPTH
    blocks, bit for bit the serial loop's, from one starting carry."""
    for name, tracks in checks:
        cfg = config.BenchConfig(n_tracks=tracks, verification="spot")
        b = registry.create_benchmark(name, cfg, device)
        b.setup()
        step, blocks, carry = b.overlap_body()
        infeed = overlap.Infeed(blocks, device)

        def fresh():
            if isinstance(carry, torch.Tensor):
                return carry.clone()
            return tuple(c.clone() for c in carry)

        got = {}
        for kind, loop in (("serial", overlap.run_serial),
                           ("overlapped", overlap.run_overlapped)):
            y, c = loop(infeed, step, fresh(), OVERLAP_DEPTH)
            flat = [y] + ([c] if isinstance(c, torch.Tensor) else list(c))
            got[kind] = [t.cpu() for t in flat]
        for i, (a, o) in enumerate(zip(got["serial"], got["overlapped"])):
            if not torch.equal(a, o):
                fail(f"overlap {name} at {tracks}: tensor {i} of the "
                     "overlapped loop differs from the serial loop's")
        print(f"overlap check {name} at {tracks}: last output and carry "
              f"after {OVERLAP_DEPTH} blocks bit for bit the serial loop's "
              f"({len(got['serial'])} tensors)")
        del b, infeed, got




def cli_csv(cli, output, tmpdir, label, argv):
    """One CLI run without ``--json``: the summary printed, then the latency
    file and the CSV row written into ``tmpdir``. The run's result is taken
    from the CSV writer as it writes. Fails unless the CSV (header and row)
    equals what ``csv_from_json_results`` derives from the run's JSON
    (``generate_json_results`` of that result on that device) and the
    latency file holds every round trip. Returns (the JSON, the wall
    seconds)."""
    stem = os.path.join(tmpdir, label.split(",")[0].replace(" ", "_"))
    csv_path, lat_path = stem + ".csv", stem + "_latencies.txt"
    seen = []
    real = output.write_csv_results

    def capture(result, cfg, filename, device=None):
        seen.append((result, cfg, device))
        return real(result, cfg, filename, device)

    output.write_csv_results = capture
    try:
        _, wall = run_cli(cli, label, argv + ["--outputfile", csv_path,
                                              "--latenciesFile", lat_path])
    finally:
        output.write_csv_results = real
    if len(seen) != 1:
        fail(f"{label}: {len(seen)} CSV writes, expected 1")
    result, cfg, device = seen[0]
    rec = output.generate_json_results(result, cfg, device)
    with open(csv_path) as f:
        live = f.read()
    derived = output.csv_from_json_results([rec])
    if live != derived:
        print(f"csv live:    {live!r}")
        print(f"csv derived: {derived!r}")
        fail(f"{label}: the CSV written live differs from the one derived "
             "from the run's JSON")
    with open(lat_path) as f:
        lat = f.read().splitlines()
    n = len(result.latencies)
    if f"# Count: {n}" not in lat or len(lat) != 11 + n:
        fail(f"{label}: the latency file does not hold the {n} round trips")
    if rec.get("validation", {}).get("status") != "SUCCESS":
        fail(f"{label}: validation {rec.get('validation')}")
    print(f"csv {label}: the live row equals the one derived from the "
          f"JSON: {live.splitlines()[-1]}")
    return rec, wall


def csv_schema_check(cli, output, tmpdir):
    """``--csvSchema metal`` writes Metal's header and one row; a run of
    the CUDA schema appending to that file exits nonzero and leaves it as
    it was."""
    path = os.path.join(tmpdir, "metal.csv")
    argv = ["--benchmark", "PartConv", "--nRuns", "3", "--warmup", "1",
            "--verification", "spot", "--no-device-timing", "--outputfile",
            path, "--latenciesFile", os.path.join(tmpdir, "metal_lat.txt")]
    rc, lines = quiet_main(cli, argv + ["--csvSchema", "metal"])
    if rc != 0:
        fail(f"csv metal: cli.main returned {rc}: {lines[-5:]}")
    with open(path) as f:
        rows = f.read().splitlines()
    if (len(rows) != 2 or rows[0] != output.METAL_CSV_HEADER
            or not rows[1].startswith("PartConv,")):
        fail(f"csv metal: {rows}")
    rc, lines = quiet_main(cli, argv)
    with open(path) as f:
        after = f.read().splitlines()
    if rc == 0 or after != rows:
        fail(f"csv: appending the cuda schema to a metal file exited {rc}, "
             f"file {after}")
    refusal = next((ln for ln in lines if "different CSV schema" in ln), "")
    print(f"csv metal: header {rows[0]!r}, row {rows[1]}; the cuda schema "
          f"appended to it exits {rc} ({refusal.strip()[:80]})")


def sync_free(torch, registry, config, device, paths=SYNC_FREE_PATHS):
    """SYNC_FREE_BLOCKS chained stream blocks of each path after a warm
    pass, under ``torch.cuda.set_sync_debug_mode("error")``: none may wait
    for the device. The probes are read after the window."""
    for label, name, knobs in paths:
        cfg = config.BenchConfig(verification="none", device_timing=False,
                                 **knobs)
        b = registry.create_benchmark(name, cfg, device)
        b.setup()
        step, carry = b.stream_body()
        for _ in range(4):
            carry, _ = step(carry)
        torch.cuda.synchronize()
        probes = []
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(SYNC_FREE_BLOCKS):
                carry, p = step(carry)
                probes.append(p)
        except RuntimeError as e:
            torch.cuda.set_sync_debug_mode("default")
            fail(f"sync-free {label}: {e}")
        torch.cuda.set_sync_debug_mode("default")
        vals = torch.cat(probes).cpu()
        if not bool(torch.isfinite(vals).all()) or float(vals[-1]) <= 0:
            fail(f"sync-free {label}: probes {vals[-4:].tolist()}")
        print(f"sync-free {label}: {SYNC_FREE_BLOCKS} chained blocks with no "
              f"host sync, last probe {float(vals[-1]):.6g}")
        del b, step, carry, probes


def session_phase(torch, cli, output, registry, config, models_session,
                  counts, reset, launches, device):
    """Phase 12: PartConv at 1,536 tracks in each form, DAWSessionMix at
    65,536 strips and 16 stages at 128 (each validated; the session's EQ
    kernel launched exactly once a block), the overlap tier on both, the
    CSV and latency files, and the sync-free chains. Adds the launches."""
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_csv_")

    def csv_run(c, label, argv):
        return cli_csv(c, output, tmpdir, label, argv)

    def json_run(c, label, argv):
        return cli_json(c, label, argv + ["--json"])

    try:
        pc = {}
        for form, flags in PARTCONV_FORMS.items():
            label = f"PartConv {form}, 1536 tracks"
            reset()
            n, rec = cli_path(torch, cli, counts, label,
                              PARTCONV_WIDE + flags + PARTCONV_CLI, [],
                              run=csv_run if form == "shift" else json_run)
            for k, v in n.items():
                launches[k] += v
            rl = rec["metadata"]["roofline"]
            b_ms, b_by = bound(rl["hbm_bytes_per_block"], rl["flops_per_block"])
            dev_ms = rec["device_statistics"]["median_ms"]
            pc[form] = rec
            print(f"PartConv {form}: device p50 {dev_ms:.4f} ms against its "
                  f"cost-model bound {b_ms:.4f} ms ({b_by}), {b_ms / dev_ms:.2%}"
                  f"; fdlBytes {rec['metadata']['fdlBytes']}, validation max "
                  f"error {rec['validation']['max_error']:.3g}")
        sh, rg = pc["shift"], pc["ring"]
        print("PartConv A/B at 1536 tracks, shift vs ring: device p50 "
              f"{sh['device_statistics']['median_ms']:.4f} / "
              f"{rg['device_statistics']['median_ms']:.4f} ms, saturated p50 "
              f"{sh['saturated']['p50_ms']:.4f} / "
              f"{rg['saturated']['p50_ms']:.4f} ms, marginal p50 "
              f"{sh['saturated']['marginal']['p50_ms']:.4f} / "
              f"{rg['saturated']['marginal']['p50_ms']:.4f} ms, round trip "
              f"p50 {sh['statistics']['p50_ms']:.4f} / "
              f"{rg['statistics']['p50_ms']:.4f} ms")

        blocks = [0]
        real_block = models_session.session_block

        def counted(*args, **kw):
            blocks[0] += 1
            return real_block(*args, **kw)

        for label, argv, run in (
                ("DAWSessionMix, 65536 strips", SESSION_WIDE + SESSION_CLI,
                 csv_run),
                ("DAWSessionMix K=16, 128 strips", SESSION_K16 + SESSION_CLI,
                 json_run)):
            reset()
            blocks[0] = 0
            models_session.session_block = counted
            try:
                n, rec = cli_path(torch, cli, counts, label, argv,
                                  ["iir_cascade"], run=run)
            finally:
                models_session.session_block = real_block
            if n["iir_cascade"] != blocks[0]:
                fail(f"{label}: iir_cascade launched {n['iir_cascade']} "
                     f"times in {blocks[0]} session blocks")
            for k, v in n.items():
                launches[k] += v
            print(f"{label}: iir_cascade launched once a block "
                  f"({blocks[0]} blocks), validation max error "
                  f"{rec['validation']['max_error']:.3g} of the golden's peak")

        overlap_phase(cli, counts, reset, launches, SESSION_OVERLAP_RUNS)
        csv_schema_check(cli, output, tmpdir)
        sync_free(torch, registry, config, device)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def lstm_replays_expected(argv) -> int:
    """LSTM blocks one CLI run makes (each one graph replay): set-up's
    round trip, the warmup and timed round trips, the device tier's warm
    call and runs, and the saturated tier's warm pass and reps over its
    two depths (``harness/streaming.measure_saturated_marginal``)."""
    flag = {argv[i]: int(argv[i + 1]) for i in range(len(argv) - 1)
            if argv[i] in ("--nRuns", "--warmup", "--pipelineDepth",
                           "--saturatedReps")}
    runs, depth = flag["--nRuns"], flag["--pipelineDepth"]
    lo = max(1, depth // 4)
    return ((1 + flag["--warmup"] + runs) + (1 + min(runs, 20))
            + (lo + depth) * (1 + flag["--saturatedReps"]))


def lstm_graph_check(torch, registry, config, na, device):
    """One LSTM block replayed through its graph, bit for bit the same
    block run eagerly on the card, from a nonzero state, in f32 and bf16;
    the CUDA-event time of the eager block and of a replay."""
    for dtype in ("f32", "bf16"):
        cfg = config.BenchConfig(verification="none", device_timing=False,
                                 neuralamp_dtype=dtype)
        b = registry.create_benchmark("NeuralAmpLSTM", cfg, device)
        b.setup()  # one block from zero: the state is nonzero after it
        x = b._resident_input
        h, c = (t.clone() for t in b._state)
        run = na.lstm_runner(b._params, dtype, x, h, c)
        graphed = [t.clone() for t in run(x, h, c)]
        eager = na.lstm_block(x, h, c, b._params, dtype)
        for what, g, e in zip(("y", "h", "c"), graphed, eager):
            if not torch.equal(g, e):
                fail(f"LSTM {dtype}: the graphed block's {what} differs from "
                     "the eager block's by "
                     f"{float((g - e).abs().max()):.3g}")
        eager_ms = median_ms(torch, lambda: na.lstm_block(
            x, h, c, b._params, dtype), EAGER_REPS, 1)
        graph_ms = median_ms(torch, run, GRAPH_REPS, GRAPH_CALLS)
        print(f"LSTM {dtype} block at {b.track_count} x {b.buffer_size}, "
              f"H {b.channels}: the graph's y, h, c bit for bit the eager "
              f"block's; eager {eager_ms:.4f} ms, graphed {graph_ms:.4f} ms "
              f"(CUDA events, median of {EAGER_REPS} / {GRAPH_REPS} reps), "
              f"x{eager_ms / graph_ms:.2f}; deadline "
              f"{cfg.deadline_ms():.3f} ms")
        del b, run, graphed, eager


def neural_phase(torch, cli, registry, config, overlap, roofline, na, counts,
                 reset, device):
    """Phase 13: NeuralAmp in f32, bf16 and int8 at 128 tracks and f32 at
    256, NeuralAmpLSTM in f32 and bf16 at 128, each validated against its
    f64 golden with matmulPrecision "highest", every LSTM block a graph
    replay (``ops.neuralamp.GRAPH_REPLAYS``); the overlap tier on both,
    the overlapped loop bit for bit the serial one, the graphed LSTM block
    bit for bit the eager one with both times, and the sync-free
    chains."""

    def ncounts():
        return {**counts(), **na.GRAPH_REPLAYS}

    def nreset():
        reset()
        na.GRAPH_REPLAYS["lstm_block"] = 0

    launches = {k: 0 for k in ncounts()}  # none of the 14 may launch
    for label, argv in NEURAL_RUNS:
        lstm = "NeuralAmpLSTM" in argv
        nreset()
        n, rec = cli_path(torch, cli, ncounts, label, argv, [])
        md = rec["metadata"]
        if md.get("matmulPrecision") != "highest":
            fail(f"{label}: matmulPrecision {md.get('matmulPrecision')!r}")
        replays = n["lstm_block"]
        if lstm:
            want = lstm_replays_expected(argv)
            if md.get("blockForm") != "cuda-graph" or replays != want:
                fail(f"{label}: block form {md.get('blockForm')!r}, "
                     f"{replays} graph replays for {want} blocks")
        elif replays:
            fail(f"{label}: {replays} LSTM graph replays")
        if any(v for k, v in n.items() if k != "lstm_block"):
            fail(f"{label}: launched {n}")
        rl = md["roofline"]
        t_ops = rl["flops_per_block"] / roofline.SPEC_PEAK[
            roofline.UNIT_PEAK_KEY[rl["unit"]]] * 1e3
        t_bytes = rl["hbm_bytes_per_block"] / HBM_BYTES_PER_S * 1e3
        dev_ms = rec["device_statistics"]["median_ms"]
        print(f"{label}: device p50 {dev_ms:.4f} ms against its cost-model "
              f"bound {max(t_ops, t_bytes):.4f} ms ("
              f"{'operations' if t_ops >= t_bytes else 'bytes'} at the "
              f"data-sheet {rl['unit']} peak), saturated p50 "
              f"{rec['saturated']['p50_ms']:.4f} ms, round trip p50 "
              f"{rec['statistics']['p50_ms']:.4f} ms, max error "
              f"{rec['validation']['max_error']:.3g} of the golden's peak; "
              f"matmulPrecision highest"
              + (f", {replays} graph replays" if lstm else ""))
    overlap_phase(cli, ncounts, nreset, launches, NEURAL_OVERLAP_RUNS)
    overlap_check(torch, registry, config, overlap, device,
                  NEURAL_OVERLAP_CHECKS)
    lstm_graph_check(torch, registry, config, na, device)
    sync_free(torch, registry, config, device, NEURAL_SYNC_FREE_PATHS)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not importable")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    try:
        from gpuaudiobench_tpu_torch import (
            bench,
            calibrate_peaks,
            cli,
            config,
            registry,
        )
        from gpuaudiobench_tpu_torch.harness import output, overlap
        from gpuaudiobench_tpu_torch.models import modal as models_modal
        from gpuaudiobench_tpu_torch.models import session as models_session
        from gpuaudiobench_tpu_torch.ops import conv as cops
        from gpuaudiobench_tpu_torch.ops import dwg as dops
        from gpuaudiobench_tpu_torch.ops import fdtd3d as fops
        from gpuaudiobench_tpu_torch.ops import iir as iops
        from gpuaudiobench_tpu_torch.ops import modal as ops
        from gpuaudiobench_tpu_torch.ops import neuralamp as na
        from gpuaudiobench_tpu_torch.ops import rndmem as rops
        from gpuaudiobench_tpu_torch.ops import speedoflight as sops
        from gpuaudiobench_tpu_torch.utils import build
        from gpuaudiobench_tpu_torch.utils import device as dev
        from gpuaudiobench_tpu_torch.utils import roofline
    except ImportError as e:
        fail(f"the port's package is not importable here ({e}); run from "
             "the root of a checkout")

    t_start = time.perf_counter()
    smi = toolchain(torch, build, dev)
    device = dev.device("cuda")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the blockstate twin needs full FP32")

    t0 = time.perf_counter()
    libs = build.build_all(["modal_bank", "iir", "conv1d", "rndmem", "dwg",
                            "fdtd3d", "speedoflight"])
    for mod in (ops, iops, cops, rops, dops, fops, sops):
        mod._lib()
    print(f"build: {', '.join(p.name for p in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")

    errs = [compare(torch, ops, shape, device) for shape in SHAPES]
    modal_err = {"modal_bank": max(e[0] for e in errs),
                 "modal_res": max(e[1] for e in errs)}
    modal_times = time_main_shape(torch, ops, device)

    t0 = time.perf_counter()
    iir_err = {}
    for tracks, s in IIR_SHAPES:
        for k, v in compare_iir(torch, iops, tracks, s, device).items():
            iir_err[k] = max(iir_err.get(k, 0.0), v)
    for k, v in compare_cascade_edges(torch, iops, device).items():
        iir_err[k] = max(iir_err[k], v)
    iir_times = time_iir(torch, iops, device)
    b_ms, b_by = iir_bounds(128)["iir_cascade_chain"]
    ms = iir_times["iir_cascade_chain"][0]
    print(f"time iir_cascade_chain {IIR_FULL[0]}x{IIR_FULL[1]}: {ms:.4f} ms "
          f"against its bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.2%}")
    print(f"IIR kernels vs twins: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    conv_err = max(compare_conv(torch, cops, shape, device)
                   for shape in CONV_SHAPES)
    conv_times = time_conv(torch, cops, device)
    print(f"conv1d kernel vs twin: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    pool, ph, rndmem_err = compare_rndmem(torch, rops, device)
    rndmem_times = time_rndmem(torch, rops, pool, ph)
    del pool, ph
    print(f"rndmem_gather kernel vs twin: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    dwg_err = max(compare_dwg(torch, dops, shape, device)
                  for shape in DWG_SHAPES)
    dwg_times = time_dwg(torch, dops, device)
    print(f"dwg_block kernel vs twin: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    fdtd_err = {k: 0.0 for k in FDTD_REPLACES}
    for room, s in FDTD_SHAPES:
        for k, v in compare_fdtd(torch, fops, room, s, device).items():
            fdtd_err[k] = max(fdtd_err[k], v)
    fdtd_times, _ = time_fdtd(torch, fops, device)
    for key in (FDTD_FIELD_82_KEY, FDTD_BIG_KEY):
        b_ms, b_by = fdtd_bounds()[key]
        print(f"time {key}: {fdtd_times[key][0]:.4f} ms against its bound "
              f"{b_ms:.4f} ms ({b_by}), {b_ms / fdtd_times[key][0]:.2%}")
    print(f"fdtd kernels vs twins: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    sol_err = compare_sol(torch, sops, device)
    sol_times = time_sol(torch, sops, device)
    print(f"speed-of-light kernels vs twin: {time.perf_counter() - t0:.1f} s")

    card = torch.cuda.get_device_name(0)
    _, peak_source = roofline.resolve_peaks(card)
    print(f"roofline peaks for {card}: {peak_source}")

    # Main paths: every count is reset just before each path and read
    # just after; no plain twin may run in any of them.
    modules = (ops, iops, cops, rops, dops, fops, sops)

    def counts():
        return launch_counts(*modules)

    launches = {k: 0 for k in counts()}
    with TwinCalls({"modal": ops, "iir": iops, "conv": cops, "rndmem": rops,
                    "dwg": dops, "fdtd": fops, "sol": sops}) as twins:
        reset_counts(*modules)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = bench.main()
        wall = time.perf_counter() - t0
        launches["modal_bank"] = ops.KERNEL_LAUNCHES["modal_bank"]
        lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
        for ln in lines:
            print(f"bench: {ln}")
        if rc != 0:
            fail(f"bench.main() returned {rc}")
        rec = json.loads(lines[-1])
        if rec.get("validation") != "passed":
            fail(f"bench validation: {rec.get('validation')}")
        if rec.get("kernel_launches", 0) <= 0 or launches["modal_bank"] <= 0:
            fail("the main path launched no kernel")
        print(f"main path: {wall:.1f} s, {launches['modal_bank']} kernel "
              "launches, validation passed")

        reset_counts(*modules)
        t0 = time.perf_counter()
        res_rel = res_path(torch, ops, models_modal, device)
        launches["modal_res"] = ops.KERNEL_LAUNCHES["modal_res"]
        if launches["modal_res"] != RES_BLOCKS:
            fail(f"resonator path: {launches['modal_res']} launches for "
                 f"{RES_BLOCKS} blocks")
        print(f"resonator path: {RES_BLOCKS} chained blocks at M={MAIN_SHAPE[0]} "
              f"in {time.perf_counter() - t0:.1f} s, first block "
              f"{res_rel:.3g} of the peak from modal_reference_gs on tracks "
              f"{list(RES_SPOT_TRACKS)}")

        for label, argv, kernels in CLI_RUNS:
            reset_counts(*modules)
            for k, n in cli_path(torch, cli, counts, label, argv,
                                 kernels)[0].items():
                launches[k] += n
                if n and k in CLI_ABSENT.get(label, ()):
                    fail(f"{label}: {k} launched {n} times")

        # Pinned staging, DAW-sim pacing and the overlapped-infeed tier.
        t0 = time.perf_counter()
        def reset():
            reset_counts(*modules)

        p50_0199 = datacopy_phase(cli)
        dawsim_phase(cli, counts, reset, launches, p50_0199)
        overlap_phase(cli, counts, reset, launches)
        overlap_check(torch, registry, config, overlap, device)
        print(f"pinned staging, DAW-sim and overlap: "
              f"{time.perf_counter() - t0:.1f} s")

        # PartConv, DAWSessionMix, the CSV writer, the sync-free chains.
        t0 = time.perf_counter()
        session_phase(torch, cli, output, registry, config, models_session,
                      counts, reset, launches, device)
        print(f"PartConv, DAWSessionMix and CSV: "
              f"{time.perf_counter() - t0:.1f} s")

        # NeuralAmp and NeuralAmpLSTM.
        t0 = time.perf_counter()
        neural_phase(torch, cli, registry, config, overlap, roofline, na,
                     counts, reset, device)
        print(f"NeuralAmp and NeuralAmpLSTM: "
              f"{time.perf_counter() - t0:.1f} s")
        if twins.calls:
            fail(f"a plain twin ran {twins.calls} times on the main paths")

    t0 = time.perf_counter()
    calibrate(calibrate_peaks, roofline, card)
    print(f"calibration: {time.perf_counter() - t0:.1f} s")

    # Last of the checks: nothing is timed after a profiler session, which
    # slows the process's later launches (PERF.md §6).
    t0 = time.perf_counter()
    chain_kernel_names(torch, iops, device)
    print(f"profiler proof: {time.perf_counter() - t0:.1f} s")

    rows = []
    for name, replaces, (b_ms, b_by) in (
            ("modal_bank", REPLACES, modal_bound()),
            ("modal_res", RES_REPLACES, res_bound())):
        ms, p_ms = modal_times[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": modal_err[name],
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    iir_bound = iir_bounds(128)
    for name, replaces in IIR_REPLACES.items():
        ms, p_ms, lib_ms = iir_times[name]
        b_ms, b_by = iir_bound[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": IIR_SOURCE,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": iir_err[name],
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": lib_ms,
        })
    b_ms, b_by = conv_bound()
    rows.append({
        "name": "conv1d",
        "route": "cuda",
        "source": CONV_SOURCE,
        "replaces": CONV_REPLACES,
        "launches": launches["conv1d"],
        "max_abs_err": conv_err,
        "ms": conv_times[0],
        "plain_ms": conv_times[1],
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": conv_times[2],
    })
    slice_rows = [
        ("rndmem_gather", RNDMEM_SOURCE, RNDMEM_REPLACES, rndmem_err,
         rndmem_times,
         rndmem_bound()),
        ("dwg_block", DWG_SOURCE, DWG_REPLACES, dwg_err,
         (*dwg_times[:2], None), dwg_bound(dwg_times[2])),
    ] + [(name, FDTD_SOURCE, FDTD_REPLACES[name], fdtd_err[name],
          (*fdtd_times[name], None), fdtd_bounds()[name])
         for name in FDTD_REPLACES
    ] + [(name, SOL_SOURCE, SOL_REPLACES[name], sol_err[name],
          (*sol_times[name], None), sol_bounds()[name])
         for name in ("fma_chain", "fma_vmem")]
    for name, source, replaces, err, (ms, p_ms, lib_ms), (b_ms, b_by) in (
            slice_rows):
        rows.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": lib_ms,
        })
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
