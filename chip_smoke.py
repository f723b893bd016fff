#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure exits
nonzero:

1. Toolchain: torch, CUDA, nvcc, triton (optional) and the card's
   nvidia-smi name and power limit.
2. Build: the CUDA kernels from ``gpuaudiobench_tpu_torch/csrc``, one
   nvcc per source, all started together, and beside them with g++ the
   ``gpuab`` operator library (``csrc/torch_ops.cc``, linked to the
   kernels once they exist; every kernel is reached through one of its
   15 operators in every phase, each of which must have its CUDA
   implementation) and the native runner (``csrc/native_runner.cc``).
   Phases 3-9 compare under a dispatch mode that counts the ``gpuab``
   operators (``GpuabDispatches``): all 15 must be dispatched there.
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
   alone. Then the per-track receivers off the grid (``FDTD_OFF_GRID``):
   the kernel that buckets them by plane on the card vs its twin at room
   50 with 128 and 65,536 tracks and at rooms 1 and 137 (the cells and
   plane starts bit for bit, each plane's rows as a set), and the field
   kernel reading them bit for bit its twin over 2 blocks at rooms 8
   (the cells [503, -1, 7, 100] and [0, 1040, -1009, 12]) and 50 (128
   cells over [-2 n^3, 2 n^3)); CUDA-event times of the bucketing kernel
   and its twin at room 50, 128 and 65,536 tracks.
9. The two speed-of-light kernels (``fma_chain``, ``fma_vmem``) vs their
   plain twin within 1e-4 absolute and vs the closed form within 5e-4, at
   37 x 1,000 (k = 24), 64 x 1,024 (k = 130) and each SOL benchmark's
   default shape at k = 512; CUDA-event times of each kernel and the twin
   at the defaults.
10. Main paths, each with every launch count reset just before and read
   just after, and the plain twins counted (none may run). A kernel's
   launches are its wrapper's count plus those of the chain graphs'
   replays (``harness.graph.REPLAYED_LAUNCHES``: a replay makes every
   launch its capture recorded). Every path with a saturated tier must
   report ``metadata.chainForm`` "cuda-graph" (NeuralAmpLSTM "loop"), one
   replay a depth a rep and its untimed run, and its kernels replayed a
   whole number of times a chained block:
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
   without ``--fdtdPerTrackReceivers`` (with it the field kernel and the
   receivers' bucketing kernel must launch; without it the cluster
   kernel, not the plane kernel), and at
   room 82 x 64 samples (the plane kernel); each
   validates against the NumPy golden; then the CLI on the six SOL
   benchmarks at their defaults
   (``fma_chain`` must launch on SOL_VPU, ``fma_vmem`` on SOL_VMEM). On
   every CLI path the JSON's ``metadata.roofline`` must name its
   ``peak_source`` and ``basis``, and no share of a peak may pass 105 %.
   The paths at the CLI's depth of 512 run 5 round trips and 5
   saturated reps (``CLI_COMMON``); the DWG, FDTD and SOL paths fewer
   round trips and a shallower
   saturated tier (``DWG_CLI``, ``FDTD_CLI``): a DWG round trip at 32,768
   waveguides moves ~1 GB of rails through pageable memory and its host
   golden replays every iteration, and one FDTD block takes milliseconds
   (1,536 substeps, each waiting on neighbours), so the default depth of
   512 x 21 reps would take minutes (``SOL_CLI``: a SOL_MXU_f32 block is
   ~2.5 ms).
11. Pinned staging, DAW-sim pacing and the overlapped-infeed tier, still
   with the plain twins counted (none may run): the CLI on the five
   datacopy benchmarks at ``--transferMiB 100`` (10 runs, full
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
   at 65,536 strips (4 EQ stages, 48,000 taps; ``SESSION_CLI``: 2 runs)
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
13. NeuralAmp and NeuralAmpLSTM (no kernel of the 15: cuBLAS GEMMs and
   elementwise ops; the LSTM block one CUDA graph replay), still with the
   plain twins counted (none may run): the CLI on NeuralAmp at the JAX
   package's widths (C = 128, L = 10) in f32, bf16 and int8 at 128 tracks
   and in int8 at C = 12 (its GEMMs zero-padded to 16; ``NEURAL_CLI``: 5
   runs, depth 64, 5 reps), and on
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
   each of the six paths (the TCN in f32 at 256 tracks among them) under
   ``torch.cuda.set_sync_debug_mode("error")``.
14. The saturated chain as one CUDA graph (``harness.graph.ChainGraph``)
   against the loop of host launches, on ``GRAPH_PATHS``: the modal bank
   at 1,048,576 modes onto 32 tracks, IIRFilter at 65,536 and
   DAWSessionMix at 65,536 strips and at 16 stages x 128 (depth 512),
   DWG1DNaive at 32,768 and PartConv ring and nupols at 1,536 x 48,000
   taps (depth 64), FDTD3D at room 50 (cluster route, and per-track
   receivers on the field plane kernel) and room 82 x 64 samples (the
   plane route; depth 32). On each, a replay's probes bit for bit the
   loop's from the same entry carry (the cuFFT / cuBLAS bodies,
   ``GRAPH_LIBRARY_BODIES``, within their benchmark's tolerance of the
   peak probe, and named where they are not bit for bit), two replays bit
   for bit each other; capture and instantiation seconds, node counts,
   peak memory, and both forms' saturated and marginal p50 in turns.
   Then whether a chain of NeuralAmpLSTM blocks, each its own graph's
   replay, captures (the body is declared a loop either way).
15. The surfaces above the harness, still with the plain twins counted
   and every launch count reset per path: the soak tool
   (``gpuaudiobench_tpu_torch.tools.soak``) on the modal bank at
   1,048,576 modes onto 32 tracks for 20 s of audio, IIRFilter at 65,536
   tracks for 10 s, DWG1DNaive at 32,768 for 5 s (probe RMS 0 by
   construction, state RMS live) and PartConv ring and nupols at 1,536 x
   48,000 taps for 3 s each, every report printed, each in its chain
   form (``SOAKS``: a continuing CUDA graph, or the loop where the
   carry's Python values advance over a second: nupols), its kernel
   launched once a block; continuity (``CONTINUITY``): 3 seconds of the
   modal, DWG, ring and nupols soaks' forms (``soak.Seconds``) against
   282 eager steps from a clone of the entry carry, carry and probes bit
   for bit; checkpoint/resume on the modal soak, 3 s straight against
   1 s, a checkpoint and 2 s resumed in a fresh process, the
   checkpoints' leaves bit for bit; the capacity tool on FDTD3D's field
   form over rooms 16-128 (quantum 2, depth 8, 5 reps, no golden),
   printed beside ``tools/fdtd_stages``' 108-109, one ``--confirmOnly``
   in a fresh process, the ledger and the table with its flag column;
   overlap64 on gain and IIRFilter (the best tier a measured one); and
   the web UI on a free port: the catalog, a gain job at 65,536 tracks
   run to done with its phases, ``/api/hardware`` naming the card and
   ``/api/export.csv`` equal to ``csv_from_json_results`` of
   ``/api/export.json``.
16. The multi-device layer on one card (``parallel/``): NCCL's version,
   an all_reduce and an all_gather on cuda:0 in a one-rank NCCL group,
   each equal to its input; MultiChipSuite through the CLI at ``--mesh
   1,1,1`` at its defaults (128 tracks x 512, 4,096 modes, IR 33) and at
   65,536 tracks x 1,048,576 modes (``MULTICHIP_RUNS``), each validated
   against ``suite_reference`` at 1e-4 of the peak, its chain one CUDA
   graph, ``iir_biquad`` and ``modal_bank`` launched exactly 3 and 1
   times a step it ran (``multichip_launches``), its collective
   inventory empty; ICIBandwidth at 10 and 100 MiB, its one-rank ring (a
   device copy) bit for bit the input rolled; ``--mesh 2,1,1`` exiting 1
   with "needs 2 devices; 1 available" on one card (with two cards or
   more, ``--mesh 2,1,1`` and ``1,2,1`` over NCCL instead); the sharded
   FDTD, PartConv, TCN and LSTM blocks on one rank against the
   single-device paths on the card (``SHARDED_*``).
17. ``--dataParallel`` on one card: each of the 21 names the dp axis
   shards through the CLI at a small size (``DP_CLI``: the CLI's 128
   tracks x 512, 3 runs, depth 8; ``DP_NARROW``), once without the flag
   and once with
   ``--dataParallel 1``, still with the plain twins counted: both
   validate, and the second run's host arrays are the first's bit for
   bit, with the same ``metadata.chainForm`` and the same kernel launch
   counts; the modal headline (1,048,576 modes onto 32 tracks,
   ``DP_HEADLINE``) the same way; ``--dataParallel 2`` exiting 1 with
   "needs 2 devices; 1 available" on one card (with two cards or more,
   ``DP_MULTI_RANK`` over NCCL at ``--dataParallel 2`` instead, each
   validated); and NeuralAmp in int8 (``DP_INT8``) on 2 gloo ranks on
   the CPU (started beside phase 2's build) against its one-rank run:
   bit for bit, one ``pmax`` of the activation scale a layer.
18. The repo-level surfaces of the port, each through its ``main(argv)``
   on the card (``SURFACE_TOOLS``, ``SATREPS``, ``EXAMPLES``): the tab4
   sweep at 1,024, 102,400 and 1,048,576 modes, the tab6 sweep at its six
   track counts (32 to 65,536) on the 512 MiB pool, tab5 at 100 MiB
   (``--skip1gib``), the DAW-sim campaign (tab7 / tab8: the 1M bank,
   NoOp, datacopy0199 at 100 MiB, pacer off / sleep / spin), the
   low-latency sweep of ModalFilterBank, IIRFilter and FDTD3D at 64 and
   512 samples, 101 saturated reps on the modal headline, each exiting 0
   with every row validated, its kernels launched and its rows printed
   beside the published numbers; ``tools.report`` over the satreps JSON
   (the card's name and power limit on the page) and
   ``tools.compare_runs`` of it against itself; the six examples at
   their defaults, each printing its proof, with the exact kernel
   launches its blocks make (``multichip_synth``'s counted in its rank's
   process and printed); ``tools.doctor`` healthy. Before the main paths
   (beside phase 3), the bell example's 375 blocks (2,048 decaying modes
   onto one track) against the twin at every block.
19. The last repo-level surfaces (``DRIVER_RUNS``, ``REGEN``,
   ``REMEASURE``, ``OVERLAP_CAMPAIGN``, ``LATENCY_ATTRIB``): the native
   driver built from ``csrc/gpubench_main.cc`` (``utils/native.py``), its
   ``--list`` the registry's 30 names, ModalFilterBank at its defaults and
   IIRFilter at 65,536 tracks through the driver, through ``python -m``
   and through ``cli.main`` in this process (each validated on this card,
   the driver's JSON with the in-process run's keys, timed against
   ``python -m``), ``tools.json_to_csv`` of each equal to
   ``csv_from_json_results``; ``tools.regen_artifacts`` over
   ModalFilterBank, IIRFilter and FDTD3D (JSON, CSV, RESULTS.md,
   report.html naming the card and its power limit; ``render_results
   --check`` passes); ``tools.remeasure_rows`` of IIRFilter at 11
   saturated reps (the row replaced, the others byte-equal); the overlap
   campaign on its 13 names (each validated, its speedup printed);
   ``tools.readme_headline`` into a copy of README.md with the port's
   sentinels (``--check`` passes, the JAX block byte-equal); the latency
   attribution (A, B and the device p50 a workload); the mesh ladder
   (1,1,1 of both benchmarks validated, the rest printed as skipped). The
   driver's and ``python -m``'s launches are made in their own processes
   and not counted.
20. The native runner (``NATIVE_*``): the eight programs of
   ``tools.export_programs`` (the JAX exporter's names and shapes)
   exported on the card as AOTInductor packages, one process each, all
   started together after phase 9 and compiling beside phases 10-19 at
   the lowest CPU priority (``NativeExports``), and each run by
   ``native_runner`` in its own process with ``--runs 20``: each exits 0,
   its warm-up checksum within 1e-4 of
   max(|checksum|, 1) of the same port function's in this process on the
   same LCG inputs (whose kernels must launch), a runner process maps no
   libpython (its ``/proc/<pid>/maps``, during its runs); each program's
   export and compile seconds, load ms, the runner's p50 and p95 beside
   the same round trip's in this process, and the modal headline's
   saturated p50 beside PR 23's.
21. ``torch.export`` of one small step per operator of queue 1's item
   21b and of the receivers' bucketing (``EXPORT_OPS``: the resonator,
   the block-state kernel, the chain cascade, the gather, the DWG block,
   the FDTD field form's plane kernel, with the broadcast receiver and
   with per-track receivers off the grid (an input of the program), the
   bucketing and the two FMA chains), each through its wrapper on the
   card: the program holds its operators as nodes, its module runs on
   the card and dispatches each once, and its outputs (and the DWG rails
   it writes in place) equal the eager wrapper's bit for bit. No
   AOTInductor compile here.
22. Calibration: ``gpuaudiobench_tpu_torch.calibrate_peaks`` into a
   temporary file; fails unless all six peaks are there, none above 105 %
   of its data-sheet value, and the shared-memory rate not above 105 % of
   132 x 128 B x nvidia-smi's ``clocks.max.sm``.
23. ``--capture`` on the modal headline cell (``CAPTURE_CLI``): one
   profiler session writes a trace that must hold ``modal_bank`` device
   events; the busy time a block and idle share of its saturated tier's
   timed reps (graph replays), read from the trace.
24. ``torch.profiler`` names the kernels of each cascade wrapper's calls
   at 1,000 x 96 (``PROFILE_CALLS`` a wrapper, each wrapper in a
   ``record_function`` range of one session, read from its Chrome trace):
   the chain wrapper must launch the chain kernel
   alone (its coefficients' copy to the constant bank is a memcpy), the
   systolic wrapper the systolic kernel alone. The profiler sessions run
   after everything timed (a session slows the process's later launches).
25. A ``{"kernels": [...]}`` line (15 kernels: the 14 of the ported
   Pallas kernels and, beside the field kernel, the receivers'
   bucketing), the nvidia-smi line, and
   last the ``{"ok": true, "device": {...}}`` line.

Needs one CUDA device; exits 1 without printing a result when there is
none, or when the port's package is not beside this script.
"""

from __future__ import annotations

import atexit
import contextlib
import importlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
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
PROFILE_CALLS = 8  # chain_kernel_names: calls of each wrapper a session
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
# The bucketing kernel replaces no Pallas kernel of its own: it serves the
# field kernel's per-track receivers, so it goes under the field form's.
FDTD_REPLACES = {"fdtd3d_div": "gpuaudiobench_tpu/ops/fdtd3d_pallas.py:149",
                 "fdtd3d_field": "gpuaudiobench_tpu/ops/fdtd3d_pallas.py:77",
                 "fdtd3d_receiver_buckets":
                     "gpuaudiobench_tpu/ops/fdtd3d_pallas.py:77",
                 "fdtd3d_div_coop": "gpuaudiobench_tpu/ops/fdtd3d_pallas.py:149"}
# Per-track receivers off the grid: the bucketing kernel vs its twin at
# (tracks, room) (the main path's 128 at room 50, 65,536 there, a few in
# the smallest room and the largest a build takes), and the field kernel
# vs its twin on (room, cells); None: 128 cells drawn over
# [-2 n^3, 2 n^3).
FDTD_BUCKETS = [(128, 50), (65536, 50), (5, 1), (1000, 137)]
FDTD_OFF_GRID = [(8, [503, -1, 7, 100]), (8, [0, 1040, -1009, 12]),
                 (50, None)]
FDTD_BUCKETS_WIDE = 65536

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
CLI_COMMON = ["--nRuns", "5", "--warmup", "1", "--pipelineDepth", "512",
              "--saturatedReps", "5", "--verification", "spot", "--json"]
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
DWG_CLI = ["--nRuns", "2", "--warmup", "1", "--pipelineDepth", "64",
           "--saturatedReps", "3", "--verification", "spot", "--json"]
FDTD_CLI = ["--nRuns", "10", "--warmup", "2", "--pipelineDepth", "32",
            "--saturatedReps", "5", "--verification", "spot", "--json"]
# Room 82 on the plane kernel: 64-sample blocks (its NumPy golden
# at 512 samples would take most of a minute), 5 runs, depth 16.
FDTD_ROOM82 = ["--fdtdRoom", "82", "--bufferSize", "64", "--nRuns", "5",
               "--warmup", "1", "--pipelineDepth", "16", "--saturatedReps",
               "3", "--verification", "spot", "--json"]
# Kernels a CLI path must not launch: room 50 fits a cluster.
CLI_ABSENT = {"FDTD3D room 50, 128 tracks": ["fdtd3d_div_coop"]}
# Kernels no stream body launches, so no chain graph replays: the chain
# cascade is BiquadChain's validation oracle.
CHAIN_ABSENT = {"iir_cascade_chain"}
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
     ["fdtd3d_field", "fdtd3d_receiver_buckets"]),
    ("FDTD3D room 82, 128 tracks x 64",
     ["--benchmark", "FDTD3D"] + FDTD_ROOM82, ["fdtd3d_div_coop"]),
] + [(f"{name}, the defaults", ["--benchmark", name] + SOL_CLI,
      SOL_KERNELS.get(name, [])) for name in SOL_NAMES]

# The pinned-staging, DAW-sim and overlapped-infeed phase. The datacopy
# family at the poster's 100 MiB pool, 10 round trips, full verification;
# the PC rows (i7-12700 + RTX 4070, BASELINE.md) beside each: tab5 p50 /
# p95 ms, tab7 p50 / p95 ms (1M modes; pacing off, sleep, spin) and
# tab8's DAW-sim p50 multiplier for 100 MiB I/O 1/99.
DATACOPY_NAMES = ["datacopy0199", "datacopy2080", "datacopy5050",
                  "datacopy8020", "datacopy9901"]
DATACOPY_CLI = ["--transferMiB", "100", "--nRuns", "10", "--warmup", "2",
                "--verification", "full", "--json"]
TAB5_PC = {"datacopy0199": (10.06, 11.82), "datacopy2080": (9.84, 11.68),
           "datacopy5050": (9.57, 11.5), "datacopy8020": (9.37, 11.1),
           "datacopy9901": (9.09, 10.59)}
# ModalFilterBank at bench's shape: 1,048,576 modes onto 32 tracks.
DAWSIM_MODAL = ["--benchmark", "ModalFilterBank", "--nTracks", "1024",
                "--nRuns", "10", "--warmup", "2", "--verification", "spot",
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
SESSION_CLI = ["--nRuns", "2", "--warmup", "1", "--pipelineDepth", "64",
               "--saturatedReps", "3", "--verification", "spot"]
SESSION_WIDE = ["--benchmark", "DAWSessionMix", "--nTracks", "65536"]
SESSION_K16 = ["--benchmark", "DAWSessionMix", "--sessionEqStages", "16"]
# The overlapped-infeed tier on both at those widths.
SESSION_OVERLAP_RUNS = [
    ("PartConv shift, 1536 tracks", PARTCONV_WIDE, []),
    ("DAWSessionMix, 65536 strips", SESSION_WIDE, ["iir_cascade"]),
]
# NeuralAmp and NeuralAmpLSTM (phase 13) at the JAX package's default
# widths (C = H = 128, L = 10; gpuaudiobench_tpu/config.py:81-83): the TCN
# at 128 tracks in each dtype on PartConv's tier, and int8 at C = 12 (no
# multiple of 8: its GEMMs zero-padded to 16); the LSTM, whose block is
# one graph replay of 512 dependent steps, at 128 tracks on a shallower
# one. Full verification against the f64 goldens. The TCN at 256 tracks
# in f32 (its certified capacity, docs/RESULTS_r4_capacity.md:10) runs
# only its sync-free chain: its CLI run and golden were cut to keep the
# script inside its time limit.
NEURAL_CLI = ["--nRuns", "5", "--warmup", "1", "--pipelineDepth", "64",
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
    for name, dtype, tracks in NEURAL_PATHS if tracks == 128] + [
    ("NeuralAmp int8, 128 tracks, C = 12",
     ["--benchmark", "NeuralAmp", "--nTracks", "128", "--neuralampDtype",
      "int8", "--neuralampChannels", "12"] + NEURAL_CLI)]
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
# The saturated chain as one CUDA graph against the loop of host
# launches (phase 14): (label, benchmark, knobs, depth). The probes of a
# replay must equal the loop's from the same entry carry bit for bit
# (the cuBLAS / cuFFT bodies of GRAPH_LIBRARY_BODIES within their
# benchmark's validation tolerance of the loop's peak probe), and two
# replays each other; then GRAPH_REPS interleaved reps of both forms at
# depth // 4 and depth (saturated and marginal p50, in turns).
GRAPH_PATHS = [
    ("ModalFilterBank 1M modes onto 32 tracks", "ModalFilterBank",
     {"n_tracks": 1024}, 512),
    ("IIRFilter, 65536 tracks", "IIRFilter", {"n_tracks": 65536}, 512),
    ("DWG1DNaive, 32768 waveguides", "DWG1DNaive", {"n_tracks": 32768}, 64),
    ("DAWSessionMix, 65536 strips", "DAWSessionMix", {"n_tracks": 65536},
     512),
    ("DAWSessionMix K=16, 128 strips", "DAWSessionMix",
     {"session_eq_stages": 16}, 512),
] + [(f"PartConv {form}, 1536 tracks", "PartConv",
      {"n_tracks": 1536, "ir_length": 48000, "partconv_form": form}, 64)
     for form in ("ring", "nupols")] + [
    ("FDTD3D room 50, 128 tracks", "FDTD3D", {}, 32),
    ("FDTD3D room 50, per-track receivers", "FDTD3D",
     {"fdtd_per_track_receivers": True}, 32),
    ("FDTD3D room 82, 128 tracks x 64", "FDTD3D",
     {"fdtd_room": 82, "buffer_size": 64}, 32),
]
GRAPH_LIBRARY_BODIES = ("DAWSessionMix", "PartConv")
GRAPH_REPS = 7
# The surfaces above the harness (phase 15). Soaks: (label, the soak's
# argv after the seconds and the report path, seconds, kernels that must
# launch, the chain form). PartConv's ring head has period ceil(48000 /
# 512) = 94 blocks, one second, so its carry leaves a second as it came
# and the ring continues as one graph; the nupols phase has period K = 8,
# which 94 is not a multiple of, so nupols runs the loop.
SOAKS = [
    ("ModalFilterBank 1M modes onto 32 tracks",
     ["ModalFilterBank", "1024"], 20, ["modal_bank"], "cuda-graph"),
    ("IIRFilter, 65536 tracks", ["IIRFilter", "65536"], 10, ["iir_biquad"],
     "cuda-graph"),
    ("DWG1DNaive, 32768 waveguides", ["DWG1DNaive", "32768"], 5,
     ["dwg_block"], "cuda-graph"),
] + [(f"PartConv {form}, 1536 x 48000 taps",
      ["PartConv", "1536", "--set", "ir_length=48000", "--set",
       f"partconv_form={form}"], 3, [], chain)
     for form, chain in (("ring", "cuda-graph"), ("nupols", "loop"))]
# Continuity: (label, benchmark, knobs, the form) -- 3 seconds of the
# soak's form against 282 eager steps from a clone of the entry carry,
# carry and probes bit for bit.
CONTINUITY = [
    ("ModalFilterBank 1M modes", "ModalFilterBank", {"n_tracks": 1024},
     "cuda-graph"),
    ("DWG1DNaive, 32768 waveguides", "DWG1DNaive", {"n_tracks": 32768},
     "cuda-graph"),
] + [(f"PartConv {form}, 1536 x 48000 taps", "PartConv",
      {"n_tracks": 1536, "ir_length": 48000, "partconv_form": form},
      "cuda-graph" if form == "ring" else "loop")
     for form in ("ring", "nupols")]
CONTINUITY_SECONDS = 3
# Checkpoint continuity on the modal headline: 3 s straight against 1 s,
# a checkpoint, and 2 s resumed in a fresh process.
RESUME_SOAK = ["ModalFilterBank", "1024"]
# The capacity search of FDTD3D's field form (per-track receivers) over
# rooms 16-128, quantum 2, at a small depth and rep count and without
# the host golden; tools/fdtd_stages puts the form's deadline room
# at 108-109 behind a spin.
CAPACITY_ARGS = ["--benchmark", "FDTD3D", "--set",
                 "fdtd_per_track_receivers=true", "--nRuns", "2",
                 "--warmup", "1", "--pipelineDepth", "8", "--satReps", "5",
                 "--verification", "none"]
CAPACITY_SEARCH = ["--lo", "16", "--hi", "128", "--quantum", "2"]
FDTD_FIELD_DEADLINE_ROOM = "108-109"
OVERLAP64_ARGS = ["--reps", "3", "--workloads", "gain,IIRFilter"]
# The web UI's job: gain at 65,536 tracks.
UI_JOB = {"bufferSize": 512, "nTracks": 65536, "nRuns": 10, "warmup": 2,
          "verification": "spot"}
# The --capture run (after the calibration: a profiler session slows the
# process's later short launches): the modal headline cell on a short
# tier; its trace must hold modal_bank events inside the timed reps of
# the saturated tier, whose busy time and idle share are printed.
CAPTURE_CLI = ["--benchmark", "ModalFilterBank", "--nTracks", "1024",
               "--nRuns", "5", "--warmup", "1", "--pipelineDepth", "512",
               "--saturatedReps", "3", "--verification", "spot", "--json",
               "--capture"]

# The multi-device layer on one card (phase 16). MultiChipSuite through the
# CLI at --mesh 1,1,1: at its defaults (128 tracks x 512, 4,096 modes, IR
# 33) and at the headline bank's 1,048,576 modes over 65,536 tracks; each
# run's step launches the entry biquad, one stage biquad a microbatch and
# the partial bank (MULTICHIP_STEP_LAUNCHES).
MULTICHIP_CLI = ["--benchmark", "MultiChipSuite", "--nRuns", "10",
                 "--warmup", "2", "--pipelineDepth", "32", "--saturatedReps",
                 "5", "--json"]
MULTICHIP_RUNS = [("MultiChipSuite 1,1,1 defaults", []),
                  ("MultiChipSuite 1,1,1 65,536 x 1,048,576 modes",
                   ["--nTracks", "65536", "--modalModes", "1048576"])]
MULTICHIP_STEP_LAUNCHES = {"iir_biquad": 3, "modal_bank": 1}
ICI_CLI = ["--benchmark", "ICIBandwidth", "--nRuns", "10", "--warmup", "2",
           "--json"]
ICI_MIB = (10, 100)
MULTI_RANK_MESHES = ("2,1,1", "1,2,1")
# The sharded blocks on one rank against the single-device paths on the
# card: FDTD at the JAX grid, PartConv shift at PARTCONV_CLI's width, the
# TCN and LSTM at NeuralAmp's defaults; tolerances of the peak (FDTD:
# absolute, FDTD3D's).
SHARDED_FDTD = (128, 128)  # tracks, samples
SHARDED_PARTCONV = (1536, 48000, 512, 3)  # tracks, taps, block, blocks
SHARDED_NEURAL = (128, 512, 128, 10)  # tracks, samples, C or H, TCN layers
SHARDED_TOL = {"fdtd": 5e-3, "partconv": 1e-3, "tcn": 1e-5, "lstm": 1e-5}

# --dataParallel on one card (phase 17): the 21 names the dp axis shards,
# each through the CLI at a small size (the CLI's 128 tracks x 512;
# RndMemRead from a 64 MiB pool; NeuralAmp and NeuralAmpLSTM at 16 tracks,
# whose f64 host goldens take seconds at 128) with and without
# --dataParallel 1, which must give the same host arrays bit for bit, the
# same chain form and the same launches; then the modal headline
# (1,048,576 modes onto 32 tracks) the same way, and --dataParallel 2,
# which one card refuses. With two cards or more, DP_MULTI_RANK over NCCL
# instead.
DP_NAMES = ["NoOp", "gain", "GainStats", "datacopy0199", "datacopy2080",
            "datacopy5050", "datacopy8020", "datacopy9901", "FFT1D",
            "IIRFilter", "Conv1D", "Conv1D_accel", "ModalFilterBank",
            "DWG1DNaive", "DWG1DAccel", "RndMemRead", "BiquadChain",
            "PartConv", "NeuralAmp", "NeuralAmpLSTM", "DAWSessionMix"]
DP_CLI = ["--nRuns", "3", "--warmup", "1", "--pipelineDepth", "8",
          "--saturatedReps", "3", "--verification", "spot", "--poolMiB",
          "64", "--json"]
DP_NARROW = {"NeuralAmp": ["--nTracks", "16"],
             "NeuralAmpLSTM": ["--nTracks", "16"]}
DP_HEADLINE = ["--benchmark", "ModalFilterBank", "--nTracks", "1024",
               "--nRuns", "5", "--warmup", "1", "--pipelineDepth", "64",
               "--saturatedReps", "3", "--verification", "spot", "--json"]
DP_MULTI_RANK = ["gain", "IIRFilter", "ModalFilterBank", "DAWSessionMix"]
# int8 NeuralAmp on DP_INT8_RANKS gloo ranks on the CPU against its
# one-rank run (the activation scale is the whole batch's): config fields.
DP_INT8 = dict(buffer_size=64, n_tracks=16, n_runs=2, warmup=1,
               write_latencies=False, pipeline_depth=4, saturated_reps=2,
               neuralamp_dtype="int8", neuralamp_channels=12,
               neuralamp_layers=4)
DP_INT8_RANKS = 2

# The repo-level surfaces (phase 18): the poster-table campaigns, the
# results tools and the six audio examples, each through its
# ``main(argv)`` on the card. The campaigns at fewer runs than their
# defaults, to bound the phase's time; every point and every workload of
# their tables at full width.
SURFACE_TOOLS = [
    ("modal_sweep", "tab4", ["--nRuns", "5", "--satReps", "5"],
     ["modal_bank"]),
    ("rndmem_sweep", "tab6", ["--nRuns", "3", "--satReps", "5"],
     ["rndmem_gather"]),
    ("transfer_tab5", "tab5", ["--mib", "100", "--skip1gib", "--nRuns", "5",
                               "--overlapDepth", "4", "--overlapReps", "2"],
     []),
    ("dawsim_campaign", "tab7/tab8", ["--nRuns", "4"], ["modal_bank"]),
    ("lowlatency_sweep", "lowlatency",
     ["--benchmarks", "ModalFilterBank,IIRFilter,FDTD3D", "--buffers",
      "64,512", "--nRuns", "3", "--satReps", "3"],
     ["modal_bank", "iir_biquad", "fdtd3d_div"]),
]
SATREPS = ["101", "--benchmarks", "ModalFilterBank", "--", "--nTracks",
           "1024"]
# (example, its proof line, the kernel launches its defaults make): the
# bell's 375 blocks, 188 after the strike and 188 resumed; the room's 93
# blocks; the hall's 281 dry blocks; the chord's 6 bells x 281 blocks and
# its 281 EQ blocks; the mesh's one-rank reference and its one rank's
# render, 187 blocks each (counted in the rank's process, printed).
EXAMPLES = [
    ("streaming_synth", "checkpoint/resume bit-exact: True",
     {"modal_bank": 563}),
    ("room_impulse", "(stable)", {"fdtd3d_div": 93}),
    ("reverb", "streamed convolution matches offline: True",
     {"modal_bank": 281}),
    ("ampsim", "streamed inference matches offline: True", {}),
    ("session", "streamed session matches offline: True",
     {"modal_bank": 1686, "iir_cascade": 281}),
    ("multichip_synth", "matches one-rank render: True",
     {"modal_bank": 374}),
]
BELL = (2048, 4.0)  # the bell example's modes and seconds

# The last repo-level surfaces (phase 19): the native driver's runs (each
# also through ``python -m`` and in-process, with the same argv), the
# regen run's filter and sizes, the remeasured row, and the overlap and
# latency-attribution campaigns' sizes.
DRIVER_COMMON = ["--nRuns", "5", "--pipelineDepth", "64", "--saturatedReps",
                 "3", "--verification", "spot", "--json"]
DRIVER_RUNS = [
    ("ModalFilterBank", ["--benchmark", "ModalFilterBank"] + DRIVER_COMMON,
     ["modal_bank"]),
    ("IIRFilter 65536", ["--benchmark", "IIRFilter", "--nTracks", "65536"]
     + DRIVER_COMMON, ["iir_biquad"]),
]
REGEN = ["--benchmarkFilter", "/ModalFilterBank|IIRFilter|FDTD3D/",
         "--nRuns", "5", "--pipelineDepth", "64"]
REGEN_KERNELS = ["modal_bank", "iir_biquad", "fdtd3d_div"]
REMEASURE = ["IIRFilter", "--satReps", "11", "--nRuns", "5",
             "--pipelineDepth", "64"]
OVERLAP_CAMPAIGN = ["--depth", "16", "--reps", "2"]
# The native runner (phase 20): runs a program, the kernels each
# program's port function launches, the checksum's tolerance relative to
# max(|checksum|, 1), and the modal headline's saturated p50 in PR 23 (on
# the H100 80GB HBM3 at 700 W), when the kernel was called through ctypes.
NATIVE_RUNS = 20
NATIVE_MAPS_RUNS = 20000
NATIVE_RTOL = 1e-4
NATIVE_EXPORT_TIMEOUT = 300
NATIVE_RUN_TIMEOUT = 120
NATIVE_KERNELS = {"modal_pallas": ["modal_bank"],
                  "fdtd3d_pallas": ["fdtd3d_div"], "gain": [],
                  "iirfilter": ["iir_biquad"], "modal": ["modal_bank"],
                  "conv1d": ["conv1d"], "partconv": [],
                  "session": ["iir_cascade"]}
NATIVE_PR23_HEADLINE_MS = 0.1209
# The operators that queue 1's item 21b added (phase 21 exports a step of
# each); the six before them are phase 20's programs'.
EXPORT_OPS = ("modal_res_launch", "iir_blockstate_launch",
              "iir_cascade_chain_launch", "rndmem_gather_launch",
              "dwg_block_launch", "fdtd_field_planes_launch",
              "fma_chain_launch", "fma_vmem_launch", "fdtd_receiver_buckets")
OVERLAP_KERNELS = ["conv1d", "rndmem_gather", "iir_biquad", "dwg_block",
                   "iir_cascade"]
LATENCY_ATTRIB = ["--reps", "5"]


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
    """Each cascade wrapper, called PROFILE_CALLS times at 1,000 x 96,
    K = 10, inside a ``record_function`` range of its own in one
    torch.profiler session, launches its own kernel and no other: the
    chain wrapper the chain kernel (its coefficients' copy to the
    constant bank is a memcpy), the systolic wrapper the systolic kernel.
    The device events of each range are read from the session's Chrome
    trace, as ``--capture``'s are."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpuaudiobench_tpu_torch.harness.profiler import trace_events

    x, c, z = iir_inputs(torch, 1000, 96, device, stages=IIR_STAGES)
    wrappers = (
        ("iir_cascade_chain", iops.iir_cascade_chain, "iir_cascade_chain_kernel"),
        ("iir_cascade", iops.iir_cascade, "iir_cascade_systolic_kernel"))
    for _, fn, _ in wrappers:
        fn(x, c, z)
    torch.cuda.synchronize()
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_proof_")
    path = os.path.join(tmpdir, "proof.trace.json")
    try:
        # One-call sessions came back with no device event, and after a
        # --capture session most of a process's later ones did too
        # (PERF.md §7); a session of PROFILE_CALLS calls a wrapper is
        # taken again, up to PROFILE_SESSIONS times, only when a range
        # holds no kernel at all, and a range with kernels is judged as
        # it is.
        for session in range(PROFILE_SESSIONS):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for name, fn, _ in wrappers:
                    with record_function(name):
                        for _ in range(PROFILE_CALLS):
                            fn(x, c, z)
                        torch.cuda.synchronize()
            prof.export_chrome_trace(path)
            seen = {}
            for name, _, _ in wrappers:
                names = [e[0] for e in trace_events(path, name)]
                kernels = sorted({n for n in names if not n.startswith(
                    ("Memcpy", "Memset"))})
                seen[name] = (kernels, sorted(set(names) - set(kernels)))
            if all(k for k, _ in seen.values()):
                break
            print(f"profiler: session {session + 1} saw no kernel in "
                  + ", ".join(n for n, (k, _) in seen.items() if not k))
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    for name, _, want in wrappers:
        kernels = seen[name][0]
        if not kernels:
            fail(f"{name}: the profiler saw no kernel in {PROFILE_SESSIONS} "
                 "sessions")
        if not all(want in n for n in kernels):
            fail(f"{name} launched {kernels}, not {want} alone")
    print(f"profiler ({session + 1} session(s), {PROFILE_CALLS} calls a "
          "wrapper): " + "; ".join(
              f"{name} launched {[n[:72] for n in k]}"
              + (f", copies {c}" if c else "")
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
    # the field route's per-track calls bucket their receivers: 2
    for k in list(routes) + ["fdtd3d_receiver_buckets"]:
        want = 2 if "div" in k or "buckets" in k else 4
        if fops.KERNEL_LAUNCHES[k] - before[k] != want:
            fail(f"{k}: expected {want} launches")
    print(f"compare fdtd room {room} S={s}: ok  {', '.join(sorted(routes))} "
          f"bit for bit the twins (the field kernel with {tracks} per-track "
          f"receivers, one on the source cell, and broadcast), div vs field "
          f"{cross:.3g}")
    return {k: 0.0 for k in routes}


def off_grid_cells(torch, tracks, n, device, seed=5):
    """``tracks`` receiver cells drawn over [-2 n^3, 2 n^3)."""
    import numpy as np

    g = np.random.Generator(np.random.MT19937(seed))
    return torch.from_numpy(g.integers(-2 * n ** 3, 2 * n ** 3, tracks)
                            .astype(np.int32)).to(device)


def compare_fdtd_receivers(torch, fops, device):
    """Per-track receivers off the grid: the bucketing kernel vs its twin
    at FDTD_BUCKETS (the cells and the plane starts bit for bit, each
    plane's rows as a set: the kernel's order within a plane is its
    atomics'), and the field kernel reading FDTD_OFF_GRID's cells bit for
    bit its twin over 2 blocks. Returns the bucketing kernel's max |cells
    - twin's| (0)."""
    before = fops.KERNEL_LAUNCHES["fdtd3d_receiver_buckets"]
    for tracks, room in FDTD_BUCKETS:
        n = fops.grid_n(room)
        rcv = off_grid_cells(torch, tracks, n, device)
        cells, order, starts = fops.receiver_buckets(rcv, n)
        want = fops.receiver_buckets_plain(rcv, n)
        if not (torch.equal(cells, want[0]) and torch.equal(starts,
                                                            want[2])):
            fail(f"receiver buckets {tracks} tracks room {room}: cells or "
                 "plane starts differ from the twin's")
        cuts = want[2].tolist()
        got_o, want_o = order.tolist(), want[1].tolist()
        if any(sorted(got_o[cuts[b]:cuts[b + 1]])
               != sorted(want_o[cuts[b]:cuts[b + 1]]) for b in range(n)):
            fail(f"receiver buckets {tracks} tracks room {room}: a plane's "
                 "rows differ from the twin's")
    torch.cuda.synchronize()
    if (fops.KERNEL_LAUNCHES["fdtd3d_receiver_buckets"] - before
            != len(FDTD_BUCKETS)):
        fail("fdtd3d_receiver_buckets: expected one launch a case")
    for room, given in FDTD_OFF_GRID:
        n, src, rcv = fdtd_geometry(fops, room)
        cells = (off_grid_cells(torch, 128, n, device, seed=7)
                 if given is None else
                 torch.tensor(given, dtype=torch.int32, device=device))
        x = fdtd_x(torch, cells.numel(), 24, device)
        got, want = fops.zero_fields(n, device), fops.zero_fields(n, device)
        for blk in range(2):
            got = fops.fdtd3d_block_field(x, *got, src, rcv, receivers=cells)
            want = fops.fdtd3d_block_field_plain(x, *want, src, rcv,
                                                 receivers=cells)
            fdtd_same(torch, f"fdtd3d_field off-grid room {room} block "
                      f"{blk}", got, want)
            got, want = got[1:], want[1:]
    torch.cuda.synchronize()
    print(f"compare fdtd receivers off the grid: ok  the bucketing kernel's "
          f"cells and plane starts bit for bit its twin's, each plane's rows "
          f"the same set, at {FDTD_BUCKETS} (tracks, room); the field kernel "
          f"on them bit for bit its twin at rooms "
          f"{sorted({r for r, _ in FDTD_OFF_GRID})} over 2 blocks")
    return 0.0


BUCKET_CALLS = 10  # calls a timed rep of the bucketing kernel


def time_receiver_buckets(torch, fops, device):
    """Device times (ms a call) of the bucketing kernel and its twin at
    room 50 with FDTD_MAIN's tracks (the main path's line of receivers)
    and FDTD_BUCKETS_WIDE (cells off the grid): CUDA events around
    BUCKET_CALLS calls behind a ~1 ms spin (so they time the device, not
    the launches), median of 11 reps, in turns kernel, twin, kernel:
    {tracks: (ms, plain_ms)}."""
    from gpuaudiobench_tpu_torch.harness.device_timing import (
        event_device_times,
    )

    room, _, tracks = FDTD_MAIN
    n, src, _ = fdtd_geometry(fops, room)

    def per_call(fn):
        def body():
            for _ in range(BUCKET_CALLS):
                fn(cells, n)
        times = sorted(event_device_times(body, 11))
        return times[len(times) // 2] / BUCKET_CALLS

    out = {}
    for t in (tracks, FDTD_BUCKETS_WIDE):
        cells = (fdtd_receivers(torch, fops, n, src, t, device) if t == tracks
                 else off_grid_cells(torch, t, n, device))
        k1 = per_call(fops.receiver_buckets)
        p1 = per_call(fops.receiver_buckets_plain)
        k2 = per_call(fops.receiver_buckets)
        print(f"time fdtd3d_receiver_buckets room {room}, {t} tracks (CUDA "
              f"events behind a spin, {BUCKET_CALLS} calls, median of 11): "
              f"kernel {k1 * 1e3:.2f} / {k2 * 1e3:.2f} us, plain twin "
              f"{p1 * 1e3:.2f} us")
        out[t] = (min(k1, k2), p1)
    return out


def receiver_buckets_bound(tracks: int, room: int):
    """The bucketing kernel's least time: the receivers read once and the
    cells, the order (a row a track) and the n + 1 plane starts written
    once, all int32; its integer work (a wrap, a clamp and a divide a
    track, twice) is negligible beside it, counted at the FP32 rate."""
    n = room + 2
    return bound(4 * (3 * tracks + n + 1), 8 * tracks)


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
    room, _, tracks = FDTD_MAIN
    out["fdtd3d_receiver_buckets"] = receiver_buckets_bound(tracks, room)
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
             "fdtd": ("fdtd3d_block_div_plain", "fdtd3d_block_field_plain",
                      "receiver_buckets_plain"),
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
    """Every kernel's launches, by name: its wrapper's count (each ops
    module keeps them in a ``KERNEL_LAUNCHES`` dict) plus the launches of
    the chain graphs' replays (``harness.graph.REPLAYED_LAUNCHES``: each
    replay makes every launch its capture recorded)."""
    from gpuaudiobench_tpu_torch.harness.graph import REPLAYED_LAUNCHES

    return {k: n + REPLAYED_LAUNCHES.get(k, 0)
            for mod in modules for k, n in mod.KERNEL_LAUNCHES.items()}


def reset_counts(*modules):
    from gpuaudiobench_tpu_torch.harness.graph import (
        CHAIN_REPLAYS,
        REPLAYED_LAUNCHES,
    )

    for mod in modules:
        for k in mod.KERNEL_LAUNCHES:
            mod.KERNEL_LAUNCHES[k] = 0
    REPLAYED_LAUNCHES.clear()
    CHAIN_REPLAYS["chain"] = 0


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
    ``kernels`` launched. With a saturated tier, its ``metadata.chainForm``
    must be "cuda-graph" ("loop" for NeuralAmpLSTM), with one replay a
    depth a rep and its untimed run, and each of ``kernels`` replayed a
    whole number of times a chained block (none for ``CHAIN_ABSENT``). ``counts`` reads the launch
    counts, which the caller reset. Returns the launch counts of the run
    and its JSON."""
    from gpuaudiobench_tpu_torch.harness import graph as hgraph

    rec, wall = run(cli, label, argv)
    launches = counts()
    v = rec["validation"]
    dstats = rec.get("device_statistics", {})
    if dstats.get("method") != "cuda-events":
        fail(f"{label}: device timing method {dstats.get('method')!r}")
    for k in kernels:
        if launches[k] <= 0:
            fail(f"{label}: {k} was not launched")
    form = rec["metadata"].get("chainForm")
    chain = ""
    if "--pipelineDepth" in argv:
        want = "loop" if "NeuralAmpLSTM" in argv else "cuda-graph"
        if form != want:
            fail(f"{label}: chain form {form!r}, not {want!r}")
        blocks, replays = chain_expectation(argv)
        if form == "cuda-graph":
            got = hgraph.CHAIN_REPLAYS["chain"]
            if got != replays:
                fail(f"{label}: {got} chain replays, not {replays}")
            replayed = blocks * (replays // 2)
            for k in kernels:
                n = hgraph.REPLAYED_LAUNCHES.get(k, 0)
                if (n > 0) == (k in CHAIN_ABSENT) or n % replayed:
                    fail(f"{label}: {k} replayed {n} times in {replayed} "
                         "chained blocks")
        chain = f"chain {form} ({hgraph.CHAIN_REPLAYS['chain']} replays), "
    elif form is not None:
        fail(f"{label}: chain form {form!r} without a saturated tier")
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
          + f" ({rl['bound']}), {chain}launches "
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
                  hgraph, counts, reset, launches, device):
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

        # Session blocks, counted as the kernels are: a call inside a
        # chain's capture is recorded, and each replay makes it.
        blocks = {"session_block": 0}
        real_block = models_session.session_block

        def counted(*args, **kw):
            hgraph.count_launch(blocks, "session_block")
            return real_block(*args, **kw)

        for label, argv, run in (
                ("DAWSessionMix, 65536 strips", SESSION_WIDE + SESSION_CLI,
                 csv_run),
                ("DAWSessionMix K=16, 128 strips", SESSION_K16 + SESSION_CLI,
                 json_run)):
            reset()
            blocks["session_block"] = 0
            models_session.session_block = counted
            try:
                n, rec = cli_path(torch, cli, counts, label, argv,
                                  ["iir_cascade"], run=run)
            finally:
                models_session.session_block = real_block
            made = (blocks["session_block"]
                    + hgraph.REPLAYED_LAUNCHES.get("session_block", 0))
            if n["iir_cascade"] != made:
                fail(f"{label}: iir_cascade launched {n['iir_cascade']} "
                     f"times in {made} session blocks")
            for k, v in n.items():
                launches[k] += v
            print(f"{label}: iir_cascade launched once a block "
                  f"({made} blocks, graph replays included), validation max "
                  "error "
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
    """Phase 13: NeuralAmp in f32, bf16 and int8 at 128 tracks and int8 at
    C = 12, NeuralAmpLSTM in f32 and bf16 at 128, each validated against its
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

    launches = {k: 0 for k in ncounts()}  # none of the 15 may launch
    for label, argv in NEURAL_RUNS:
        lstm = "NeuralAmpLSTM" in argv
        nreset()
        n, rec = cli_path(torch, cli, ncounts, label, argv, [])
        md = rec["metadata"]
        if md.get("matmulPrecision") != "highest":
            fail(f"{label}: matmulPrecision {md.get('matmulPrecision')!r}")
        replays = n["lstm_block"]
        if "--neuralampChannels" in argv and md.get("channels") != int(
                argv[argv.index("--neuralampChannels") + 1]):
            fail(f"{label}: ran at {md.get('channels')} channels")
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


def chain_expectation(argv):
    """(chains, replays) of one CLI run's saturated tier: two depths (the
    marginal's depth // 4 and the depth), each built and run once untimed
    and then once a rep (``harness/streaming.measure_saturated_multi``)."""
    flag = {argv[i]: int(argv[i + 1]) for i in range(len(argv) - 1)
            if argv[i] in ("--pipelineDepth", "--saturatedReps")}
    depth = flag.get("--pipelineDepth", 0)
    reps = flag.get("--saturatedReps", 21)
    return depth + max(1, depth // 4), 2 * (1 + reps)


def graph_phase(torch, registry, config, hgraph, streaming, device):
    """Phase 14: on each of GRAPH_PATHS, the chain captured as one CUDA
    graph against the loop from the same entry carry (probes bit for bit,
    two replays bit for bit), with the capture's seconds, nodes and peak
    memory, and both forms' saturated and marginal p50 in turns."""
    import statistics

    for label, name, knobs, depth in GRAPH_PATHS:
        t0 = time.perf_counter()
        cfg = config.BenchConfig(verification="none", device_timing=False,
                                 **knobs)
        b = registry.create_benchmark(name, cfg, device)
        b.setup()
        if not b.stream_capturable:
            fail(f"graph {label}: the body is declared uncapturable")
        step, carry = b.stream_body()
        loop = streaming.run_chained(step, hgraph.clone_carry(carry), depth)
        lo = max(1, depth // 4)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pool = torch.cuda.graph_pool_handle()
        g_hi = hgraph.ChainGraph(step, carry, depth, pool, label)
        g_lo = hgraph.ChainGraph(step, carry, lo, pool, label)
        peak = torch.cuda.max_memory_allocated()
        replays0 = hgraph.CHAIN_REPLAYS["chain"]
        p1, p2 = g_hi.run(), g_hi.run()
        if not torch.equal(p1, p2):
            fail(f"graph {label}: two replays differ by "
                 f"{float((p1 - p2).abs().max()):.3g}")
        if torch.equal(p1, loop):
            agree = "bit for bit the loop's"
        else:
            rel = float((p1 - loop).abs().max() / loop.abs().max())
            if name not in GRAPH_LIBRARY_BODIES or not rel <= b.tolerance:
                fail(f"graph {label}: the replay's probes differ from the "
                     f"loop's by {rel:.3g} of its peak")
            agree = (f"within {rel:.3g} of the loop's peak probe (tolerance "
                     f"{b.tolerance:g}; cuBLAS / cuFFT)")
        runs = {"cuda-graph": {lo: g_lo.run, depth: g_hi.run}}
        loop_carry = hgraph.clone_carry(carry)
        runs["loop"] = {d: (lambda d=d: streaming.run_chained(
            step, loop_carry, d)) for d in (lo, depth)}
        walls = {f: {lo: [], depth: []} for f in runs}
        order = ["loop", "cuda-graph"]
        for r in range(GRAPH_REPS):
            for form in (order if r % 2 == 0 else order[::-1]):
                for d in (lo, depth):
                    t1 = time.perf_counter()
                    runs[form][d]()
                    walls[form][d].append((time.perf_counter() - t1) * 1e3)
        sat, marg = {}, {}
        for form, w in walls.items():
            sat[form] = statistics.median(h / depth for h in w[depth])
            marg[form] = statistics.median(
                (h - l) / (depth - lo) for l, h in zip(w[lo], w[depth]))
        replays = hgraph.CHAIN_REPLAYS["chain"] - replays0
        print(f"graph {label}: depth {depth} (marginal from {lo}), probes "
              f"{agree}, two replays bit for bit; capture "
              f"{g_hi.capture_s:.2f} + {g_lo.capture_s:.2f} s, instantiation "
              f"{g_hi.instantiate_s:.3f} + {g_lo.instantiate_s:.3f} s, "
              f"{g_hi.nodes} + {g_lo.nodes} nodes ("
              f"{sum(g_hi.captured.values())} kernel-wrapper launches "
              f"captured at depth {depth}: {dict(g_hi.captured)}), max "
              f"memory allocated {peak / 2**30:.2f} GiB; saturated p50 graph "
              f"{sat['cuda-graph']:.4f} / loop {sat['loop']:.4f} ms, marginal "
              f"p50 graph {marg['cuda-graph']:.4f} / loop "
              f"{marg['loop']:.4f} ms ({GRAPH_REPS} reps in turns); "
              f"{replays} replays; {time.perf_counter() - t0:.1f} s")
        del b, step, carry, g_hi, g_lo, runs, loop_carry
        torch.cuda.empty_cache()


def lstm_nested_capture(torch, registry, config, hgraph, streaming, device):
    """Whether a chain of NeuralAmpLSTM blocks, each one replay of the
    block's own graph, can be captured as one graph: the body is declared
    a loop either way; this prints what the capture does."""
    cfg = config.BenchConfig(verification="none", device_timing=False)
    b = registry.create_benchmark("NeuralAmpLSTM", cfg, device)
    b.setup()
    step, carry = b.stream_body()
    loop = streaming.run_chained(step, hgraph.clone_carry(carry), 2)
    try:
        g = hgraph.ChainGraph(step, carry, 2, name="NeuralAmpLSTM")
    except RuntimeError as e:
        torch.cuda.synchronize()
        print("graph NeuralAmpLSTM: 2 blocks, each a replay of the block's "
              "graph, cannot be captured as one graph: "
              + " | ".join(str(e).splitlines())[:300])
        return
    got = g.run()
    print(f"graph NeuralAmpLSTM: 2 blocks, each a replay of the block's "
          f"graph, captured as one graph ({g.nodes} nodes); probes "
          f"{'bit for bit' if torch.equal(got, loop) else 'NOT equal to'} "
          "the loop's")


def run_quiet(fn, argv, label):
    """``fn(argv)`` with its output captured, then printed under
    ``label``; fails unless it returns 0. Returns the output lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print(f"{label}: {ln}")
    if rc != 0:
        fail(f"{label}: returned {rc}")
    return lines


def report_row(text, metric):
    """The value cell of a markdown report's ``| metric | value |`` row."""
    for ln in text.splitlines():
        cells = [c.strip() for c in ln.strip().strip("|").split("|")]
        if len(cells) == 2 and cells[0] == metric:
            return cells[1]
    fail(f"the report has no row {metric!r}")


def soak_phase(soak, counts, reset, launches, tmpdir, smi):
    """The soaks of SOAKS through the soak tool's ``main``, each report
    printed; each must run its form, its kernels and, but for DWG, a live
    probe."""
    import math

    for label, args, seconds, kernels, form in SOAKS:
        t0 = time.perf_counter()
        md = os.path.join(tmpdir, "soak.md")
        reset()
        run_quiet(soak.main, [str(seconds), md] + args, f"soak {label}")
        n = counts()
        text = open(md).read()
        for ln in text.splitlines():
            if ln.startswith("|") or ln.startswith("#"):
                print(f"soak {label} report: {ln}")
        got = report_row(text, "chain form")
        if got != form:
            fail(f"soak {label}: chain form {got!r}, not {form!r}")
        first, last = (float(v) for v in report_row(
            text, "state RMS first / last (carry integrity)").split(" / "))
        probe_last = float(report_row(
            text, "probe RMS first / last (output liveness)").split(" / ")[1])
        if not (math.isfinite(first) and math.isfinite(last) and last > 0):
            fail(f"soak {label}: state RMS {first} / {last}")
        if not args[0].startswith("DWG") and not probe_last > 0:
            fail(f"soak {label}: probe RMS {probe_last}")
        for k in kernels:
            if n[k] < seconds * 94:
                fail(f"soak {label}: {k} launched {n[k]} times for "
                     f"{seconds * 94} blocks")
        for k, v in n.items():
            launches[k] += v
        print(f"soak {label}: {seconds} s of audio, form {got}, "
              f"launches {({k: n[k] for k in kernels})}, "
              f"{time.perf_counter() - t0:.1f} s [{smi}]")


def continuity_phase(torch, soak, registry, config, hgraph, counts, reset,
                     launches, device):
    """Each CONTINUITY body: 3 seconds of the soak's form
    (``soak.Seconds``) against 282 eager steps from a clone of the entry
    carry, carry (tensors and Python values) and probes bit for bit."""
    import numpy as np

    for label, name, knobs, form in CONTINUITY:
        t0 = time.perf_counter()
        cfg = config.BenchConfig(verification="none", device_timing=False,
                                 **knobs)
        b = registry.create_benchmark(name, cfg, device)
        b.setup()
        step, carry = b.stream_body()
        blocks = -(-cfg.fs // cfg.buffer_size)
        entry = hgraph.clone_carry(carry)
        reset()
        sec = soak.Seconds(step, carry, blocks, device, b.stream_capturable,
                           name)
        if sec.form != form:
            fail(f"continuity {label}: form {sec.form!r}, not {form!r}")
        probes = np.concatenate([sec.run()
                                 for _ in range(CONTINUITY_SECONDS)])
        for k, v in counts().items():
            launches[k] += v
        c, eager = entry, []
        for _ in range(CONTINUITY_SECONDS * blocks):
            c, p = step(c)
            eager.append(p)
        eager = torch.cat(eager).cpu().numpy()
        got = hgraph.leaves(sec.carry())
        want = hgraph.leaves(c)
        same = len(got) == len(want) and all(
            torch.equal(a, w) if isinstance(a, torch.Tensor) else a == w
            for a, w in zip(got, want))
        if not same:
            fail(f"continuity {label}: the carry after {CONTINUITY_SECONDS} "
                 f"seconds ({sec.form}) differs from the eager loop's")
        if not np.array_equal(probes, eager):
            fail(f"continuity {label}: probes differ from the eager loop's "
                 f"by {np.abs(probes - eager).max():.3g}")
        print(f"continuity {label}: {CONTINUITY_SECONDS} seconds as "
              f"{sec.form} ({'Python values advance' if sec.advancing else 'no Python value advances'} "
              f"over a second) against {CONTINUITY_SECONDS * blocks} eager "
              f"steps from a clone: carry ({len(got)} leaves) and probes bit "
              f"for bit; {time.perf_counter() - t0:.1f} s")
        del b, step, carry, entry, sec, c
        torch.cuda.empty_cache()


def resume_phase(soak, checkpoint, tmpdir, smi):
    """3 s of the modal soak straight against 1 s, a checkpoint and 2 s
    resumed in a fresh process: the checkpoints' leaves bit for bit."""
    import numpy as np

    t0 = time.perf_counter()
    straight, split = (os.path.join(tmpdir, f"{n}.npz")
                       for n in ("straight", "split"))
    md = os.path.join(tmpdir, "resume.md")
    run_quiet(soak.main, ["3", md] + RESUME_SOAK
              + ["--checkpoint", straight], "resume 3 s")
    run_quiet(soak.main, ["1", md] + RESUME_SOAK + ["--checkpoint", split],
              "resume 1 s")
    proc = subprocess.run(
        [sys.executable, "-m", "gpuaudiobench_tpu_torch.tools.soak", "2", md]
        + RESUME_SOAK + ["--checkpoint", split, "--resume"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    for ln in (proc.stdout + proc.stderr).splitlines()[-12:]:
        print(f"resume 2 s (fresh process): {ln}")
    if proc.returncode != 0:
        fail(f"resume: the resumed soak exited {proc.returncode}")
    ha, hb = (checkpoint.read_header(p) for p in (straight, split))
    with np.load(straight) as za, np.load(split) as zb:
        keys = [k for k in za.files if k.startswith("leaf_")]
        if keys != [k for k in zb.files if k.startswith("leaf_")]:
            fail("resume: the checkpoints hold different leaves")
        diff = [k for k in keys if not np.array_equal(za[k], zb[k])]
    if diff:
        fail(f"resume: leaves {diff} differ between 3 s straight and 1 s + "
             "a resumed 2 s")
    print(f"resume: modal headline, 3 s straight against 1 s, a checkpoint "
          f"and 2 s resumed in a fresh process: {len(keys)} leaves bit for "
          f"bit ({ha['extra']['soak_seconds']} and "
          f"{hb['extra']['soak_seconds']} soak s); "
          f"{time.perf_counter() - t0:.1f} s [{smi}]")


def capacity_phase(capacity, ledger, merge, counts, reset, launches,
                   tmpdir, smi):
    """The capacity search of FDTD3D's field form, printed beside
    ``tools/fdtd_stages``' deadline room, its confirmation in a fresh
    process, the ledger and the rendered table with its flag column."""
    t0 = time.perf_counter()
    search_json, confirm_json, ledger_json, md = (
        os.path.join(tmpdir, n) for n in
        ("search.json", "confirm.json", "ledger.json", "capacity.md"))
    reset()
    run_quiet(capacity.main, CAPACITY_ARGS + CAPACITY_SEARCH
              + ["--json", search_json], "capacity")
    n = counts()
    if n["fdtd3d_field"] <= 0:
        fail("capacity: fdtd3d_field was not launched")
    for k, v in n.items():
        launches[k] += v
    rec = json.load(open(search_json))
    cap = rec["capacity"]
    if cap is None or rec.get("stopped"):
        fail(f"capacity: no capacity ({rec.get('stopped')})")
    # Only a probe that ran and missed may bound the search: a probe or
    # a confirmation that raised fails the phase.
    errors = [d for d in rec["probes"] + [rec["confirmation"] or {}]
              if "error" in d]
    if errors or rec["wall_class"] != "deadline":
        fail(f"capacity: wall {rec['wall_class']!r}, failed probes "
             f"{[(d['value'], d['error']) for d in errors]}")
    print(f"capacity FDTD3D field form (per-track receivers): room {cap} "
          f"at the 10.667 ms deadline by the saturated p99 "
          f"({len(rec['probes'])} probes, wall {rec['wall_class']}); "
          f"tools/fdtd_stages, the kernel behind a spin: "
          f"{FDTD_FIELD_DEADLINE_ROOM}; {time.perf_counter() - t0:.1f} s "
          f"[{smi}]")
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gpuaudiobench_tpu_torch.tools.capacity"]
        + CAPACITY_ARGS + ["--confirmOnly", str(cap), "--json",
                           confirm_json],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    for ln in (proc.stdout + proc.stderr).splitlines()[-8:]:
        print(f"capacity confirm (fresh process): {ln}")
    if proc.returncode not in (0, 1) or not os.path.exists(confirm_json):
        fail(f"capacity confirm exited {proc.returncode}")
    conf = json.load(open(confirm_json))
    # Exit 1 passes only as a clean deadline miss.
    if conf.get("stopped") or any("error" in c for c in conf["confirms"]):
        fail(f"capacity confirm failed: {conf.get('stopped')} "
             f"{[c.get('error') for c in conf['confirms']]}")
    run_quiet(ledger.main, [ledger_json, search_json, confirm_json],
              "capacity ledger")
    run_quiet(merge.main, [md, ledger_json], "capacity merge")
    text = open(md).read()
    if "| flag |" not in text:
        fail("capacity: the table has no flag column")
    for ln in text.splitlines():
        print(f"capacity table: {ln}")
    row = json.load(open(ledger_json))
    print(f"capacity confirm: room {cap} "
          f"{'sustains' if proc.returncode == 0 else 'MISSES'} in a fresh "
          f"process; device p50 > sat p50: {row['device_over_saturated']}; "
          f"{time.perf_counter() - t1:.1f} s [{smi}]")


def overlap64_phase(overlap64, counts, reset, launches, tmpdir, smi):
    """The buffer-64 attribution on gain and IIRFilter, its table printed;
    the best tier of each row a measured one."""
    t0 = time.perf_counter()
    out = os.path.join(tmpdir, "overlap64")
    reset()
    run_quiet(overlap64.main, [out] + OVERLAP64_ARGS, "overlap64")
    n = counts()
    if n["iir_biquad"] <= 0:
        fail("overlap64: iir_biquad was not launched")
    for k, v in n.items():
        launches[k] += v
    rows = json.load(open(out + ".json"))["rows"]
    for r in rows:
        if r.get("best_tier") not in overlap64.MEASURED_TIERS:
            fail(f"overlap64 {r['benchmark']}: best tier "
                 f"{r.get('best_tier')!r}")
        unmeasured = [k for k in overlap64.COMPONENTS if r.get(k) is None]
        errors = {k: v for k, v in r.items() if k.endswith("_error")}
        if unmeasured or errors:
            fail(f"overlap64 {r['benchmark']}: unmeasured {unmeasured}, "
                 f"errors {errors}")
    for ln in open(out + ".md").read().splitlines():
        if ln.startswith("|") or ln.startswith("#"):
            print(f"overlap64 table: {ln}")
    print(f"overlap64: {time.perf_counter() - t0:.1f} s [{smi}]")


def webui_phase(torch, webui_server, output, tmpdir, smi):
    """The web UI on a free port: the catalog, one gain job at 65,536
    tracks run to done with its phases, the hardware panel naming the
    card, and /api/export.csv equal to csv_from_json_results of
    /api/export.json."""
    import threading
    import urllib.request

    t0 = time.perf_counter()
    httpd = webui_server.serve(
        port=0, presets_path=os.path.join(tmpdir, "presets.json"),
        device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.read()

    try:
        cat = json.loads(get("/api/benchmarks"))
        names = [b["name"] for b in cat["benchmarks"]]
        if (not {"gain", "MultiChipSuite", "ICIBandwidth"} <= set(names)
                or "multichip" not in cat["categories"]):
            fail(f"webui: catalog {names}, categories "
                 f"{sorted(cat['categories'])}")
        req = urllib.request.Request(
            base + "/api/run", method="POST",
            data=json.dumps({"benchmarks": ["gain"],
                             "params": UI_JOB}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            job_id = json.loads(r.read())["job_id"]
        deadline = time.time() + 300
        while True:
            job = json.loads(get(f"/api/job?id={job_id}"))
            if job["status"] in ("done", "error") or time.time() > deadline:
                break
            time.sleep(0.5)
        if job["status"] != "done" or job["errors"]:
            fail(f"webui: job {job['status']} {job['errors']}")
        (res,) = job["results"]
        if res["validation"]["status"] != "SUCCESS":
            fail(f"webui: validation {res['validation']}")
        dev_stats = res.get("device_statistics") or {}
        if dev_stats.get("method") != "cuda-events":
            fail(f"webui: device tier {dev_stats}")
        hw = json.loads(get("/api/hardware"))
        if hw.get("device_kind") != torch.cuda.get_device_name(0):
            fail(f"webui: hardware {hw}")
        exported = json.loads(get("/api/export.json"))["results"]
        csv = get("/api/export.csv").decode()
        if csv != output.csv_from_json_results(exported):
            fail("webui: /api/export.csv differs from csv_from_json_results "
                 "of /api/export.json")
        print(f"webui: {len(names)} benchmarks offered; gain at "
              f"{UI_JOB['nTracks']} tracks done, phases {job['phases']}, "
              f"p50 {res['statistics']['p50_ms']:.4f} ms, device p50 "
              f"{dev_stats['median_ms']:.4f} ms; hardware "
              f"{hw['device_kind']}, capability {hw.get('compute_capability')}, "
              f"power limit {hw.get('power_limit')}; /api/export.csv equals "
              f"csv_from_json_results of /api/export.json "
              f"({len(csv.splitlines())} lines); "
              f"{time.perf_counter() - t0:.1f} s [{smi}]")
    finally:
        httpd.shutdown()
        httpd.job_runner.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def surfaces_phase(torch, tools, checkpoint, webui_server, output, registry,
                   config, hgraph, counts, reset, launches, device, smi):
    """Phase 15: the soaks, continuity, checkpoint/resume, the capacity
    search and ledger, overlap64 and the web UI."""
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_surfaces_")
    try:
        soak_phase(tools.soak, counts, reset, launches, tmpdir, smi)
        continuity_phase(torch, tools.soak, registry, config, hgraph,
                         counts, reset, launches, device)
        resume_phase(tools.soak, checkpoint, tmpdir, smi)
        capacity_phase(tools.capacity, tools.build_capacity_ledger,
                       tools.merge_capacity, counts, reset, launches,
                       tmpdir, smi)
        overlap64_phase(tools.overlap64_attrib, counts, reset, launches,
                        tmpdir, smi)
        webui_phase(torch, webui_server, output, tmpdir, smi)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def multichip_launches(argv):
    """The steps of one MultiChipSuite CLI run: (eager, replayed). One in
    the set-up, the warm-up and timed runs, the device tier's warm run
    and its min(runs, 20) timed runs, and each chain graph's two eager
    warm-up chains; the replays of the saturated tier's chains."""
    flag = {argv[i]: int(argv[i + 1]) for i in range(len(argv) - 1)
            if argv[i] in ("--nRuns", "--warmup")}
    runs, warm = flag["--nRuns"], flag["--warmup"]
    blocks, replays = chain_expectation(argv)
    eager = 1 + warm + runs + 1 + min(runs, 20) + 2 * blocks
    return eager, blocks * (replays // 2)


def nccl_one_rank(torch):
    """NCCL's version, then an all_reduce and an all_gather on cuda:0 in a
    one-rank NCCL group, each equal to its input."""
    import datetime

    import torch.distributed as dist

    print(f"nccl {'.'.join(map(str, torch.cuda.nccl.version()))}")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, device_id=torch.device("cuda", 0),
            timeout=datetime.timedelta(seconds=120))
        try:
            x = torch.randn(1 << 20, device="cuda:0")
            summed = x.clone()
            dist.all_reduce(summed)
            parts = [torch.empty_like(x)]
            dist.all_gather(parts, x)
            torch.cuda.synchronize()
            if not (torch.equal(summed, x) and torch.equal(parts[0], x)):
                fail("one-rank NCCL: all_reduce or all_gather changed its "
                     "input")
        finally:
            dist.destroy_process_group()
    print("nccl one-rank group on cuda:0: all_reduce and all_gather of 4 MiB "
          "equal their input")


def sharded_blocks_phase(torch, fops, na, pc, ranks, device):
    """The four sharded blocks of ``parallel/`` on one rank on the card
    (every collective the identity) against the single-device paths on
    the card: the FDTD field kernel, ``partconv_block``, ``tcn_block`` and
    the LSTM's graph block."""
    import numpy as np

    g = np.random.default_rng(5)
    cuda = device

    def worst(pairs, kind):
        tol = SHARDED_TOL[kind]
        err = 0.0
        for o, r in pairs:
            peak = 1.0 if kind == "fdtd" else float(np.abs(r).max())
            err = max(err, float(np.abs(o - r).max()) / peak)
        if not err <= tol:
            fail(f"sharded {kind} on one rank: {err:.3g} > {tol:g}")
        return err

    t0 = time.perf_counter()
    tracks, s = SHARDED_FDTD
    x = g.uniform(-1, 1, (tracks, s)).astype(np.float32)
    ours = ranks.fdtd_blocks(x, device=cuda.type)
    want, *_ = fops.fdtd3d_block_field(torch.from_numpy(x).to(cuda),
                                       *fops.zero_fields(device=cuda))
    err = worst([(ours, want.cpu().numpy())], "fdtd")
    print(f"sharded FDTD on one rank, grid {fops.GRID_N}, {tracks} x {s}: "
          f"{err:.3g} absolute from the field kernel, "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    tracks, taps, b, blocks = SHARDED_PARTCONV
    ir = (g.standard_normal((tracks, taps)) * 0.01).astype(np.float32)
    xs = [g.standard_normal((tracks, b)).astype(np.float32)
          for _ in range(blocks)]
    ours = ranks.partconv_blocks(ir, xs, device=cuda.type)
    h_re, h_im = pc.partition_spectra(torch.from_numpy(ir).to(cuda), b)
    f_re = f_im = torch.zeros_like(h_re)
    prev, refs = torch.zeros((tracks, b), device=cuda), []
    for xb in xs:
        xb = torch.from_numpy(xb).to(cuda)
        y, f_re, f_im = pc.partconv_block(xb, prev, f_re, f_im, h_re, h_im)
        prev = xb
        refs.append(y.cpu().numpy())
    del h_re, h_im, f_re, f_im
    err = worst(zip(ours, refs), "partconv")
    print(f"sharded PartConv shift on one rank, {tracks} x {taps} taps, "
          f"{blocks} blocks: {err:.3g} of the peak from partconv_block, "
          f"{time.perf_counter() - t0:.1f} s")

    tracks, s, width, layers = SHARDED_NEURAL
    xs = [g.uniform(-1, 1, (tracks, s)).astype(np.float32) for _ in range(2)]
    t0 = time.perf_counter()
    params = na.init_params(42, width, layers)
    ours, _ = ranks.tcn_blocks(params, layers, xs, device=cuda.type)
    cp = na.cast_params(params, "f32", cuda)
    tails, refs = na.init_tails(tracks, width, layers, device=cuda), []
    for xb in xs:
        y, tails = na.tcn_block(torch.from_numpy(xb).to(cuda), tails, cp,
                                layers)
        refs.append(y.cpu().numpy())
    err = worst(zip(ours, refs), "tcn")
    print(f"sharded TCN on one rank, C = {width}, L = {layers}, {tracks} "
          f"tracks, 2 blocks: {err:.3g} of the peak from tcn_block, "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    params = na.init_lstm_params(42, width)
    ours, _, _ = ranks.lstm_blocks(params, xs, device=cuda.type)
    cp = na.cast_lstm_params(params, "f32", cuda)
    h = c = torch.zeros((tracks, width), device=cuda)
    run = na.lstm_runner(cp, "f32", torch.from_numpy(xs[0]).to(cuda), h, c)
    refs = []
    for xb in xs:
        y, h, c = (t.clone() for t in run(torch.from_numpy(xb).to(cuda), h,
                                          c))
        refs.append(y.cpu().numpy())
    err = worst(zip(ours, refs), "lstm")
    print(f"sharded LSTM on one rank, H = {width}, {tracks} tracks, 2 "
          f"blocks: {err:.3g} of the peak from the LSTM's graph block, "
          f"{time.perf_counter() - t0:.1f} s")


def multichip_phase(torch, cli, registry, config, counts, reset, launches,
                    smi, fops, na, pc, ranks, device):
    """Phase 16: NCCL on one rank, MultiChipSuite and ICIBandwidth through
    the CLI at --mesh 1,1,1, the refusal of a mesh larger than the cards
    (or, with two cards or more, meshes of two ranks over NCCL), and the
    sharded blocks on one rank against the single-device paths."""
    import numpy as np

    nccl_one_rank(torch)
    for label, extra in MULTICHIP_RUNS:
        argv = MULTICHIP_CLI + extra
        reset()
        n, rec = cli_path(torch, cli, counts, label, argv,
                          list(MULTICHIP_STEP_LAUNCHES))
        md = rec["metadata"]
        if md.get("chainForm") != "cuda-graph" or md.get(
                "collectiveInventory") != []:
            fail(f"{label}: chain form {md.get('chainForm')!r}, inventory "
                 f"{md.get('collectiveInventory')!r}")
        eager, replayed = multichip_launches(argv)
        for k, per_step in MULTICHIP_STEP_LAUNCHES.items():
            if n[k] != per_step * (eager + replayed):
                fail(f"{label}: {k} launched {n[k]} times, not "
                     f"{per_step} x ({eager} eager + {replayed} replayed "
                     "steps)")
            launches[k] += n[k]
        if any(v for k, v in n.items() if k not in MULTICHIP_STEP_LAUNCHES):
            fail(f"{label}: launched {n}")
        print(f"{label}: {md['tracks']} tracks x {md['samples']}, "
              f"{md['modes']} modes, max error "
              f"{rec['validation']['max_error']:.3g} of the golden's peak "
              f"(1e-4), round trip p50 {rec['statistics']['p50_ms']:.4f} / "
              f"p99 {rec['statistics']['p99_ms']:.4f} ms, device p50 "
              f"{rec['device_statistics']['median_ms']:.4f} ms, saturated "
              f"p50 {rec['saturated']['p50_ms']:.4f} ms on {smi}")
    for mib in ICI_MIB:
        label = f"ICIBandwidth 1,1,1 {mib} MiB"
        reset()
        rec, wall = cli_json(cli, label, ICI_CLI + ["--transferMiB",
                                                    str(mib)])
        if any(counts().values()):
            fail(f"{label}: launched {counts()}")
        b = registry.create_benchmark("ICIBandwidth", config.BenchConfig(
            transfer_mib=mib, n_runs=1, warmup=0), device)
        b.setup()
        if not np.array_equal(b.host_output, np.roll(b.host_input, 1, 0)):
            fail(f"{label}: the ring is not the input rolled by one rank")
        del b
        print(f"{label}: {wall:.1f} s, the ring on one rank is a device "
              f"copy of the chunk (no collective), bit for bit; round trip p50 "
              f"{rec['statistics']['p50_ms']:.4f} / p99 "
              f"{rec['statistics']['p99_ms']:.4f} ms, device p50 "
              f"{rec['device_statistics']['median_ms']:.4f} ms (copy + "
              f"sum) on {smi}")
    cards = torch.cuda.device_count()
    if cards < 2:
        rc, lines = quiet_main(cli, MULTICHIP_CLI + ["--mesh", "2,1,1"])
        want = f"needs 2 devices; {cards} available"
        if rc != 1 or not any(want in ln for ln in lines):
            fail(f"--mesh 2,1,1 on {cards} card: exit {rc}, "
                 f"{lines[-3:]}")
        print(f"--mesh 2,1,1 on {cards} card exits 1: "
              f"{next(ln for ln in lines if want in ln)}")
        print("multi-rank meshes: not run, 1 card")
    else:
        for mesh in MULTI_RANK_MESHES:
            rec, wall = cli_json(cli, f"MultiChipSuite --mesh {mesh}",
                                 MULTICHIP_CLI + ["--mesh", mesh])
            print(f"MultiChipSuite --mesh {mesh} over NCCL on {cards} cards: "
                  f"{wall:.1f} s, max error "
                  f"{rec['validation']['max_error']:.3g}, collectives a step "
                  f"{len(rec['metadata']['collectiveInventory'])}")
    sharded_blocks_phase(torch, fops, na, pc, ranks, device)


@contextlib.contextmanager
def kept_benchmarks(cli):
    """Keeps every benchmark the CLI creates, in order (``cli`` looks
    ``create_benchmark`` up by name)."""
    made = []
    real = cli.create_benchmark

    def keep(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]

    cli.create_benchmark = keep
    try:
        yield made
    finally:
        cli.create_benchmark = real


def host_arrays(bench):
    import numpy as np

    return {k: v for k, v in vars(bench).items()
            if k.startswith("host_") and isinstance(v, np.ndarray)}


def dp_twin_runs(torch, cli, counts, reset, launches, label, argv):
    """``argv`` through the CLI without and with ``--dataParallel 1``:
    both validate, and the second's host arrays, chain form and launch
    counts are the first's. Adds the launches; returns the two runs'
    walls and the first's JSON."""
    import numpy as np

    runs = []
    for extra in ([], ["--dataParallel", "1"]):
        reset()
        with kept_benchmarks(cli) as made:
            rec, wall = cli_json(cli, f"{label} {' '.join(extra)}",
                                 argv + extra)
        n = counts()
        for k, v in n.items():
            launches[k] += v
        runs.append((rec, wall, n, host_arrays(made[0])))
        del made
    (rec0, w0, n0, h0), (rec1, w1, n1, h1) = runs
    form0 = rec0["metadata"].get("chainForm")
    form1 = rec1["metadata"].get("chainForm")
    if form0 != form1:
        fail(f"{label}: chain form {form1!r} under --dataParallel 1, "
             f"{form0!r} without")
    if n0 != n1:
        fail(f"{label}: launches {n1} under --dataParallel 1, {n0} without")
    if sorted(h0) != sorted(h1) or not all(
            np.array_equal(h0[k], h1[k]) for k in h0):
        bad = [k for k in h0 if k not in h1 or not np.array_equal(h0[k],
                                                                  h1[k])]
        fail(f"{label}: --dataParallel 1 changed {bad}")
    if "collectiveInventory" in rec1["metadata"]:
        fail(f"{label}: a one-rank run lists collectives")
    return w0, w1, rec0, n0


def dp_int8_ranks():
    """The int8 NeuralAmp run (``DP_INT8``) on DP_INT8_RANKS gloo ranks on
    the CPU: rank 0's ``ranks.dp_runs`` result. ``main`` starts it beside
    the build, whose nvcc processes leave the host cores to spare, and
    ``dp_int8_phase`` reads it."""
    from gpuaudiobench_tpu_torch.parallel import ranks
    from gpuaudiobench_tpu_torch.parallel.launch import spmd

    t0 = time.perf_counter()
    [many] = spmd(ranks.dp_runs, DP_INT8_RANKS, "cpu",
                  [("NeuralAmp", dict(DP_INT8))], "cpu", timeout_s=300)
    return many, time.perf_counter() - t0


def dp_int8_phase(smi, job):
    """int8 NeuralAmp (``DP_INT8``) on DP_INT8_RANKS gloo ranks on the CPU
    (``job``: the future of ``dp_int8_ranks``) against its one-rank run in
    this process: both validate, the host arrays are bit for bit the same
    (each layer's activation scale is the whole batch's), and a round trip
    issues one pmax of a float a layer."""
    import numpy as np

    from gpuaudiobench_tpu_torch.parallel import ranks

    t0 = time.perf_counter()
    [one] = ranks.dp_runs([("NeuralAmp", dict(DP_INT8))], device="cpu")
    try:
        many, ranks_s = job.result()
    except Exception as e:  # the ranks' traceback, as spmd raised it
        fail(f"dp int8 on {DP_INT8_RANKS} gloo ranks: {e}")
    for run in (one, many):
        if isinstance(run, str) or run[0]["validation"]["status"] != "SUCCESS":
            fail(f"dp int8: {run if isinstance(run, str) else run[0]['validation']}")
    h1, hn = one[1], many[1]
    if sorted(h1) != sorted(hn) or not all(np.array_equal(h1[k], hn[k])
                                           for k in h1):
        fail(f"dp int8: {DP_INT8_RANKS} ranks differ from one rank")
    inv = [(c["kind"], c["axis_n"], c["bytes"])
           for c in many[0]["metadata"]["collectiveInventory"]]
    if inv != [("pmax", DP_INT8_RANKS, 4)] * DP_INT8["neuralamp_layers"]:
        fail(f"dp int8: collectives a round trip {inv}")
    print(f"dp int8 NeuralAmp C={DP_INT8['neuralamp_channels']} "
          f"L={DP_INT8['neuralamp_layers']}, {DP_INT8['n_tracks']} tracks on "
          f"{DP_INT8_RANKS} gloo ranks (CPU): bit for bit the one-rank run, "
          f"max error {many[0]['validation']['max_error']:.6g}, "
          f"{len(inv)} pmax of 4 B a round trip; the ranks {ranks_s:.1f} s "
          f"(beside the build), the one-rank run "
          f"{time.perf_counter() - t0:.1f} s, beside {smi}")


def data_parallel_phase(torch, cli, counts, reset, launches, smi, dp_job):
    """Phase 17: every sharded name with and without --dataParallel 1 on
    one card, the modal headline the same way, int8 NeuralAmp on gloo
    ranks against one rank (``dp_int8_phase``, the ranks' ``dp_job``),
    and --dataParallel 2 refused on one card (run over NCCL with two
    cards or more)."""
    total = [0.0, 0.0]
    for name in DP_NAMES:
        w0, w1, rec, n = dp_twin_runs(torch, cli, counts, reset, launches,
                                      name, ["--benchmark", name] + DP_CLI
                                      + DP_NARROW.get(name, []))
        total[0] += w0
        total[1] += w1
        form = rec["metadata"].get("chainForm")
        print(f"dp1 {name}: bit for bit with and without --dataParallel 1, "
              f"chain {form}, launches "
              + (", ".join(f"{k} {v}" for k, v in n.items() if v) or "none")
              + f", round trip p50 {rec['statistics']['p50_ms']:.4f} ms, "
              f"{w0:.1f} / {w1:.1f} s")
    print(f"dp1 21 names: {total[0]:.1f} s without the flag, {total[1]:.1f} "
          f"s with it, on {smi}")
    w0, w1, rec, n = dp_twin_runs(torch, cli, counts, reset, launches,
                                  "ModalFilterBank 1M modes", DP_HEADLINE)
    if n["modal_bank"] <= 0:
        fail("dp1 headline: modal_bank was not launched")
    print(f"dp1 ModalFilterBank 1,048,576 modes onto 32 tracks: bit for bit "
          f"with and without --dataParallel 1, modal_bank {n['modal_bank']} "
          f"launches both times, validation max error "
          f"{rec['validation']['max_error']:.3g}, saturated p50 "
          f"{rec['saturated']['p50_ms']:.4f} ms, {w0:.1f} / {w1:.1f} s on "
          f"{smi}")
    dp_int8_phase(smi, dp_job)
    cards = torch.cuda.device_count()
    if cards < 2:
        rc, lines = quiet_main(cli, ["--benchmark", "gain",
                                     "--dataParallel", "2", "--json"])
        want = f"needs 2 devices; {cards} available"
        if rc != 1 or not any(want in ln for ln in lines):
            fail(f"--dataParallel 2 on {cards} card: exit {rc}, "
                 f"{lines[-3:]}")
        print(f"--dataParallel 2 on {cards} card exits 1: "
              f"{next(ln for ln in lines if want in ln)}")
        print("multi-rank --dataParallel: not run, 1 card")
        return
    for name in DP_MULTI_RANK:
        rec, wall = cli_json(cli, f"{name} --dataParallel 2",
                             ["--benchmark", name, "--dataParallel", "2"]
                             + DP_CLI)
        print(f"{name} --dataParallel 2 over NCCL on {cards} cards: "
              f"{wall:.1f} s, max error {rec['validation']['max_error']:.3g}"
              f", collectives a round trip "
              f"{rec['metadata']['collectiveInventory']}")


def bell_vs_twin(torch, ops, device):
    """The bell example's stream (2,048 decaying modes onto one track, the
    strike between two launches at the checkpoint block) on the card,
    each of its 375 blocks against the plain twin on the host run from the
    kernel's own input state, at OUT_RTOL of the output's peak and
    STATE_ATOL on the states. Returns the largest absolute output error."""
    from gpuaudiobench_tpu_torch.examples import streaming_synth as ex

    modes, seconds = BELL
    amp, cos_w, sin_w, re0, im0 = ex.bell_modes(modes)
    n_blocks, half = ex.blocks_for(seconds)
    kick = ex.strike(amp)
    stream, carry = ex.make_stream(amp, cos_w, sin_w, re0, im0, device)
    host = ex.make_stream(amp, cos_w, sin_w, re0, im0,
                          torch.device("cpu"))[0]
    worst = worst_abs = 0.0
    for b in range(n_blocks):
        if b == half:
            carry = ex.kicked(carry, kick)
        entry = [t.cpu() for t in carry]
        out, *carry = ops.modal_folded_step(stream.cos_w, stream.sin_w,
                                            *carry, 512, 1)
        want, *states = ops.modal_folded_step_plain(host.cos_w, host.sin_w,
                                                    *entry, 512, 1)
        err = (out.cpu() - want).abs().max().item()
        rel = err / want.abs().max().item()
        st = max((k.cpu() - w).abs().max().item()
                 for k, w in zip(carry, states))
        if rel > OUT_RTOL or st > STATE_ATOL:
            fail(f"bell block {b}: output {rel:.3g} of the peak, states "
                 f"{st:.3g} from the twin")
        worst, worst_abs = max(worst, rel), max(worst_abs, err)
    print(f"modal_bank bell {modes} modes x {n_blocks} blocks (|rotation| "
          f"< 1, T_out 1, strike at block {half}) vs twin: max error "
          f"{worst_abs:.3g}, {worst:.3g} of a block's peak")
    return worst_abs


def surfaces_tool(mod, label, argv, out, counts, reset, launches, kernels):
    """One campaign's ``main(argv)`` on the card, its report at ``out``:
    exit 0 and every kernel of ``kernels`` launched; adds the launches.
    Returns the report's payload."""
    reset()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    n = counts()
    if rc != 0:
        print(buf.getvalue()[-3000:])
        fail(f"{label}: {mod.__name__} returned {rc}")
    for k in kernels:
        if n[k] <= 0:
            fail(f"{label}: {k} was not launched")
    for k, v in n.items():
        launches[k] += v
    with open(out + ".json") as f:
        payload = json.load(f)
    print(f"{label}: {mod.__name__.rsplit('.', 1)[1]} in "
          f"{time.perf_counter() - t0:.1f} s on {payload['card']}; launches "
          + (", ".join(f"{k} {v}" for k, v in n.items() if v) or "none"))
    return payload


def print_tables(tables):
    """The tab4-tab8 and low-latency rows beside the published numbers."""
    from gpuaudiobench_tpu_torch.tools.campaign import fmt

    for r in tables["tab4"]["rows"]:
        print(f"tab4 {r['modes']} modes: round trip p50 "
              f"{r['roundtrip_p50_ms']:.4f} / p95 {r['roundtrip_p95_ms']:.4f}"
              f" ms (PC {r['pc_p50_ms']}, AS {r['as_p50_ms']}), saturated "
              f"{r['saturated_p50_ms']:.4f} (depth {r['depth']}), device "
              f"{r['device_p50_ms']:.4f} [{r['device_method']}], "
              f"{r['validation']}")
    for r in tables["tab6"]["rows"]:
        print(f"tab6 {r['tracks']} tracks: round trip p50 "
              f"{r['roundtrip_p50_ms']:.4f} / p95 {r['roundtrip_p95_ms']:.4f}"
              f" ms (PC {r['pc_p50_ms']}, AS {r['as_p50_ms']}), saturated "
              f"{r['saturated_p50_ms']:.4f} (depth {r['depth']}), marginal "
              f"{fmt(r['marginal_p50_ms'], 4)}, device "
              f"{r['device_p50_ms']:.4f}, {r['validation']}")
    for r in tables["tab5"]["rows"]:
        print(f"tab5 {r['benchmark']} 100 MiB: round trip p50 "
              f"{r['roundtrip_p50_ms']:.4f} / p95 {r['roundtrip_p95_ms']:.4f}"
              f" ms (PC {r['pc_ms']}, AS {r['as_ms']}, AS unified "
              f"{r['as_unified_ms']}), serial {r['serial_ms']:.4f} / "
              f"overlapped {r['overlapped_ms']:.4f} ms a block, H2D pinned "
              f"{r['h2d_pinned_ms']} / pageable {r['h2d_pageable_ms']}, D2H "
              f"pinned {r['d2h_pinned_ms']} / pageable {r['d2h_pageable_ms']}"
              f" ms, {r['h2d_path']}, {r['validation']}")
    for r in tables["tab7/tab8"]["rows"]:
        pub = (f"tab7 PC {' / '.join(map(str, r['pc_tab7']))}; "
               if r["pc_tab7"] else "")
        print(f"tab7/8 {r['workload']}, {r['mode']}"
              f"{' (' + r['pacer'] + ')' if r['pacer'] else ''}: p50 "
              f"{r['p50_ms']:.4f} / p95 {r['p95_ms']:.4f} / max "
              f"{r['max_ms']:.4f} ms, x{r['multiplier']:.3f}, miss "
              f"{r['miss_rate_percent']:.1f} % ({pub}tab8 x"
              f"{r['pc_multiplier']} PC / x{r['as_multiplier']} AS), "
              f"{r['validation']}")
    for r in tables["lowlatency"]["rows"]:
        cells = ", ".join(
            f"buf {c['buffer']} {c['saturated_p50_ms']:.4f} ms "
            f"{'meets' if c['meets'] else 'MISSES'} {c['deadline_ms']:.3f}"
            for c in r["cells"])
        print(f"lowlatency {r['workload']} (depth {r['depth']}): {cells}")


def surfaces_port_phase(torch, counts, reset, launches, smi):
    """Phase 18: the repo-level surfaces of the port on the card."""
    from gpuaudiobench_tpu_torch.tools import (
        compare_runs,
        doctor,
        report,
        satreps_campaign,
    )

    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_surfaces_")
    try:
        tables = {}
        for name, label, flags, kernels in SURFACE_TOOLS:
            out = os.path.join(tmpdir, name)
            argv = (flags + ["--out", out] if name == "transfer_tab5"
                    else [out] + flags)
            mod = importlib.import_module(
                f"gpuaudiobench_tpu_torch.tools.{name}")
            tables[label] = surfaces_tool(mod, label, argv, out, counts,
                                          reset, launches, kernels)
        print_tables(tables)

        # 101 saturated reps on the modal headline, through the CLI.
        md, js = (os.path.join(tmpdir, f"satreps.{e}") for e in ("md", "json"))
        reset()
        t0 = time.perf_counter()
        lines = run_quiet(satreps_campaign.main,
                          [SATREPS[0], md, js] + SATREPS[1:], "satreps")
        n = counts()
        if n["modal_bank"] <= 0:
            fail("satreps: modal_bank was not launched")
        for k, v in n.items():
            launches[k] += v
        with open(js) as f:
            rec = json.load(f)
        rows = satreps_campaign.rows_of([rec])
        if len(rows) != 1 or rows[0]["reps"] != 101:
            fail(f"satreps: rows {rows}")
        r = rows[0]
        print(f"satreps ModalFilterBank 1M modes, {r['reps']} reps of depth "
              f"{r['depth']}: p50 {r['p50_ms']:.4f} / p95 {r['p95_ms']:.4f} "
              f"/ p99 {r['p99_ms']:.4f} / max {r['max_ms']:.4f} ms, "
              f"{r['above_p99']} above the p99, validation "
              f"{rec['validation']['status']}, {time.perf_counter() - t0:.1f}"
              f" s ({len(lines)} lines)")

        # The report and the A/B over the phase's own JSON.
        page = os.path.join(tmpdir, "report.html")
        run_quiet(report.main, [js, "-o", page], "report")
        html = open(page).read()
        ident = rec["device"]
        for want in (ident["kind"], ident.get("power_limit"),
                     "ModalFilterBank",
                     "vs published baselines"):
            if not want or want not in html:
                fail(f"report: {want!r} missing from the page")
        lines = run_quiet(compare_runs.main, [js, js, "--all"],
                          "compare_runs")
        if not any("0 regressed" in ln for ln in lines):
            fail("compare_runs: a run against itself regressed")

        # The six examples at their defaults, each with its proof.
        for name, proof, want in EXAMPLES:
            reset()
            t0 = time.perf_counter()
            mod = importlib.import_module(
                f"gpuaudiobench_tpu_torch.examples.{name}")
            lines = run_quiet(mod.main, ["--out",
                                         os.path.join(tmpdir, name + ".wav")],
                              name)
            if not any(proof in ln for ln in lines):
                fail(f"{name}: no {proof!r} in its output")
            n = counts()
            if name == "multichip_synth":  # launched in the rank's process
                line = next(ln for ln in lines
                            if ln.startswith("kernel launches:"))
                n["modal_bank"] += int(line.split()[3])
            got = {k: v for k, v in n.items() if v}
            if got != want:
                fail(f"{name}: launches {got}, expected {want}")
            for k, v in n.items():
                launches[k] += v
            print(f"example {name}: {time.perf_counter() - t0:.1f} s, "
                  f"launches {got or 'none'}")

        lines = run_quiet(doctor.main, [], "doctor")
        if not any("doctor: healthy" in ln for ln in lines):
            fail("doctor: not healthy")
        print(f"repo-level surfaces on {smi}: passed")
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

def key_paths(d, prefix=""):
    """Every key path of a JSON object, nested objects included."""
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= key_paths(v, prefix + k + ".")
    return out


def counted(label, fn, argv, counts, reset, launches, kernels):
    """``fn(argv)`` with its output captured: exit 0 and each of
    ``kernels`` launched; adds the launches. Returns (the output lines,
    the launches, the wall seconds)."""
    reset()
    t0 = time.perf_counter()
    lines = run_quiet(fn, argv, label)
    wall = time.perf_counter() - t0
    n = counts()
    for k in kernels:
        if n[k] <= 0:
            fail(f"{label}: {k} was not launched")
    for k, v in n.items():
        launches[k] += v
    return lines, {k: v for k, v in n.items() if v}, wall


def driver_runs(torch, cli, output, tmpdir, counts, reset, launches):
    """The native driver: built from the package's source, --list the
    registry, then each of DRIVER_RUNS through the driver, ``python -m``
    and ``cli.main`` in this process: each exits 0 and validates on this
    card, the driver's JSON has the in-process run's keys, and
    ``tools.json_to_csv`` of it is ``csv_from_json_results``; each run's
    wall through the driver is printed beside ``python -m``'s (the four
    processes run together, beside the in-process runs)."""
    from gpuaudiobench_tpu_torch.registry import list_benchmarks
    from gpuaudiobench_tpu_torch.tools import json_to_csv
    from gpuaudiobench_tpu_torch.utils import native

    t0 = time.perf_counter()
    exe = str(native.build_driver())
    print(f"driver: built {os.path.basename(exe)} in "
          f"{time.perf_counter() - t0:.2f} s")
    env = dict(os.environ, PYTHONPATH=HERE)
    r = subprocess.run([exe, "--list"], capture_output=True, text=True,
                       env=env, timeout=120)
    names = r.stdout.splitlines()[2:]
    if r.returncode != 0 or names != list_benchmarks() or len(names) != 30:
        fail(f"driver --list: rc {r.returncode}, {len(names)} names "
             f"{r.stderr[-2000:]}")
    card = torch.cuda.get_device_name(0)

    def one(i, how, argv):
        path = os.path.join(tmpdir, f"{how[0]}_{i}.json")
        cmd = ([exe] if how == "driver" else
               [sys.executable, "-m", "gpuaudiobench_tpu_torch.cli"])
        t0 = time.perf_counter()
        r = subprocess.run(cmd + argv + ["--outputfile", path],
                           capture_output=True, text=True, env=env,
                           timeout=600)
        return r, path, time.perf_counter() - t0

    # Every run's driver and python -m processes together, beside the
    # in-process runs.
    pool = ThreadPoolExecutor(max_workers=2 * len(DRIVER_RUNS))
    jobs = {(i, how): pool.submit(one, i, how, argv)
            for i, (_, argv, _) in enumerate(DRIVER_RUNS)
            for how in ("driver", "python -m")}
    pool.shutdown(wait=False)
    for i, (label, argv, kernels) in enumerate(DRIVER_RUNS):
        path = os.path.join(tmpdir, f"i_{i}.json")
        counted(f"cli.main {label}", cli.main, argv + ["--outputfile", path],
                counts, reset, launches, kernels)
    for i, (label, argv, kernels) in enumerate(DRIVER_RUNS):
        with open(os.path.join(tmpdir, f"i_{i}.json")) as f:
            inproc = json.load(f)
        recs, times = {}, {}
        for how in ("driver", "python -m"):
            r, path, times[how] = jobs[i, how].result()
            if r.returncode != 0:
                print(r.stdout[-3000:], r.stderr[-3000:])
                fail(f"{how} {label}: exit {r.returncode}")
            with open(path) as f:
                recs[how] = json.load(f)
        for how, rec in recs.items():
            if rec["validation"]["status"] != "SUCCESS":
                fail(f"{how} {label}: validation {rec['validation']}")
            if rec["device"]["kind"] != card:
                fail(f"{how} {label}: device {rec['device']}")
            if key_paths(rec) != key_paths(inproc):
                fail(f"{how} {label}: keys differ from cli.main's: "
                     f"{sorted(key_paths(rec) ^ key_paths(inproc))}")
        src = os.path.join(tmpdir, f"d_{i}.json")
        csv = src[:-5] + ".csv"
        run_quiet(json_to_csv.main, [src, csv], "json_to_csv")
        with open(csv) as f:
            if f.read() != output.csv_from_json_results([recs["driver"]]):
                fail(f"json_to_csv {label}: not csv_from_json_results")
        d = recs["driver"]
        print(f"driver {label}: {times['driver']:.2f} s (python -m "
              f"{times['python -m']:.2f} s), validation "
              f"{d['validation']['status']} ({d['validation']['max_error']:.3g}"
              f") on {d['device']['kind']}, {d['device']['power_limit']}, "
              f"saturated p50 {d['saturated']['p50_ms']:.4f} ms, chain "
              f"{d['metadata'].get('chainForm')}, device p50 "
              f"{d['device_statistics']['median_ms']:.4f} ms; keys equal "
              f"the in-process run's; json_to_csv equal")


def last_surfaces_phase(torch, cli, output, counts, reset, launches, smi,
                        bench_rec):
    """Phase 19: the native driver, json_to_csv, regen_artifacts,
    render_results, remeasure_rows, readme_headline, the overlap campaign,
    the latency attribution and the mesh ladder on the card."""
    from gpuaudiobench_tpu_torch.tools import (
        latency_attrib,
        mesh_scaling,
        overlap_campaign,
        readme_headline,
        regen_artifacts,
        remeasure_rows,
        render_results,
    )

    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_last_")
    try:
        t0 = time.perf_counter()
        driver_runs(torch, cli, output, tmpdir, counts, reset, launches)
        print(f"driver runs: {time.perf_counter() - t0:.1f} s")

        art = os.path.join(tmpdir, "artifacts")
        _, n, wall = counted("regen_artifacts", regen_artifacts.main,
                             ["--out", art] + REGEN, counts, reset, launches,
                             REGEN_KERNELS)
        js = os.path.join(art, "RESULTS.json")
        md = os.path.join(art, "RESULTS.md")
        if render_results.main([md, "--check"]) != 0:
            fail("regen_artifacts: render_results --check drifted")
        with open(js) as f:
            suite = json.load(f)
        with open(os.path.join(art, "report.html")) as f:
            page = f.read()
        ident = suite[0]["device"]
        for want in (ident["kind"], ident["power_limit"]):
            if want not in page:
                fail(f"regen_artifacts: {want!r} missing from report.html")
        print(f"regen_artifacts: {wall:.1f} s, rows "
              + ", ".join(f"{r['benchmark']} {r['validation']['status']}"
                          for r in suite)
              + f"; RESULTS.{{json,csv,md}} and report.html on "
              f"{ident['kind']}, {ident['power_limit']}; --check passed; "
              f"launches {n}")

        before = [json.dumps(r, indent=2) for r in suite]
        _, n, wall = counted("remeasure_rows", remeasure_rows.main,
                             [js] + REMEASURE, counts, reset, launches,
                             ["iir_biquad"])
        with open(js) as f:
            after = json.load(f)
        for r, old in zip(after, before):
            if r["benchmark"] == REMEASURE[0]:
                if r["saturated"]["reps"] != 11 or json.dumps(
                        r, indent=2) == old:
                    fail(f"remeasure_rows: {r['benchmark']} not replaced "
                         f"(reps {r['saturated']['reps']})")
            elif json.dumps(r, indent=2) != old:
                fail(f"remeasure_rows: {r['benchmark']} changed")
        row = next(r for r in after if r["benchmark"] == REMEASURE[0])
        print(f"remeasure_rows {REMEASURE[0]}: {wall:.1f} s, reps 11, "
              f"saturated p50 {row['saturated']['p50_ms']:.4f} ms, "
              f"validation {row['validation']['status']}, the other rows "
              f"byte-equal; launches {n}")

        base = os.path.join(art, "overlap")
        _, n, wall = counted("overlap_campaign", overlap_campaign.main,
                             [base + ".md"] + OVERLAP_CAMPAIGN, counts, reset,
                             launches, OVERLAP_KERNELS)
        with open(base + ".json") as f:
            ov = json.load(f)
        if len(ov["rows"]) != 13 or ov["skipped"]:
            fail(f"overlap_campaign: {len(ov['rows'])} rows, skipped "
                 f"{ov['skipped']}")
        print(f"overlap_campaign: {wall:.1f} s on {ov['card']}, launches "
              f"{n}; speedups "
              + ", ".join(f"{r['name']} {r['speedup']:.2f}x ({r['serial']:.4f}"
                          f" -> {r['overlapped']:.4f} ms, {r['validation']},"
                          f" h2d {r['h2d_path'] or '-'})" for r in ov["rows"]))

        with open(os.path.join(art, "bench.json"), "w") as f:
            json.dump(bench_rec, f)
        readme = os.path.join(tmpdir, "README.md")
        with open(os.path.join(HERE, "README.md")) as f:
            original = f.read()
        with open(readme, "w") as f:
            f.write(original + f"\n{readme_headline.BEGIN}\n"
                    f"{readme_headline.END}\n")
        for argv in ([readme, "--artifacts", art],
                     [readme, "--artifacts", art, "--check"]):
            run_quiet(readme_headline.main, argv, "readme_headline")
        with open(readme) as f:
            text = f.read()
        jax_block = original[original.index("<!-- headline:begin -->"):
                             original.index("<!-- headline:end -->")]
        if jax_block not in text or text.count(jax_block) != 1:
            fail("readme_headline: the JAX headline block changed")
        block = text[text.index(readme_headline.BEGIN):]
        if ident["power_limit"] not in block or "faster" not in block:
            fail(f"readme_headline: {block}")
        print("readme_headline: " + " ".join(block.splitlines()[1:-1]))

        base = os.path.join(tmpdir, "latency_attrib")
        _, n, wall = counted("latency_attrib", latency_attrib.main,
                             [base + ".md"] + LATENCY_ATTRIB, counts, reset,
                             launches, ["iir_biquad", "dwg_block"])
        with open(base + ".json") as f:
            la = json.load(f)
        for r in la["rows"]:
            print(f"latency_attrib {r['benchmark']}: A {r['A_ms']:.4f} ms, "
                  f"B {r['B_ms']:.6f} ms a block, device p50 "
                  f"{r['device_p50_ms']:.6f} ms [{r['device_method']}], "
                  f"chain {r['chain_form']}, points {r['points']}")
        print(f"latency_attrib: {wall:.1f} s, launches {n}")

        base = os.path.join(tmpdir, "mesh_scaling")
        _, n, wall = counted("mesh_scaling", mesh_scaling.main, [base + ".md"],
                             counts, reset, launches,
                             ["iir_biquad", "modal_bank"])
        with open(base + ".json") as f:
            ms = json.load(f)
        ran = {(r["benchmark"], r["mesh"]): r for r in ms["rows"]}
        for name in ("MultiChipSuite", "ICIBandwidth"):
            r = ran.get((name, "1,1,1"))
            if r is None or r["validation"] != "passed":
                fail(f"mesh_scaling: {name} 1,1,1 {r}")
        for r in ms["rows"]:
            print(f"mesh_scaling {r['benchmark']} {r['mesh']}: p50 "
                  f"{r['p50_ms']:.4f} ms, collectives {r['collectives']}, "
                  f"{r['validation']}")
        for line in ms["skipped"]:
            print(f"mesh_scaling {line}")
        print(f"mesh_scaling: {wall:.1f} s on {ms['card']}, launches {n}")
        print(f"the last repo-level surfaces on {smi}: passed")
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def percentile(values, p):
    """The native runner's percentile: the sorted value at p * (n - 1)."""
    v = sorted(values)
    return v[int(p * (len(v) - 1))] if v else 0.0


def runner_lines(text):
    """The native runner's result lines: checksum, load ms, p50 and p95."""
    def grab(pattern):
        m = re.search(pattern, text)
        if m is None:
            return None
        return float(m.group(1))

    return {"checksum": grab(r"checksum (-?[0-9.e+-]+|nan|-?inf)\)"),
            "load_ms": grab(r"load: ([0-9.]+) ms"),
            "p50": grab(r"p50: ([0-9.]+) ms"), "p95": grab(r"p95: ([0-9.]+) ms")}


def in_process(torch, ep, name, device):
    """A program's port function in this process on the card, on the
    runner's LCG inputs made in Python: (its checksum, the round-trip
    latencies of NATIVE_RUNS timed calls, each a call, a synchronisation
    and the copy of output 0 to the host)."""
    module, spec = ep.make_program(name, device)
    inputs = ep.lcg_inputs(spec, device)

    def round_trip():
        out = ep.first_output(module(*inputs))
        torch.cuda.synchronize()
        return out.cpu()

    host = round_trip()
    lat = []
    for _ in range(NATIVE_RUNS):
        t0 = time.perf_counter()
        round_trip()
        lat.append((time.perf_counter() - t0) * 1e3)
    return ep.checksum(host), lat


def libraries_mapped(pid):
    """The file names of the shared objects mapped by process ``pid``."""
    with open(f"/proc/{pid}/maps") as f:
        return {os.path.basename(line.split()[-1]) for line in f
                if line.rstrip().endswith(".so") or ".so." in line}


class NativeExports:
    """Phase 20's eight exports (``tools.export_programs``), one process
    each, all started together once the kernels' timings are done (after
    phase 9) and compiling beside phases 10-19 at the lowest CPU priority,
    one compile thread each, so that the host-bound phases keep their
    cores. ``stop`` kills any still running and removes their directory;
    it runs at exit too, whatever phase failed."""

    def __init__(self):
        from gpuaudiobench_tpu_torch.tools import export_programs as ep

        self.tmpdir = tempfile.mkdtemp(prefix="chip_smoke_native_")
        env = dict(os.environ, TORCHINDUCTOR_COMPILE_THREADS="1",
                   OMP_NUM_THREADS="1",
                   TORCHINDUCTOR_CACHE_DIR=os.path.join(self.tmpdir,
                                                        "inductor"))
        self.procs = []
        atexit.register(self.stop)
        self.t0 = time.perf_counter()
        for name in ep.NAMES:
            log = open(os.path.join(self.tmpdir, f"{name}.log"), "w+")
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "gpuaudiobench_tpu_torch.tools.export_programs", "--out",
                 self.tmpdir, name], cwd=HERE, env=env, stdout=log,
                stderr=subprocess.STDOUT)
            os.setpriority(os.PRIO_PROCESS, proc.pid, 19)
            self.procs.append((name, log, proc))

    def stop(self):
        for _, log, proc in self.procs:
            proc.kill()
            proc.wait()
            log.close()
        self.procs = []
        shutil.rmtree(self.tmpdir, ignore_errors=True)


def native_phase(torch, counts, reset, launches, runner_job, bench_rec, smi,
                 exports):
    """Phase 20: the eight programs of ``tools.export_programs`` exported
    on the card (``exports``, started after phase 9) and run by the
    native runner (``csrc/native_runner.cc``), each in its own process with
    ``--runs NATIVE_RUNS``: each exits 0 with its warm-up checksum within
    NATIVE_RTOL of the same port function's in this process on the same
    LCG inputs, and the kernels' operators launched by those in-process
    runs. A runner process maps no libpython. Each program's export and
    compile seconds, load ms, and the runner's p50 and p95 beside the same
    round trip's in this process."""
    from gpuaudiobench_tpu_torch.ops import gpuab
    from gpuaudiobench_tpu_torch.tools import export_programs as ep

    device = torch.device("cuda")
    tmpdir, procs = exports.tmpdir, exports.procs
    t_phase = time.perf_counter()
    try:
        # While they compile: each port function in this process, its
        # checksum, and the kernels it launches.
        want = {}
        for name in ep.NAMES:
            reset()
            module, spec = ep.make_program(name, device)
            out = ep.first_output(module(*ep.lcg_inputs(spec, device)))
            torch.cuda.synchronize()
            want[name] = ep.checksum(out)
            n = counts()
            for k in NATIVE_KERNELS[name]:
                if n[k] <= 0:
                    fail(f"native {name}: {k} was not launched in process")
            for k, v in n.items():
                launches[k] += v
        exe = str(runner_job.result())
        lib = gpuab.library_path()

        exported = {}
        for name, log, proc in procs:
            try:
                rc = proc.wait(timeout=NATIVE_EXPORT_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                fail(f"native export {name}: no result in "
                     f"{NATIVE_EXPORT_TIMEOUT} s")
            log.seek(0)
            text = log.read()
            log.close()
            if rc != 0:
                print(text[-3000:])
                fail(f"native export {name}: exit {rc}")
            m = re.search(r"export ([0-9.]+) s, compile ([0-9.]+) s", text)
            exported[name] = (float(m.group(1)), float(m.group(2)))
        exports.procs = []
        print(f"native export: the eight programs started "
              f"{t_phase - exports.t0:.1f} s before this phase, all done "
              f"{time.perf_counter() - t_phase:.1f} s into it")

        # No libpython in a runner process: read its maps during its runs.
        name = "modal_pallas"
        args = [exe, "--package", os.path.join(tmpdir, f"{name}.pt2"),
                "--spec", os.path.join(tmpdir, f"{name}.spec"), "--ops", lib]
        proc = subprocess.Popen(args + ["--runs", str(NATIVE_MAPS_RUNS)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            for line in proc.stdout:
                if line.startswith("warmup:"):
                    break
            mapped = libraries_mapped(proc.pid)
        finally:
            proc.kill()
            proc.communicate()
        python_libs = sorted(m for m in mapped if "python" in m)
        if python_libs:
            fail(f"native runner maps {python_libs}")
        for want_lib in ("libtorch_cuda.so", os.path.basename(lib)):
            if want_lib not in mapped:
                fail(f"native runner: {want_lib} not mapped")
        print(f"native runner: {len(mapped)} shared objects mapped, no "
              f"libpython; {os.path.basename(lib)} and libtorch_cuda.so "
              "among them")

        for name in ep.NAMES:
            args = [exe, "--package", os.path.join(tmpdir, f"{name}.pt2"),
                    "--spec", os.path.join(tmpdir, f"{name}.spec"), "--ops",
                    lib, "--runs", str(NATIVE_RUNS)]
            r = subprocess.run(args, capture_output=True, text=True,
                               timeout=NATIVE_RUN_TIMEOUT)
            got = runner_lines(r.stdout)
            if r.returncode != 0 or None in got.values():
                print(r.stdout[-2000:], r.stderr[-3000:])
                fail(f"native runner {name}: exit {r.returncode}")
            tol = NATIVE_RTOL * max(abs(want[name]), 1.0)
            if not abs(got["checksum"] - want[name]) <= tol:
                fail(f"native runner {name}: checksum {got['checksum']!r}, "
                     f"in process {want[name]!r}")
            reset()
            _, lat = in_process(torch, ep, name, device)
            for k, v in counts().items():
                launches[k] += v
            exp_s, comp_s = exported[name]
            print(f"native {name}: export {exp_s:.2f} s, compile "
                  f"{comp_s:.2f} s, load {got['load_ms']:.1f} ms; runner "
                  f"p50 {got['p50']:.4f} ms, p95 {got['p95']:.4f} ms; in "
                  f"process p50 {percentile(lat, 0.5):.4f} ms, p95 "
                  f"{percentile(lat, 0.95):.4f} ms; checksum "
                  f"{got['checksum']:.6f} (in process {want[name]:.6f})")
        print(f"native: modal headline saturated p50 "
              f"{bench_rec['saturated_rep_p50_ms']} ms through the operator "
              f"(PR 23, through ctypes: {NATIVE_PR23_HEADLINE_MS} ms); the "
              f"eight programs on {smi}: passed")
    finally:
        exports.stop()


class GpuabDispatches:
    """Counts, by name, the ``gpuab`` operators dispatched while it is
    entered (a ``TorchDispatchMode``, made on first use): the proof that a
    phase reached its kernels through ``torch.ops.gpuab``."""

    def __init__(self, torch):
        from torch.utils._python_dispatch import TorchDispatchMode

        seen = self.seen = {}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.namespace == "gpuab":
                    name = func._schema.name.split("::", 1)[1]
                    seen[name] = seen.get(name, 0) + 1
                return func(*args, **(kwargs or {}))

        self._mode_type = Mode

    def __enter__(self):
        self._mode = self._mode_type()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def canonical_buckets(torch, buckets, n):
    """(cells, starts, the rows sorted by (plane, row)) of the bucketing
    kernel's outputs: the same bits whatever order its atomics gave the
    rows of a plane."""
    cells, order, starts = buckets
    plane = cells.long()[order.long()] // (n * n)
    key = plane * cells.numel() + order.long()
    return cells, starts, torch.sort(key).values


def export_steps(torch, ops, iops, rops, dops, fops, sops, device):
    """(operator, label, step, inputs, mutated input indices) of one small
    step per operator that queue 1's item 21b added (EXPORT_OPS), on the
    card."""
    import numpy as np

    m, s, t = 4096, 64, 32
    tabs = make_inputs(torch, m, seed=7, device=device)
    res = ops.res_init(tabs["cos_w"], tabs["sin_w"], tabs["amp"] * tabs["re"],
                       tabs["amp"] * tabs["im"])
    x, c1, z1 = iir_inputs(torch, 256, 128, device)
    taps, u = blockstate_tables(torch, iops, c1, 128, 16, device)
    xk, ck, zk = iir_inputs(torch, 256, 128, device, stages=IIR_STAGES)
    g = np.random.Generator(np.random.MT19937(17))
    pool = torch.from_numpy(g.random(1 << 20, dtype=np.float32)).to(device)
    ph = torch.from_numpy(g.integers(-1000, (1 << 20) + 1000, 256).astype(
        np.int32)).to(device)
    n, src, rcv = fdtd_geometry(fops, 8)
    off_grid = torch.tensor([503, -1, 7, 100, 0, 1040, -1009, 12] * 2,
                            dtype=torch.int32, device=device)
    _, xs = sol_inputs(torch, 64, 1024, device)
    return [
        ("modal_res_launch", f"modal_res_step M={m} S={s} T_out={t}",
         lambda e, y, q: ops.modal_res_step(e, y, q, s, t), list(res), ()),
        ("iir_blockstate_launch", "iir_biquad_blockstate 256x128 m=16",
         iops.iir_biquad_blockstate, [x, c1, taps, u, z1], ()),
        ("iir_cascade_chain_launch", f"iir_cascade_chain 256x128 "
         f"K={IIR_STAGES}", iops.iir_cascade_chain, [xk, ck, zk], ()),
        ("rndmem_gather_launch", "rndmem_gather 256x512 from 4 MiB",
         lambda p, h: rops.rndmem_gather(p, h, 512), [pool, ph], ()),
        ("dwg_block_launch", "dwg_block 1000x512 Lmax 1100",
         dops.dwg_block, dwg_inputs(torch, 1000, 512, 1100, None, False,
                                    device), (1, 2)),
        ("fdtd_field_planes_launch", "fdtd3d_block_field room 8, 16x64",
         lambda xx, p, vx, vy, vz: fops.fdtd3d_block_field(
             xx, p, vx, vy, vz, src, rcv),
         [fdtd_x(torch, 16, 64, device), *fops.zero_fields(n, device)], ()),
        ("fdtd_field_planes_launch", "fdtd3d_block_field room 8, 16x64, "
         "16 per-track receivers off the grid",
         lambda xx, p, vx, vy, vz, r: fops.fdtd3d_block_field(
             xx, p, vx, vy, vz, src, rcv, receivers=r),
         [fdtd_x(torch, 16, 64, device), *fops.zero_fields(n, device),
          off_grid], (), ("fdtd_receiver_buckets",)),
        ("fdtd_receiver_buckets", "receiver_buckets room 8, 16 tracks",
         lambda r: canonical_buckets(torch, fops.receiver_buckets(r, n), n),
         [off_grid], ()),
        ("fma_chain_launch", "fma_chain 64x1024 k=64",
         lambda xx: sops.fma_chain(xx, 64), [xs], ()),
        ("fma_vmem_launch", "fma_vmem 64x1024 k=64",
         lambda xx: sops.fma_vmem(xx, 64), [xs], ()),
    ]


def export_ops_phase(torch, ops, iops, rops, dops, fops, sops, device):
    """Phase 21: ``torch.export`` of one small step per operator that item
    21b added, on the card: the program holds the operator as a node, its
    module runs on the card, and its outputs (and the DWG rails it writes
    in place) equal the eager wrapper's bit for bit. No AOTInductor
    compile (phase 20 compiles the JAX exporter's eight programs)."""

    class Step(torch.nn.Module):
        def __init__(self, fn):
            super().__init__()
            self.fn = fn

        def forward(self, *args):
            return self.fn(*args)

    def as_tuple(out):
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    steps = export_steps(torch, ops, iops, rops, dops, fops, sops, device)
    if {op for op, *_ in steps} != set(EXPORT_OPS):
        fail("export phase: the steps do not cover EXPORT_OPS")
    for op, label, fn, inputs, mutated, *also in steps:
        t0 = time.perf_counter()
        prog = torch.export.export(Step(fn), tuple(t.clone() for t in inputs))
        export_s = time.perf_counter() - t0
        names = (op, *(also[0] if also else ()))
        for name in names:
            if f"gpuab.{name}" not in str(prog.graph):
                fail(f"export {label}: the program holds no gpuab.{name} "
                     "node")
        nodes = sum(1 for nd in prog.graph.nodes if nd.op == "call_function")
        eager_in = [t.clone() for t in inputs]
        exported_in = [t.clone() for t in inputs]
        want = as_tuple(fn(*eager_in))
        with GpuabDispatches(torch) as seen:
            got = as_tuple(prog.module()(*exported_in))
        torch.cuda.synchronize()
        if any(seen.seen.get(name, 0) != 1 for name in names):
            fail(f"export {label}: the exported module dispatched "
                 f"{seen.seen}")
        pairs = list(zip(got, want)) + [(exported_in[i], eager_in[i])
                                        for i in mutated]
        if len(got) != len(want) or not all(
                a.shape == b.shape and torch.equal(a, b) for a, b in pairs):
            fail(f"export {label}: the exported program differs from the "
                 "eager call")
        if not all(torch.isfinite(a).all() for a in got):
            fail(f"export {label}: non-finite output")
        print(f"export {label}: {' and '.join(names)} of {nodes} nodes, "
              f"exported in "
              f"{export_s:.2f} s, run on the card bit for bit the eager "
              "wrapper's" + (" (outputs and the rails written in place)"
                             if mutated else ""))


def capture_run(torch, cli, hprofiler, counts, reset, launches):
    """The CLI with --capture on the modal headline cell: one session
    writes a trace holding modal_bank device events; the timed reps of its
    saturated tier, summarized from the trace (busy time a block, idle
    share). Adds the launches."""
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        label = "ModalFilterBank 1M modes, --capture"
        reset()
        argv = CAPTURE_CLI + ["--captureDir", tmpdir]
        rec, wall = cli_json(cli, label, argv)
        n = counts()
        if n["modal_bank"] <= 0:
            fail(f"{label}: modal_bank was not launched")
        for k, v in n.items():
            launches[k] += v
        if rec["metadata"].get("chainForm") != "cuda-graph":
            fail(f"{label}: chain form {rec['metadata'].get('chainForm')!r}")
        path = os.path.join(tmpdir, "ModalFilterBank.trace.json")
        events = hprofiler.trace_events(path)
        if not any("modal_bank" in e[0] for e in events):
            fail(f"{label}: the trace holds no modal_bank event "
                 f"({len(events)} device events)")
        blocks, replays = chain_expectation(argv)
        s = hprofiler.trace_summary(path, blocks * (replays // 2 - 1),
                                    "saturated-reps")
        if "error" in s:
            fail(f"{label}: no device event in the saturated reps")
        print(f"capture {label}: {wall:.1f} s, trace "
              f"{os.path.getsize(path) / 2**20:.1f} MiB with {len(events)} "
              f"device events; the saturated tier's timed reps "
              f"({s['blocks']} chained blocks, graph replays): busy "
              f"{s['device_busy_us_per_block']:.2f} us a block in a window of "
              f"{s['window_us_per_block']:.2f} us, idle share "
              f"{s['device_idle_share']:.2%} over the reps' range ("
              + ", ".join(f"{k or 'no span'} {v:.2f}" for k, v in
                          s["idle_us_per_block_by_range"].items())
              + " us a block idle), kernels (us a block) "
              + ", ".join(f"{k[:40]} {v:.2f}" for k, v in
                          list(s["kernel_us_per_block"].items())[:4])
              + f"; saturated p50 {rec['saturated']['p50_ms']:.4f} ms")
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


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
        from gpuaudiobench_tpu_torch import tools
        from gpuaudiobench_tpu_torch.harness import checkpoint
        from gpuaudiobench_tpu_torch.harness import graph as hgraph
        from gpuaudiobench_tpu_torch.harness import output, overlap
        from gpuaudiobench_tpu_torch.harness import profiler as hprofiler
        from gpuaudiobench_tpu_torch.harness import streaming
        from gpuaudiobench_tpu_torch.models import modal as models_modal
        from gpuaudiobench_tpu_torch.models import session as models_session
        from gpuaudiobench_tpu_torch.ops import conv as cops
        from gpuaudiobench_tpu_torch.ops import dwg as dops
        from gpuaudiobench_tpu_torch.ops import fdtd3d as fops
        from gpuaudiobench_tpu_torch.ops import iir as iops
        from gpuaudiobench_tpu_torch.ops import modal as ops
        from gpuaudiobench_tpu_torch.ops import neuralamp as na
        from gpuaudiobench_tpu_torch.ops import partconv as pc
        from gpuaudiobench_tpu_torch.ops import rndmem as rops
        from gpuaudiobench_tpu_torch.ops import speedoflight as sops
        from gpuaudiobench_tpu_torch.parallel import ranks
        from gpuaudiobench_tpu_torch.tools import (  # noqa: F401
            build_capacity_ledger,
            capacity,
            merge_capacity,
            overlap64_attrib,
            soak,
        )
        from gpuaudiobench_tpu_torch.ops import gpuab
        from gpuaudiobench_tpu_torch.utils import build
        from gpuaudiobench_tpu_torch.utils import device as dev
        from gpuaudiobench_tpu_torch.utils import native
        from gpuaudiobench_tpu_torch.utils import roofline
        from gpuaudiobench_tpu_torch.webui import server as webui_server
    except ImportError as e:
        fail(f"the port's package is not importable here ({e}); run from "
             "the root of a checkout")

    t_start = time.perf_counter()
    smi = toolchain(torch, build, dev)
    device = dev.device("cuda")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the blockstate twin needs full FP32")

    # The operator library's object and the native runner compile with g++
    # beside the kernels' nvcc; the library links once the kernels exist.
    # Phase 17's int8 gloo ranks run on the CPU beside them.
    t0 = time.perf_counter()
    jobs = ThreadPoolExecutor(max_workers=3)
    ops_job = jobs.submit(native.compile_ops)
    runner_job = jobs.submit(native.build_runner)
    dp_job = jobs.submit(dp_int8_ranks)  # phase 17 reads it
    jobs.shutdown(wait=False)
    libs = build.build_all(["modal_bank", "iir", "conv1d", "rndmem", "dwg",
                            "fdtd3d", "speedoflight"])
    ops_job.result()
    gpuab.load()
    for mod in (ops, iops, fops):  # the schedule and capacity queries
        mod._lib()
    no_cuda = [name for name in gpuab.OPS
               if not torch._C._dispatch_has_kernel_for_dispatch_key(
                   f"gpuab::{name}", "CUDA")]
    if len(gpuab.OPS) != 15 or no_cuda:
        fail(f"the gpuab library has {len(gpuab.OPS)} operators, without a "
             f"CUDA implementation: {no_cuda}")
    print(f"build: {', '.join(p.name for p in libs)}, "
          f"{os.path.basename(gpuab.library_path())} ({len(gpuab.OPS)} "
          f"operators) in {time.perf_counter() - t0:.2f} s")

    # Every kernel-vs-twin comparison below runs under a dispatch mode
    # that counts the gpuab operators: all 15 must be reached through
    # them (the timings run outside it).
    dispatched = GpuabDispatches(torch)
    with dispatched:
        errs = [compare(torch, ops, shape, device) for shape in SHAPES]
    modal_err = {"modal_bank": max(e[0] for e in errs),
                 "modal_res": max(e[1] for e in errs)}
    modal_times = time_main_shape(torch, ops, device)
    modal_err["modal_bank"] = max(modal_err["modal_bank"],
                                  bell_vs_twin(torch, ops, device))

    t0 = time.perf_counter()
    iir_err = {}
    with dispatched:
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
    with dispatched:
        conv_err = max(compare_conv(torch, cops, shape, device)
                       for shape in CONV_SHAPES)
    conv_times = time_conv(torch, cops, device)
    print(f"conv1d kernel vs twin: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with dispatched:
        pool, ph, rndmem_err = compare_rndmem(torch, rops, device)
    rndmem_times = time_rndmem(torch, rops, pool, ph)
    del pool, ph
    print(f"rndmem_gather kernel vs twin: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with dispatched:
        dwg_err = max(compare_dwg(torch, dops, shape, device)
                      for shape in DWG_SHAPES)
    dwg_times = time_dwg(torch, dops, device)
    print(f"dwg_block kernel vs twin: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    fdtd_err = {k: 0.0 for k in FDTD_REPLACES}
    with dispatched:
        for room, s in FDTD_SHAPES:
            for k, v in compare_fdtd(torch, fops, room, s, device).items():
                fdtd_err[k] = max(fdtd_err[k], v)
    with dispatched:
        fdtd_err["fdtd3d_receiver_buckets"] = compare_fdtd_receivers(
            torch, fops, device)
    fdtd_times, _ = time_fdtd(torch, fops, device)
    bucket_times = time_receiver_buckets(torch, fops, device)
    fdtd_times["fdtd3d_receiver_buckets"] = bucket_times[FDTD_MAIN[2]]
    for tracks, (ms, _) in bucket_times.items():
        b_ms, b_by = receiver_buckets_bound(tracks, FDTD_MAIN[0])
        print(f"time fdtd3d_receiver_buckets {tracks} tracks: {ms * 1e3:.2f}"
              f" us against its bound {b_ms * 1e3:.4f} us ({b_by}), "
              f"{ms / fdtd_times['fdtd3d_field'][0]:.3%} of the field "
              f"kernel's block at room {FDTD_MAIN[0]}")
    for key in (FDTD_FIELD_82_KEY, FDTD_BIG_KEY):
        b_ms, b_by = fdtd_bounds()[key]
        print(f"time {key}: {fdtd_times[key][0]:.4f} ms against its bound "
              f"{b_ms:.4f} ms ({b_by}), {b_ms / fdtd_times[key][0]:.2%}")
    print(f"fdtd kernels vs twins: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with dispatched:
        sol_err = compare_sol(torch, sops, device)
    sol_times = time_sol(torch, sops, device)
    print(f"speed-of-light kernels vs twin: {time.perf_counter() - t0:.1f} s")
    missing = sorted(set(gpuab.OPS) - set(dispatched.seen))
    if missing:
        fail(f"the kernel-vs-twin phases reached no {missing} operator")
    print("kernels vs twins through torch.ops.gpuab: "
          + ", ".join(f"{k} {dispatched.seen[k]}" for k in gpuab.OPS))

    # Phase 20's exports compile from here on, beside phases 10-19.
    exports = NativeExports()

    card = torch.cuda.get_device_name(0)
    _, peak_source = roofline.resolve_peaks(card)
    print(f"roofline peaks for {card}: {peak_source}")

    # Main paths: every count is reset just before each path and read
    # just after; no plain twin may run in any of them.
    modules = (ops, iops, cops, rops, dops, fops, sops)

    def counts():
        return launch_counts(*modules)

    def reset():
        reset_counts(*modules)

    launches = {k: 0 for k in counts()}
    with TwinCalls({"modal": ops, "iir": iops, "conv": cops, "rndmem": rops,
                    "dwg": dops, "fdtd": fops, "sol": sops}) as twins:
        reset()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = bench.main()
        wall = time.perf_counter() - t0
        launches["modal_bank"] = counts()["modal_bank"]
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
        if rec["kernel_launches"] != launches["modal_bank"]:
            fail(f"bench reports {rec['kernel_launches']} launches, the "
                 f"counts {launches['modal_bank']}")
        if rec.get("chain_form") != "cuda-graph":
            fail(f"bench: chain form {rec.get('chain_form')!r}")
        bench_rec = rec
        print(f"main path: {wall:.1f} s, {launches['modal_bank']} kernel "
              f"launches ({hgraph.REPLAYED_LAUNCHES['modal_bank']} of them "
              f"in {hgraph.CHAIN_REPLAYS['chain']} chain graph replays), "
              "validation passed")

        reset()
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
            reset()
            for k, n in cli_path(torch, cli, counts, label, argv,
                                 kernels)[0].items():
                launches[k] += n
                if n and k in CLI_ABSENT.get(label, ()):
                    fail(f"{label}: {k} launched {n} times")

        # Pinned staging, DAW-sim pacing and the overlapped-infeed tier.
        t0 = time.perf_counter()
        p50_0199 = datacopy_phase(cli)
        dawsim_phase(cli, counts, reset, launches, p50_0199)
        overlap_phase(cli, counts, reset, launches)
        overlap_check(torch, registry, config, overlap, device)
        print(f"pinned staging, DAW-sim and overlap: "
              f"{time.perf_counter() - t0:.1f} s")

        # PartConv, DAWSessionMix, the CSV writer, the sync-free chains.
        t0 = time.perf_counter()
        session_phase(torch, cli, output, registry, config, models_session,
                      hgraph, counts, reset, launches, device)
        print(f"PartConv, DAWSessionMix and CSV: "
              f"{time.perf_counter() - t0:.1f} s")

        # NeuralAmp and NeuralAmpLSTM.
        t0 = time.perf_counter()
        neural_phase(torch, cli, registry, config, overlap, roofline, na,
                     counts, reset, device)
        print(f"NeuralAmp and NeuralAmpLSTM: "
              f"{time.perf_counter() - t0:.1f} s")

        # The chain as one CUDA graph against the loop.
        t0 = time.perf_counter()
        graph_phase(torch, registry, config, hgraph, streaming, device)
        lstm_nested_capture(torch, registry, config, hgraph, streaming,
                            device)
        print(f"chain graphs against loops: {time.perf_counter() - t0:.1f} s")

        # The surfaces above the harness.
        t0 = time.perf_counter()
        surfaces_phase(torch, tools, checkpoint, webui_server, output,
                       registry, config, hgraph, counts, reset, launches,
                       device, smi)
        print(f"soaks, continuity, capacity, overlap64 and web UI: "
              f"{time.perf_counter() - t0:.1f} s")

        # The multi-device layer on one card.
        t0 = time.perf_counter()
        multichip_phase(torch, cli, registry, config, counts, reset,
                        launches, smi, fops, na, pc, ranks, device)
        print(f"NCCL, MultiChipSuite, ICIBandwidth and the sharded blocks: "
              f"{time.perf_counter() - t0:.1f} s")

        # --dataParallel on one card.
        t0 = time.perf_counter()
        data_parallel_phase(torch, cli, counts, reset, launches, smi,
                            dp_job)
        print(f"--dataParallel: {time.perf_counter() - t0:.1f} s")

        # The repo-level surfaces: campaigns, results tools, examples.
        t0 = time.perf_counter()
        surfaces_port_phase(torch, counts, reset, launches, smi)
        print(f"campaigns, results tools and examples: "
              f"{time.perf_counter() - t0:.1f} s")

        # The last repo-level surfaces: the native driver, the generated
        # artifacts and docs, the overlap, latency and mesh campaigns.
        t0 = time.perf_counter()
        last_surfaces_phase(torch, cli, output, counts, reset, launches, smi,
                            bench_rec)
        print(f"native driver, artifacts and campaigns: "
              f"{time.perf_counter() - t0:.1f} s")

        # The eight exported programs through the native runner.
        t0 = time.perf_counter()
        native_phase(torch, counts, reset, launches, runner_job, bench_rec,
                     smi, exports)
        print(f"native runner: {time.perf_counter() - t0:.1f} s")

        # A step of each operator of item 21b, exported and run on the card.
        t0 = time.perf_counter()
        export_ops_phase(torch, ops, iops, rops, dops, fops, sops, device)
        print(f"exported operator steps: {time.perf_counter() - t0:.1f} s")
        if twins.calls:
            fail(f"a plain twin ran {twins.calls} times on the main paths")

    t0 = time.perf_counter()
    calibrate(calibrate_peaks, roofline, card)
    print(f"calibration: {time.perf_counter() - t0:.1f} s")

    # The profiler sessions come last: nothing is timed after one.
    t0 = time.perf_counter()
    with TwinCalls({"modal": ops}) as twins:
        capture_run(torch, cli, hprofiler, counts, reset, launches)
    if twins.calls:
        fail(f"a plain twin ran {twins.calls} times on the --capture path")
    print(f"--capture run: {time.perf_counter() - t0:.1f} s")

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
