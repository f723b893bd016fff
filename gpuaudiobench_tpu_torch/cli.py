"""Command-line interface of the PyTorch port.

    python -m gpuaudiobench_tpu_torch.cli --benchmark IIRFilter --nTracks 65536 \\
        --pipelineDepth 512 --json

A cut-down counterpart of ``gpuaudiobench_tpu/cli.py`` with the same
``parse_args`` / ``run`` / ``main`` shape and the flags the ported
benchmarks and tiers read, DAW-sim pacing (``--dawsim``,
``--dawsim-mode``, ``--dawsim-jitter-us``), the overlapped-infeed tier
(``--overlapDepth``, ``--overlapReps``), the datacopy pool
(``--transferMiB``), PartConv's, DAWSessionMix's and NeuralAmp's knobs
and the output flags (``--csvSchema``, ``--latenciesFile``,
``--category``) among them.
Without ``--json`` each benchmark's summary is printed, then its latency
file and, with ``--outputfile``, its CSV row are written; with ``--json``
the JSON goes to ``--outputfile`` or stdout. A flag the reference knows
but the port has not ported yet exits 1 with a message that names its
ROADMAP item, as does a ``--category`` that holds a benchmark still to
be ported. The run is on the GPU: ``main(argv)`` takes
``device="cuda"``; only a caller that passes ``device="cpu"`` (the
tests) gets the CPU. A benchmark that raises is reported and the suite
goes on, but the exit code is 1.
"""

from __future__ import annotations

import json
import sys
import traceback
from typing import List, Optional

from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.registry import (
    BENCHMARK_DESCRIPTIONS,
    BENCHMARK_NAMES,
    CATEGORIES,
    EXTENSION_NAMES,
    UNPORTED_BENCHMARKS,
    create_benchmark,
    list_benchmarks,
    ported_benchmarks,
)

DEFAULT_BENCHMARK = "RndMemRead"  # cuda/main.cu:239

VALUE_FLAGS = {
    "--benchmark": ("benchmark", str),
    "--category": ("category", str),
    "--fs": ("fs", int),
    "--bufferSize": ("buffer_size", int),
    "--nTracks": ("n_tracks", int),
    "--nRuns": ("n_runs", int),
    "--warmup": ("warmup", int),
    "--outputfile": ("output_file", str),
    "--verification": ("verification", str),
    "--dawsim-mode": ("dawsim_mode", str),
    "--dawsim-jitter-us": ("dawsim_jitter_us", float),
    "--impl": ("impl", str),
    "--iirForm": ("iir_form", str),
    "--iirBlockM": ("iir_block_m", int),
    "--modalModes": ("modal_num_modes", int),
    "--irLength": ("ir_length", int),
    "--convEdgeMode": ("conv_edge_mode", str),
    "--partconvForm": ("partconv_form", str),
    "--partconvTailChunk": ("partconv_tail_chunk", int),
    "--partconvHDtype": ("partconv_h_dtype", str),
    "--sessionEqStages": ("session_eq_stages", int),
    "--neuralampChannels": ("neuralamp_channels", int),
    "--neuralampLayers": ("neuralamp_layers", int),
    "--neuralampDtype": ("neuralamp_dtype", str),
    "--csvSchema": ("csv_schema", str),
    "--latenciesFile": ("latencies_file", str),
    "--poolMiB": ("rndmem_pool_mb", int),
    "--transferMiB": ("transfer_mib", int),
    "--dwgMinLen": ("dwg_min_length", int),
    "--dwgMaxLen": ("dwg_max_length", int),
    "--fdtdRoom": ("fdtd_room", int),
    "--solFmaK": ("sol_fma_k", int),
    "--solFmaMiB": ("sol_fma_mib", int),
    "--solVmemMiB": ("sol_vmem_mib", int),
    "--solStreamMiB": ("sol_stream_mib", int),
    "--solMatmulDim": ("sol_matmul_dim", int),
    "--pipelineDepth": ("pipeline_depth", int),
    "--saturatedReps": ("saturated_reps", int),
    "--overlapDepth": ("overlap_depth", int),
    "--overlapReps": ("overlap_reps", int),
    "--seed": ("seed", int),
}
SWITCHES = {
    "--json": ("json_output", True),
    "--quiet": ("quiet", True),
    "--dawsim": ("dawsim", True),
    "--no-device-timing": ("device_timing", False),
    "--noSaturatedMarginal": ("saturated_marginal", False),
    "--modalRenorm": ("modal_renorm", True),
    "--fdtdPerTrackReceivers": ("fdtd_per_track_receivers", True),
}
# Flags of the reference's CLI that the port has not ported, with the
# ROADMAP.md item that ports them.
UNPORTED_FLAGS = {
    "--capture": "queue 1, item 4",
    "--captureDir": "queue 1, item 4",
    "--dataParallel": "queue 1, item 18",
    "--mesh": "queue 1, item 18",
    "--compilationCacheDir": "'Not ported' (XLA only)",
    "--no-compilationCache": "'Not ported' (XLA only)",
}


def print_help() -> None:
    print("GPU Audio Benchmark Suite, PyTorch / CUDA port")
    print("==============================================")
    print("Real-time GPU audio processing benchmarks\n")
    print("Usage: python -m gpuaudiobench_tpu_torch.cli [options]\n")
    print("Options:")
    print("  --help                   Print this help message")
    print("  --list                   List all benchmark names")
    print("  --benchmark [name]       Run specific benchmark (see list below)")
    print("  --benchmarkFilter [pat]  Run all benchmarks matching substring or /regex/")
    print("                           (repeatable / comma separated)")
    print("  --category [name]        Run a suite category: "
          + " | ".join(CATEGORIES))
    print("  --fs [rate]              Set sampling rate (default: 48000)")
    print("  --bufferSize [size]      Set buffer size (default: 512)")
    print("  --nTracks [count]        Set number of tracks (default: 128)")
    print("  --nRuns [count]          Set number of iterations (default: 100)")
    print("  --warmup [count]         Set warmup iterations (default: 3)")
    print("  --json                   Output results in JSON format")
    print("  --outputfile [file]      Save results to CSV file (with --json:")
    print("                           write the JSON to the file)")
    print("  --csvSchema [s]          cuda (default) | metal CSV column set")
    print("  --latenciesFile [file]   Raw latency dump (default: "
          "<temp dir>/<name>_latencies.txt)")
    print("  --verification [mode]    none | spot | full (default: full)")
    print("  --dawsim                 Pace iterations at the audio buffer rate")
    print("  --dawsim-mode [mode]     spin | sleep (default: spin)")
    print("  --dawsim-jitter-us [us]  Schedule jitter in microseconds")
    print("  --impl [which]           auto | pallas (the CUDA kernel) | xla")
    print("                           (the plain twin; refused on the GPU)")
    print("  --iirForm [f]            scan | blockstate (IIRFilter "
          "recurrence form; default scan)")
    print("  --iirBlockM [m]          blockstate samples per step (default 0 "
          "= auto: 128 on the kernel, clamped to a bufferSize divisor)")
    print("  --modalModes [n]         ModalFilterBank mode count")
    print("  --irLength [n]           IR length: Conv1D / Conv1D_accel "
          "(default 1024 / 512), PartConv and DAWSessionMix (48000)")
    print("  --convEdgeMode [m]       clamp | bleed (Conv1D window before "
          "a track's start; default clamp)")
    print("  --partconvForm [f]       shift | ring | nupols (PartConv "
          "FDL form; default shift)")
    print("  --partconvTailChunk [k]  nupols tail partition size in "
          "blocks (default 8)")
    print("  --partconvHDtype [d]     f32 | f16 (PartConv IR-spectra storage)")
    print("  --sessionEqStages [k]    DAWSessionMix per-track EQ cascade "
          "depth (default: 4)")
    print("  --neuralampChannels [n]  NeuralAmp TCN channel count / LSTM "
          "hidden size (default: 128)")
    print("  --neuralampLayers [n]    NeuralAmp dilated-layer count (default: 10)")
    print("  --neuralampDtype [d]     f32 | bf16 | int8 (NeuralAmp GEMM dtype; "
          "int8 TCN-only)")
    print("  --poolMiB [n]            RndMemRead pool size (default: 512)")
    print("  --transferMiB [n]        datacopy* pool size (default: 10)")
    print("  --dwgMinLen/--dwgMaxLen [n]  DWG delay-line length range")
    print("                           (CUDA default 100-2000; Metal used 64-1024)")
    print("  --fdtdRoom [n]           FDTD3D room cells per axis "
          "(default 50, 8-128; grid = n+2)")
    print("  --fdtdPerTrackReceivers  FDTD3D: one receiver cell per track")
    print("                           (WebGPU parity; default: broadcast)")
    print("  --solMatmulDim [n]       SOL_MXU_* matmul dimension (default: 4096)")
    print("  --solStreamMiB [n]       SOL_HBM stream size (default: 64)")
    print("  --solFmaK [n]            SOL_VPU / SOL_VMEM FMA passes (default: 512)")
    print("  --solFmaMiB [n]          SOL_VPU working set (default: 8)")
    print("  --solVmemMiB [n]         SOL_VMEM working set (default: 2)")
    print("  --modalRenorm            Streaming: renormalize phasor magnitudes")
    print("  --pipelineDepth [n]      Also measure saturated throughput:")
    print("                           n chained blocks, state carried")
    print("  --saturatedReps [n]      Saturated-tier repetitions (default: 21)")
    print("  --noSaturatedMarginal    Skip the depth-differenced marginal tier")
    print("  --overlapDepth [n]       Also measure overlapped infeed: upload")
    print("                           block k+1 while block k computes, vs")
    print("                           the serial twin (n blocks per rep)")
    print("  --overlapReps [n]        Overlap-tier repetitions (default: 5)")
    print("  --seed [n]               Test-data seed (default: 42)")
    print("  --no-device-timing       Skip the device tier (CUDA events)")
    print("  --quiet                  Suppress progress output (results only)")
    print()
    print("Benchmarks (* = ported; the rest exit 1, see ROADMAP.md):")
    ported = ported_benchmarks()
    for name in list_benchmarks():
        mark = "*" if name in ported else " "
        print(f" {mark}{name:<16} - {BENCHMARK_DESCRIPTIONS[name]}")
    print()
    print("Examples:")
    print("  python -m gpuaudiobench_tpu_torch.cli --benchmark IIRFilter "
          "--nTracks 65536 --pipelineDepth 512 --json")
    print("  python -m gpuaudiobench_tpu_torch.cli --benchmark BiquadChain")
    print("  python -m gpuaudiobench_tpu_torch.cli --benchmark Conv1D "
          "--nTracks 19456 --pipelineDepth 512 --json")
    print("  python -m gpuaudiobench_tpu_torch.cli --benchmark FDTD3D "
          "--fdtdRoom 50 --pipelineDepth 32 --json")
    print("  python -m gpuaudiobench_tpu_torch.cli --benchmark SOL_VPU --json")
    print("  python -m gpuaudiobench_tpu_torch.cli --benchmark datacopy0199 "
          "--transferMiB 100 --dawsim --json")
    print("  python -m gpuaudiobench_tpu_torch.cli --benchmark IIRFilter "
          "--nTracks 65536 --overlapDepth 32 --json")
    print("  python -m gpuaudiobench_tpu_torch.cli --benchmark PartConv "
          "--nTracks 1536 --partconvForm nupols --outputfile r.csv")
    print("  python -m gpuaudiobench_tpu_torch.cli --benchmark DAWSessionMix "
          "--nTracks 65536 --verification spot --json")
    print("  python -m gpuaudiobench_tpu_torch.cli --benchmark NeuralAmp "
          "--neuralampDtype bf16 --json")
    print("  python -m gpuaudiobench_tpu_torch.cli --category neural "
          "--pipelineDepth 16 --json")
    print("  python -m gpuaudiobench_tpu_torch.cli    (RndMemRead, 128 tracks)")


def print_list() -> None:
    print("Available benchmarks:")
    for name in list_benchmarks():
        print(name)


def matches_filter(name: str, patterns: List[str]) -> bool:
    """The reference's filter tiers: /regex/, =exact, else substring,
    all case-insensitive (``gpuaudiobench_tpu/config.py:287``)."""
    import re

    for pat in patterns:
        if len(pat) > 2 and pat.startswith("/") and pat.endswith("/"):
            try:
                if re.search(pat[1:-1], name, flags=re.IGNORECASE):
                    return True
            except re.error as e:
                print(f"Invalid regex pattern: {pat} -> {e}")
        elif pat.startswith("=") and len(pat) > 1:
            if pat[1:].lower() == name.lower():
                return True
        elif pat.lower() in name.lower():
            return True
    return False


def parse_args(argv: List[str]):
    """Returns (cfg, benchmark_names, error_message)."""
    benchmark: Optional[str] = None
    filters: List[str] = []
    categories: List[str] = []
    updates = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--help":
            return None, ["--help"], None
        if arg == "--list":
            return None, ["--list"], None
        if arg in SWITCHES:
            key, val = SWITCHES[arg]
            updates[key] = val
        elif arg in UNPORTED_FLAGS:
            return None, [], (
                f"Error: {arg} is not ported to the PyTorch CLI yet; see "
                f"ROADMAP.md {UNPORTED_FLAGS[arg]}")
        elif arg == "--benchmarkFilter" or arg in VALUE_FLAGS:
            if i + 1 >= len(argv):
                return None, [], f"Error: {arg} requires an argument"
            i += 1
            v = argv[i]
            if arg == "--benchmarkFilter":
                filters.extend(p for p in v.split(",") if p)
            else:
                key, typ = VALUE_FLAGS[arg]
                try:
                    val = typ(v)
                except ValueError:
                    return None, [], f"Error: invalid value for {arg}: {v}"
                if key == "benchmark":
                    benchmark = val
                elif key == "category":
                    if val not in CATEGORIES:
                        return None, [], (
                            f"Error: unknown category '{val}' "
                            f"(choose from {', '.join(CATEGORIES)})")
                    unported = [n for n in CATEGORIES[val]
                                if n in UNPORTED_BENCHMARKS]
                    if unported:
                        items = sorted({UNPORTED_BENCHMARKS[n]
                                        for n in unported})
                        return None, [], (
                            f"Error: --category {val} holds "
                            f"{', '.join(unported)}, not ported to the "
                            f"PyTorch CLI yet; see ROADMAP.md "
                            f"{'; '.join(items)}")
                    categories.extend(CATEGORIES[val])
                else:
                    updates[key] = val
        else:
            return None, [], f"Error: unknown argument: {arg} (see --help)"
        i += 1

    cfg = BenchConfig().replace(**updates)
    try:
        cfg.validate()
    except ValueError as e:
        return None, [], f"Error: {e}"

    if filters or categories:
        names = [n for n in BENCHMARK_NAMES + EXTENSION_NAMES
                 if (filters and matches_filter(n, filters))
                 or n in categories]
        if benchmark and benchmark not in names:
            names.append(benchmark)
        if not names:
            return None, [], "Error: no benchmarks match the given filter"
    else:
        names = [benchmark or DEFAULT_BENCHMARK]
    return cfg, names, None


def run(cfg: BenchConfig, names: List[str], device: str = "cuda") -> int:
    from gpuaudiobench_tpu_torch.harness.output import (
        generate_json_results,
        print_results,
        write_csv_results,
        write_latencies_file,
    )
    from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
    from gpuaudiobench_tpu_torch.utils import device as dev

    torch_dev = dev.device(device)
    ident = dev.gpu_identity(torch_dev)
    print("GPU Audio Benchmark (PyTorch port)")
    print(f"Device: {ident['device_name']} [{torch_dev.type}], "
          f"power limit {ident['power_limit']}")

    exit_code = 0
    json_results = []
    for name in names:
        try:
            bench = create_benchmark(name, cfg, torch_dev)
        except KeyError:
            print(f"Error: Unknown benchmark '{name}'")
            print("Use --list to see available benchmarks.")
            return 1
        except (NotImplementedError, ValueError) as e:
            print(f"Benchmark {name} failed: {e}")
            exit_code = 1
            continue
        # One failing benchmark does not stop the suite, but the run
        # exits 1 (main.swift:261-341).
        try:
            if not cfg.quiet:
                print(f"Setting up {name} benchmark...")
            bench.setup()
            if not cfg.quiet:
                print(f"Running {name} benchmark ({cfg.n_runs} iterations "
                      f"with {cfg.warmup} warmup)...")
            result = run_benchmark(bench, cfg, verbose=not cfg.quiet)
            if result.validation is not None and not result.validation.passed:
                exit_code = 1
            if cfg.json_output:
                json_results.append(
                    generate_json_results(result, cfg, torch_dev))
            else:
                print_results(result, cfg)
                if cfg.write_latencies:
                    write_latencies_file(result, cfg.latencies_file)
                if cfg.output_file:
                    write_csv_results(result, cfg, cfg.output_file,
                                      torch_dev)
            if result.deadline_miss_rate:
                print(f"WARNING: {name} missed "
                      f"{result.deadline_miss_rate:.1f}% of buffer "
                      "deadlines under DAW pacing")
            bench.cleanup()
        except Exception as e:  # noqa: BLE001 - suite resilience
            traceback.print_exc()
            print(f"Benchmark {name} failed: {type(e).__name__}: {e}")
            exit_code = 1

    if cfg.json_output and json_results:
        payload = json.dumps(
            json_results[0] if len(json_results) == 1 else json_results,
            indent=2)
        if cfg.output_file:
            with open(cfg.output_file, "w") as f:
                f.write(payload)
            print(f"JSON results saved to: {cfg.output_file}")
        else:
            print(payload)
    print("Done")
    return exit_code


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg, names, err = parse_args(argv)
    if err:
        print(err)
        return 1
    if names == ["--help"]:
        print_help()
        return 0
    if names == ["--list"]:
        print_list()
        return 0
    return run(cfg, names, device)


if __name__ == "__main__":
    sys.exit(main())
