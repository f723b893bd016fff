"""Where the time of one block of a ported benchmark goes, on one GPU.

    python -m gpuaudiobench_tpu_torch.profile_block
    python -m gpuaudiobench_tpu_torch.profile_block --benchmark IIRFilter \
        --nTracks 65536 [--iirForm blockstate]
    python -m gpuaudiobench_tpu_torch.profile_block --benchmark Conv1D \
        --nTracks 19456
    python -m gpuaudiobench_tpu_torch.profile_block --benchmark FDTD3D \
        --nTracks 128 --depth 64
    python -m gpuaudiobench_tpu_torch.profile_block --benchmark DWG1DNaive \
        --nTracks 32768 --depth 256
    python -m gpuaudiobench_tpu_torch.profile_block --benchmark PartConv \
        --nTracks 1536 --depth 64 [--partconvForm ring]
    python -m gpuaudiobench_tpu_torch.profile_block --benchmark DAWSessionMix \
        --nTracks 65536 --depth 256
    python -m gpuaudiobench_tpu_torch.profile_block --benchmark NeuralAmp \
        --nTracks 128 --depth 64 [--neuralampDtype bf16]
    python -m gpuaudiobench_tpu_torch.profile_block --benchmark NeuralAmpLSTM \
        --nTracks 128 --depth 16

With no arguments it profiles the main cell of ``bench`` (ModalFilterBank,
1,048,576 modes, 512-sample blocks, 32 tracks). The flags are the CLI's
(``--benchmark``, ``--nTracks``, ``--bufferSize``, ``--iirForm``,
``--iirBlockM``, ``--modalModes``, ``--irLength``, ``--convEdgeMode``,
``--fdtdRoom``, ``--partconvForm``, ``--partconvTailChunk``,
``--partconvHDtype``, ``--sessionEqStages``, ``--neuralampChannels``,
``--neuralampLayers``, ``--neuralampDtype``), and ``--depth`` (default
2,048) sets the chain depth,
which the slow blocks need cut: any ported benchmark
with a stream body can be profiled (RndMemRead, DWG1DNaive, DWG1DAccel
and FDTD3D among them; FDTD3D with the divergence kernel, the CLI's
default). Validation is off, so the host golden is skipped (FDTD3D still
computes its golden at setup). Prints one JSON line with:

* ``card``: nvidia-smi's name and power limit, and its SM clock and power
  draw sampled while a long chain of blocks runs;
* ``chain_wall_ms_per_block``: the unprofiled wall per block of a
  ``--depth``-block chain (median of 3), as the saturated tier times it;
* ``roundtrip_wall_ms``: the unprofiled wall of one round trip
  (``iterate()``: upload, kernels, copy back), median of ``ROUNDTRIPS``;
* ``chain`` and ``roundtrip``: per-kernel and per-copy device time per
  block from ``torch.profiler`` over ``TRACE_BLOCKS`` chained blocks and
  over ``ROUNDTRIPS`` round trips, the device-busy time per block (the
  union of the kernels' and copies' intervals), and the device's idle
  share of the traced window (first device event to last);
* ``device_tier``: the device tier's p50 of ``device_iterate()`` (CUDA
  events behind the spin, as the runner takes it), the same event pair
  without the spin (which also times the host's enqueue), and the
  profiler's device time per call of ``device_iterate()``: the gated p50
  should match the last.

Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import json
import statistics
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.device_timing import (
    MAX_RUNS,
    event_device_times,
)
from gpuaudiobench_tpu_torch.harness.streaming import run_chained
from gpuaudiobench_tpu_torch.registry import create_benchmark
from gpuaudiobench_tpu_torch.utils import device as dev

DEPTH = 2048
TRACE_BLOCKS = 128
ROUNDTRIPS = 20


def _sample_under_load(step, carry, blocks: int, delay_s: float) -> str:
    """SM clock and power draw, read by nvidia-smi from another thread
    ``delay_s`` into a chain of ``blocks`` blocks."""
    reading: List[str] = []

    def sample():
        time.sleep(delay_s)
        reading.append(dev.nvidia_smi("clocks.sm,power.draw"))

    th = threading.Thread(target=sample)
    th.start()
    run_chained(step, carry, blocks)
    th.join()
    return reading[0]


def _device_events(prof) -> List[Tuple[str, float, float]]:
    """(name, start_us, end_us) of every event the profiler saw on the
    device (kernels and copies)."""
    out = []
    for e in prof.events():
        if "CUDA" in str(getattr(e, "device_type", "")):
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _summarize(events, blocks: int) -> Dict[str, object]:
    if not events:
        return {"error": "the profiler saw no device time"}
    per_kernel: Dict[str, float] = {}
    for name, a, b in events:
        per_kernel[name] = per_kernel.get(name, 0.0) + (b - a)
    busy, cur_a, cur_b = 0.0, None, None
    for _, a, b in sorted(events, key=lambda x: x[1]):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    window = max(b for _, _, b in events) - min(a for _, a, _ in events)
    return {
        "blocks": blocks,
        "kernel_us_per_block": {
            k: v / blocks for k, v in sorted(per_kernel.items(),
                                             key=lambda kv: -kv[1])},
        "device_busy_us_per_block": busy / blocks,
        "window_us_per_block": window / blocks,
        "device_idle_share": 1.0 - busy / window if window > 0 else 0.0,
    }


def device_tier(bench, runs: int = MAX_RUNS) -> Dict[str, float]:
    """The device tier's p50 of ``bench.device_iterate()`` with and
    without the spin, and the profiler's device time (kernels and copies)
    per call over ``runs`` calls."""
    from torch.profiler import ProfilerActivity, profile

    gated = statistics.median(event_device_times(bench.device_iterate, runs))
    ungated = statistics.median(
        event_device_times(bench.device_iterate, runs, spin_ms=0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            bench.device_iterate()
        torch.cuda.synchronize()
    events = _device_events(prof)
    if not events:
        raise RuntimeError("the profiler saw no device time")
    return {"gated_p50_ms": gated, "ungated_p50_ms": ungated,
            "profiler_ms_per_call": sum(b - a for _, a, b in events)
            / runs / 1e3}


FLAGS = {
    "--benchmark": ("benchmark", str),
    "--nTracks": ("n_tracks", int),
    "--bufferSize": ("buffer_size", int),
    "--iirForm": ("iir_form", str),
    "--iirBlockM": ("iir_block_m", int),
    "--modalModes": ("modal_num_modes", int),
    "--irLength": ("ir_length", int),
    "--convEdgeMode": ("conv_edge_mode", str),
    "--fdtdRoom": ("fdtd_room", int),
    "--partconvForm": ("partconv_form", str),
    "--partconvTailChunk": ("partconv_tail_chunk", int),
    "--partconvHDtype": ("partconv_h_dtype", str),
    "--sessionEqStages": ("session_eq_stages", int),
    "--neuralampChannels": ("neuralamp_channels", int),
    "--neuralampLayers": ("neuralamp_layers", int),
    "--neuralampDtype": ("neuralamp_dtype", str),
    "--depth": ("depth", int),
}


def _parse(argv: List[str]) -> Tuple[str, BenchConfig, int]:
    knobs = {"benchmark": "ModalFilterBank", "n_tracks": 1024,
             "depth": DEPTH}
    if len(argv) % 2 or any(a not in FLAGS for a in argv[::2]):
        raise SystemExit(f"usage: profile_block [{' N] ['.join(FLAGS)} N]")
    for flag, value in zip(argv[::2], argv[1::2]):
        key, typ = FLAGS[flag]
        knobs[key] = typ(value)
    name = knobs.pop("benchmark")
    depth = knobs.pop("depth")
    if depth < 16:
        raise SystemExit("profile_block: --depth must be at least 16")
    cfg = BenchConfig(verification="none", device_timing=False, **knobs)
    cfg.validate()
    return name, cfg, depth


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    from torch.profiler import ProfilerActivity, profile

    name, cfg, depth = _parse(sys.argv[1:] if argv is None else argv)
    device = dev.device("cuda")
    bench = create_benchmark(name, cfg, device)
    bench.setup()  # builds the kernels and runs one round trip
    step, carry = bench.stream_body()
    run_chained(step, carry, 16)

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_chained(step, carry, depth)
        walls.append((time.perf_counter() - t0) * 1000.0 / depth)
    under_load = _sample_under_load(step, carry, 4 * depth, 1.0)
    trips = []
    for _ in range(ROUNDTRIPS):
        t0 = time.perf_counter()
        bench.iterate()
        trips.append((time.perf_counter() - t0) * 1000.0)

    trace_blocks = min(TRACE_BLOCKS, depth)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_chained(step, carry, trace_blocks)
    chain = _summarize(_device_events(prof), trace_blocks)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ROUNDTRIPS):
            bench.iterate()
    roundtrip = _summarize(_device_events(prof), ROUNDTRIPS)
    tier = device_tier(bench)

    print(json.dumps({
        "benchmark": name,
        "n_tracks": cfg.n_tracks,
        "card": {"name_power_limit": dev.nvidia_smi("name,power.limit"),
                 "sm_clock_power_draw_under_load": under_load},
        "depth": depth,
        "chain_wall_ms_per_block": statistics.median(walls),
        "chain_wall_ms_per_block_reps": walls,
        "roundtrip_wall_ms": statistics.median(trips),
        "chain": chain,
        "roundtrip": roundtrip,
        "device_tier": tier,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
