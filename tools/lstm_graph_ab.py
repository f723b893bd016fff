"""The NeuralAmpLSTM block eagerly and as CUDA graphs, in one process.

    python3 tools/lstm_graph_ab.py [--tracks 128] [--graphs 4]

For f32 and bf16 at ``--tracks`` x 512 samples, H = 128 (the JAX
package's defaults), from the state after one block, prints:

* the CUDA-event time of one eager ``ops.neuralamp.lstm_block`` (the host
  enqueues its ~3,600 launches) and its host wall;
* for each of ``--graphs`` graphs of the same block captured one after
  another (``ops.neuralamp.lstm_runner``), the time of a replay back to
  back (10 replays a rep, median of 5) and behind a ~1 ms spin (the
  device tier's way), and whether its outputs are the eager block's bit
  for bit;
* the benchmark's own device tier, the way the runner takes it;
* after every timing, the GEMM kernels of one call of each of those
  (``torch.profiler``), with their device time: graphs of one function
  that read apart would show whether cuBLAS picked another GEMM at
  capture.

Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402
from gpuaudiobench_tpu_torch.config import BenchConfig  # noqa: E402
from gpuaudiobench_tpu_torch.harness.device_timing import (  # noqa: E402
    event_device_times,
)
from gpuaudiobench_tpu_torch.models.neuralamp import (  # noqa: E402
    NeuralAmpBenchmark,
)
from gpuaudiobench_tpu_torch.ops import neuralamp as na  # noqa: E402
from gpuaudiobench_tpu_torch.utils import device as dev  # noqa: E402


def gemm_kernels(run):
    """{kernel name: device µs} of the GEMM kernels of one call of run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if "CUDA" in str(getattr(e, "device_type", "")) and any(
                k in e.name for k in ("gemm", "nvjet", "xmma", "gemv")):
            name = e.name[:70]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us()
    return {k: round(v, 1) for k, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tracks", type=int, default=128)
    ap.add_argument("--graphs", type=int, default=4)
    args = ap.parse_args()
    device = dev.device("cuda")
    print(f"card: {dev.nvidia_smi('name,power.limit')}")
    kept = []
    # Every timing first: a profiler session slows the process's later
    # launches (PERF.md).
    for dtype in ("f32", "bf16"):
        cfg = BenchConfig(n_tracks=args.tracks, verification="none",
                          device_timing=False, neuralamp_dtype=dtype)
        b = NeuralAmpBenchmark(cfg, device, "lstm")
        b.setup()
        x = b._resident_input
        h, c = (t.clone() for t in b._state)

        def eager(b=b, x=x, h=h, c=c, dtype=dtype):
            return na.lstm_block(x, h, c, b._params, dtype)

        want = eager()
        eager_ms = cs.median_ms(torch, eager, 3, 1)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            eager()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"{dtype} eager: {eager_ms:.4f} ms (CUDA events), host wall "
              f"{statistics.median(walls):.4f} ms")
        kept.append((f"{dtype} eager", eager))
        for g in range(args.graphs):
            run = na.lstm_runner(b._params, dtype, x, h, c)
            same = all(torch.equal(a, e) for a, e in zip(run(x, h, c), want))
            back = cs.median_ms(torch, run, 5, 10)
            spun = statistics.median(event_device_times(run, 5))
            print(f"{dtype} graph {g}: replay {back:.4f} ms back to back, "
                  f"{spun:.4f} behind a spin, bit for bit the eager block: "
                  f"{same}")
            kept.append((f"{dtype} graph {g}", run))
        tier = statistics.median(event_device_times(b.device_iterate, 10))
        print(f"{dtype} device tier: {tier:.4f} ms")
        kept.append((f"{dtype} device tier", b.device_iterate))
    for label, fn in kept:
        print(f"{label}: GEMMs {gemm_kernels(fn)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
