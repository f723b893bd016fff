"""The saturated chain as one CUDA graph against the loop, with idle shares.

    python3 tools/chain_graph_ab.py [--reps 7]

On the paths of the graph-against-loop table (``AB_PATHS``: the modal
headline cell, IIRFilter at 65,536 tracks, DWG1DNaive at 32,768
waveguides, DAWSessionMix at 65,536 strips and at 16 stages x 128), each
at its ``chip_smoke.py`` phase-14 depth, prints:

* both forms' saturated and marginal p50 a block, timed in turns
  (``--reps`` reps of depth // 4 and depth, the order of the two forms
  alternating), as phase 14 times them;
* for one chain of each form at depth // 4 under ``torch.profiler``
  (after all the timing: a session slows later launches), the device's
  busy time a block and idle share of the window from its first device
  event to its last (``harness.profiler.summarize``), and its largest
  kernels;

and the card's name and power limit. Needs one CUDA device.
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
from gpuaudiobench_tpu_torch import registry  # noqa: E402
from gpuaudiobench_tpu_torch.config import BenchConfig  # noqa: E402
from gpuaudiobench_tpu_torch.harness import profiler, streaming  # noqa: E402
from gpuaudiobench_tpu_torch.utils import device as dev  # noqa: E402

AB_PATHS = [p for p in cs.GRAPH_PATHS
            if p[1] in ("ModalFilterBank", "IIRFilter", "DWG1DNaive",
                        "DAWSessionMix")]
FORMS = ("loop", "cuda-graph")


def main() -> int:
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    device = dev.device("cuda")
    print(dev.nvidia_smi("name,power.limit"), flush=True)
    kept = []
    for label, name, knobs, depth in AB_PATHS:
        cfg = BenchConfig(verification="none", device_timing=False, **knobs)
        b = registry.create_benchmark(name, cfg, device)
        b.setup()
        step, carry = b.stream_body()
        lo = max(1, depth // 4)
        runs = {form: dict(zip((lo, depth), streaming.chains(
            step, cs.clone_carry(torch, carry), [lo, depth], form, label)))
            for form in FORMS}
        for form in FORMS:
            for run in runs[form].values():
                run()
        walls = {f: {lo: [], depth: []} for f in FORMS}
        for r in range(args.reps):
            for form in (FORMS if r % 2 == 0 else FORMS[::-1]):
                for d in (lo, depth):
                    t0 = time.perf_counter()
                    runs[form][d]()
                    walls[form][d].append((time.perf_counter() - t0) * 1e3)
        for form in FORMS:
            w = walls[form]
            sat = statistics.median(h / depth for h in w[depth])
            marg = statistics.median((h - l) / (depth - lo)
                                     for l, h in zip(w[lo], w[depth]))
            print(f"{label}, {form}: saturated p50 {sat:.4f} ms, marginal "
                  f"p50 {marg:.4f} ms a block (depth {depth}, from {lo}; "
                  f"{args.reps} reps in turns)", flush=True)
        kept.append((label, lo, runs))
    for label, lo, runs in kept:
        for form in FORMS:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                runs[form][lo]()
            s = profiler.summarize(profiler.device_events(prof), lo)
            if "error" in s:
                print(f"{label}, {form}: the profiler saw no device event")
                continue
            top = list(s["kernel_us_per_block"].items())[:4]
            print(f"{label}, {form}, {lo} chained blocks under the profiler: "
                  f"busy {s['device_busy_us_per_block']:.2f} us a block in a "
                  f"window of {s['window_us_per_block']:.2f} us, idle share "
                  f"{s['device_idle_share']:.2%}; "
                  + ", ".join(f"{k[:48]} {v:.2f}" for k, v in top),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
