"""Latency attribution: the fixed cost of a chain against the card's
per-block cost (a depth sweep, measured).

The port's copy of the repo-level ``tools/latency_attrib.py``. One chain
of d state-carried blocks (``harness/streaming.py``: on a CUDA device one
CUDA graph replay a depth, captured once; on the CPU a loop of launches)
ends in the probe's read back to the host, the chain's one
synchronisation. Its wall is timed at several depths, all interleaved
within each rep (``streaming.measure_saturated_multi``, so drift cancels
in the fit), and fit as

    wall_ms(d) = A + B * d

* ``A`` = the fixed cost of one chain: the graph replay's launch and the
  probe's read back (on the CPU, the loop's first launches and the read).
  It does not depend on the workload.
* ``B`` = the card's marginal cost a block, which should agree with the
  device tier: each workload's device p50 (CUDA events around one block
  on resident buffers, behind a spin; the host's wall clock on the CPU)
  stands beside it.

A sweep over sizes at one depth would fold A / depth into the per-block
cost; the sweep over depths at one size separates them.

Writes ``<out>.json`` (the rows) and ``<out>.md``.

Usage: python -m gpuaudiobench_tpu_torch.tools.latency_attrib [out.md]
           [--reps 21] [--device cuda|cpu]
       (default out: <temp dir>/latency_attrib.md)
"""

from __future__ import annotations

import argparse
import gc
import sys
from typing import Dict, List, Optional

import torch

from gpuaudiobench_tpu_torch.tools.campaign import card, out_base, write_report

# The depth grid: wide enough that B * d rises above the fixed cost even
# for microsecond bodies; the fixed cost is common to every depth, and
# the reps beat its noise down.
DEPTHS = [16, 64, 128, 256, 512]

# Workloads at their default sizes: the elementwise case, the two
# recurrences, and NoOp as the control whose B is the bare step.
WORKLOADS = ["NoOp", "gain", "IIRFilter", "DWG1DNaive"]

# The depth at which the amortized cost and the fixed cost's share of it
# are given.
D_REF = 256
# Round trips the device tier times a workload.
DEVICE_RUNS = 20


def fit_line(xs, ys):
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / \
        sum((x - mx) ** 2 for x in xs)
    a = my - b * mx
    return a, b


def measure(benchmark: str, depths, reps: int, dev) -> Dict:
    """The median wall ms a depth of one workload's chain, its chain form,
    and its device tier's p50 and method."""
    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.harness.device_timing import (
        measure_device_times,
    )
    from gpuaudiobench_tpu_torch.harness.statistics import (
        calculate_statistics,
    )
    from gpuaudiobench_tpu_torch.harness.streaming import (
        chain_form,
        measure_saturated_multi,
    )
    from gpuaudiobench_tpu_torch.registry import create_benchmark

    cfg = BenchConfig(n_runs=DEVICE_RUNS, verification="none",
                      write_latencies=False, quiet=True)
    b = create_benchmark(benchmark, cfg, dev)
    b.setup()
    try:
        step_fn, carry = b.stream_body()
        form = chain_form(b.device, b.stream_capturable)
        per_block = measure_saturated_multi(step_fn, carry, depths, reps,
                                            form, benchmark)
        walls = []
        for d, lat in zip(depths, per_block):
            w = calculate_statistics([v * d for v in lat]).median
            walls.append(w)
            print(f"  {benchmark} depth={d}: wall p50 {w:.3f} ms "
                  f"({w / d:.4f} ms/block amortized)", flush=True)
        dev_lat, method = measure_device_times(b, cfg)
        device_p50 = (calculate_statistics(dev_lat).median
                      if dev_lat else None)
    finally:
        b.cleanup()
        del b
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"walls": walls, "form": form, "device_p50_ms": device_p50,
            "device_method": method}


def rows(workloads, depths, reps: int, dev) -> List[Dict]:
    out = []
    for bench in workloads:
        print(f"depth sweep: {bench}", flush=True)
        m = measure(bench, depths, reps, dev)
        a, b = fit_line(depths, m["walls"])
        amort = (a + b * D_REF) / D_REF
        share = 100.0 * (a / D_REF) / amort if amort > 0 else float("nan")
        out.append({"benchmark": bench, "A_ms": a, "B_ms": b,
                    "device_p50_ms": m["device_p50_ms"],
                    "device_method": m["device_method"],
                    "amortized_ms": amort, "floor_share_percent": share,
                    "chain_form": m["form"],
                    "points": [[d, w] for d, w in zip(depths, m["walls"])]})
        dp50 = m["device_p50_ms"]
        print(f"{bench}: A {a:.4f} ms, B {b:.6f} ms/block, device p50 "
              + (f"{dp50:.6f}" if dp50 is not None else "—")
              + f" ms [{m['device_method']}]", flush=True)
    return out


def render_md(payload: Dict) -> str:
    lines = [
        "# Latency attribution: fixed cost a chain vs per-block cost "
        f"(depth sweep, measured) on {payload['card']}",
        "",
        f"One chain of d blocks is timed at depths {payload['depths']} "
        f"({payload['reps']} reps, all depths interleaved within each rep) "
        "and fit as `wall_ms(d) = A + B*d`. `A` is the fixed cost of one "
        "chain (one executable): the CUDA graph replay's launch and the probe's read back "
        "to the host (on the CPU, the loop's first launches and the "
        "read), the same for every workload. `B` is the marginal cost a "
        "block, which should agree with the device tier: the device p50 "
        "(CUDA events around one block on resident buffers, behind a "
        "spin) stands beside it.",
        "",
        "| Benchmark | A: fixed/executable (ms) | B: marginal/block (ms) | "
        f"device p50 (ms) [method] | amortized ms/block @ d={D_REF} | "
        f"floor share @ d={D_REF} | chain | fit pts (d -> wall ms) |",
        "|---|---:|---:|---:|---:|---:|---|---|",
    ]
    for r in payload["rows"]:
        dp50 = r["device_p50_ms"]
        dev_s = f"{dp50:.5f}" if dp50 is not None else "—"
        pts = "; ".join(f"{d}->{w:.2f}" for d, w in r["points"])
        lines.append(
            f"| {r['benchmark']} | {r['A_ms']:.4f} | "
            f"{max(r['B_ms'], 0.0):.5f} | {dev_s} [{r['device_method']}] | "
            f"{r['amortized_ms']:.4f} | {r['floor_share_percent']:.0f}% | "
            f"{r['chain_form']} | {pts} |")
    lines += [
        "",
        "Reading: `A` is nearly the same for every row: it is the chain's "
        "launch and read, not a workload property. A floor share near "
        "100% means a workload's amortized saturated number at depth "
        f"{D_REF} is mostly A / {D_REF}; its rate on the card is 1000/B "
        "blocks/s. The suite publishes `B` as the `marginal` tier "
        "(harness/streaming.measure_saturated_marginal) and takes "
        "blocks_per_sec from it where it is above its noise and no faster "
        "than the device p50.",
        "",
        f"All times in ms on {payload['card']}. Campaign: python -m "
        "gpuaudiobench_tpu_torch.tools.latency_attrib.",
    ]
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="")
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from gpuaudiobench_tpu_torch.utils import device as dv

    dev = dv.device(args.device)
    payload = {"card": card(dev), "depths": list(DEPTHS), "reps": args.reps,
               "rows": rows(WORKLOADS, DEPTHS, args.reps, dev)}
    paths = write_report(out_base(args.out, "latency_attrib"), payload,
                         render_md(payload))
    print(f"written: {' / '.join(paths)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
