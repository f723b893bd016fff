"""Low-latency sweep: saturated ms/block across buffer sizes.

The port's copy of the repo-level ``tools/lowlatency_sweep.py``.
Pro-audio rigs run far below the suite's default 512-sample buffer;
this records the saturated ms a block (a pipeline of state-carried
blocks, one CUDA graph a depth, over the depth) at bufferSize 64 / 128
/ 256 / 512 (deadlines 1.333 / 2.667 / 5.333 / 10.667 ms at 48 kHz) for
the compute-heavy workloads, answering "how small a buffer can this
card serve in real time?" -- a dimension the reference's tables never
measure. Each cell is validated (spot) and the table names the card.

Writes ``<out>.json`` and ``<out>.md``.

Usage: python -m gpuaudiobench_tpu_torch.tools.lowlatency_sweep [out.md]
           [--benchmarks NAME,...] [--buffers 64,128,256,512]
           [--nRuns 3] [--satReps 3] [--device cuda|cpu]
       (default out: <temp dir>/lowlatency_sweep.md; --benchmarks keeps
        the workloads of those benchmarks)
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

from gpuaudiobench_tpu_torch.tools.campaign import (
    card,
    fmt,
    out_base,
    run_json,
    validated,
    write_report,
)

BUFFERS = [64, 128, 256, 512]
WORKLOADS = [
    # (label, benchmark, cfg overrides, depth)
    ("Modal 1M modes", "ModalFilterBank", dict(n_tracks=1024), 256),
    ("IIRFilter (128 trk)", "IIRFilter", dict(), 256),
    ("Conv1D (128 trk, IR 1024)", "Conv1D", dict(), 256),
    ("DWG 1024 voices", "DWG1DNaive", dict(n_tracks=1024), 256),
    ("FDTD3D (52^3 x 3/sample)", "FDTD3D", dict(), 64),
    ("RndMem 16384 trk (512 MiB)", "RndMemRead",
     dict(n_tracks=16384), 64),
    ("BiquadChain 10 stages", "BiquadChain", dict(), 256),
    ("PartConv 1 s IR (128 trk)", "PartConv", dict(), 256),
    ("NeuralAmp TCN d10 (128 trk)", "NeuralAmp", dict(), 64),
]


def run(workloads, buffers, n_runs: int, sat_reps: int, dev) -> List[Dict]:
    from gpuaudiobench_tpu_torch.config import BenchConfig

    rows = []
    for label, name, overrides, depth in workloads:
        cells = []
        for bs in buffers:
            cfg = BenchConfig(
                buffer_size=bs, n_runs=n_runs, warmup=2, pipeline_depth=depth,
                saturated_reps=sat_reps, write_latencies=False,
                device_timing=False, verification="spot", quiet=True,
                **overrides)
            rec = run_json(name, cfg, dev)
            ms = (rec.get("saturated") or {}).get("p50_ms")
            cells.append({"buffer": bs, "deadline_ms": cfg.deadline_ms(),
                          "saturated_p50_ms": ms,
                          "meets": ms is not None and ms <= cfg.deadline_ms(),
                          "validation": validated(rec)})
            print(f"lowlatency: {label} @ buf {bs}: {fmt(ms, 4)} ms against "
                  f"{cfg.deadline_ms():.3f}, {cells[-1]['validation']}",
                  flush=True)
        rows.append({"workload": label, "benchmark": name, "depth": depth,
                     "cells": cells})
    return rows


def render_md(payload: Dict) -> str:
    head = " | ".join(f"buf {b} (ddl {1000.0 * b / 48000:.3f})"
                      for b in payload["buffers"])
    lines = [
        f"# Low-latency sweep on {payload['card']}: saturated ms/block "
        "against buffer size",
        "",
        "Real-time budget at 48 kHz = 1000*bufferSize/48000 ms. Saturated "
        "= a pipeline of state-carried blocks (one CUDA graph a depth on "
        "the card) over its depth.",
        "",
        f"| Workload (depth) | {head} |",
        "|---|" + "---:|" * len(payload["buffers"]),
    ]
    for r in payload["rows"]:
        cells = []
        for c in r["cells"]:
            if c["validation"] == "FAILED":
                cells.append("VALIDATION FAIL")
            else:
                cells.append(f"{fmt(c['saturated_p50_ms'], 4)} "
                             f"{'meets' if c['meets'] else 'MISS'}")
        lines.append(f"| {r['workload']} ({r['depth']}) | "
                     + " | ".join(cells) + " |")
    lines += ["", f"All times in ms on {payload['card']}. Campaign: python "
              f"-m gpuaudiobench_tpu_torch.tools.lowlatency_sweep, nRuns "
              f"{payload['n_runs']}, satReps {payload['sat_reps']}."]
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="")
    ap.add_argument("--benchmarks", default="")
    ap.add_argument("--buffers", default=",".join(map(str, BUFFERS)))
    ap.add_argument("--nRuns", type=int, default=3)
    ap.add_argument("--satReps", type=int, default=3)
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from gpuaudiobench_tpu_torch.utils import device as dv

    keep = [n for n in args.benchmarks.split(",") if n]
    unknown = set(keep) - {w[1] for w in WORKLOADS}
    if unknown:
        print(f"--benchmarks: no workload of {', '.join(sorted(unknown))}")
        return 1
    workloads = [w for w in WORKLOADS if not keep or w[1] in keep]
    buffers = [int(b) for b in args.buffers.split(",") if b]
    dev = dv.device(args.device)
    payload = {"card": card(dev), "buffers": buffers, "n_runs": args.nRuns,
               "sat_reps": args.satReps,
               "rows": run(workloads, buffers, args.nRuns, args.satReps,
                           dev)}
    paths = write_report(out_base(args.out, "lowlatency_sweep"), payload,
                         render_md(payload))
    print(f"written: {' / '.join(paths)}")
    return 0 if all(c["validation"] == "passed" for r in payload["rows"]
                    for c in r["cells"]) else 1


if __name__ == "__main__":
    sys.exit(main())
