"""High-rep saturated-percentile campaign: a true p99 of the saturated
tier.

The port's copy of the repo-level ``tools/satreps_campaign.py``. With
the suite's default ``saturated_reps = 21``, the saturated p99 is the
max of 21 samples (the reference's index formula, globals.cu:101-122:
sorted[int(0.99*n)] == sorted[n-1] for n < 100). This campaign runs the
flagship streaming workloads through the port's CLI with
``--saturatedReps 101``, so sorted[int(0.99*101)] = sorted[99] is a real
99th percentile -- one sample IS allowed above it -- and writes a
markdown table, naming the card, beside the CLI's JSON.

Usage: python -m gpuaudiobench_tpu_torch.tools.satreps_campaign [reps]
           [out.md] [json] [--benchmarks NAME,...] [--device cuda|cpu]
           [-- CLI flags ...]
       (defaults: 101, <temp dir>/satreps.md, <temp dir>/satreps.json,
        the flagship list; flags after ``--`` go to the CLI after the
        campaign's own, so they override them, e.g. ``-- --nTracks
        1024``)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, List, Optional

# The flagship streaming set: every stateful or heavy workload with a
# saturated tier (the transfer-bound datacopy* and the SOL_* peak
# probes excluded: their saturated tier is n/a or not an audio block).
BENCHMARKS = [
    "gain", "GainStats", "IIRFilter", "Conv1D", "Conv1D_accel", "FFT1D",
    "ModalFilterBank", "DWG1DNaive", "DWG1DAccel", "FDTD3D", "RndMemRead",
    "BiquadChain", "DAWSessionMix",
]


def cli_argv(names: List[str], reps: int, out_json: str,
             extra: List[str]) -> List[str]:
    return ["--benchmarkFilter", ",".join("=" + n for n in names),
            "--nRuns", "3", "--warmup", "2", "--pipelineDepth", "256",
            "--saturatedReps", str(reps), "--no-device-timing", "--json",
            "--quiet", "--outputfile", out_json] + extra


def rows_of(results: List[Dict]) -> List[Dict]:
    rows = []
    for r in results:
        sat = r.get("saturated")
        if not sat or sat.get("p50_ms", 0) <= 0:
            continue
        raw = sorted(sat.get("raw_ms", []))
        rows.append({
            "benchmark": r["benchmark"], "reps": sat["reps"],
            "p50_ms": sat["p50_ms"], "p95_ms": sat["p95_ms"],
            "p99_ms": sat["p99_ms"], "max_ms": max(raw) if raw else None,
            # Samples above the p99: 0 for a max-as-p99, ~1 % of n for a
            # true percentile.
            "above_p99": sum(1 for v in raw if v > sat["p99_ms"]),
            "cv_percent": sat["cv_percent"], "stability": sat["stability"],
            "meets_deadline": sat["meets_deadline"],
            "deadline_ms": r["deadline"]["threshold_ms"],
            "depth": sat["pipeline_depth"],
        })
    return rows


def render_md(rows: List[Dict], reps: int, card: str,
              json_name: str) -> str:
    lines = [
        f"# Saturated-tier percentiles at {reps} reps on {card}",
        "",
        f"Each rep is the wall time of one pipeline of state-carried "
        f"blocks (one CUDA graph a depth on the card) over its depth; with "
        f"n = {reps} the p99 index formula (globals.cu:101-122) lands on a "
        "real interior sample instead of the max. `> p99` counts raw "
        "samples above the reported p99 (expected ~1 % of n; 0 would mean "
        f"the p99 is still the max). From `{json_name}`.",
        "",
        "| Benchmark | reps | depth | sat p50 ms | p95 | p99 | max | > p99 "
        "| CV (stability) | deadline (p99) |",
        "|---|---:|---:|---:|---:|---:|---:|---:|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['benchmark']} | {r['reps']} | {r['depth']} | "
            f"{r['p50_ms']:.4f} | {r['p95_ms']:.4f} | {r['p99_ms']:.4f} | "
            f"{r['max_ms']:.4f} | {r['above_p99']} | "
            f"{r['cv_percent']:.1f}% ({r['stability']}) | "
            f"{'meets' if r['meets_deadline'] else 'MISSES'} |")
    if rows:
        lines += ["", f"Deadline: {rows[0]['deadline_ms']:.3f} ms "
                  "(1000 * bufferSize / fs). All times in ms on "
                  f"{card}."]
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = []
    if "--" in argv:
        cut = argv.index("--")
        argv, extra = argv[:cut], argv[cut + 1:]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("reps", nargs="?", type=int, default=101)
    ap.add_argument("out_md", nargs="?",
                    default=os.path.join(tempfile.gettempdir(), "satreps.md"))
    ap.add_argument("out_json", nargs="?", default=os.path.join(
        tempfile.gettempdir(), "satreps.json"))
    ap.add_argument("--benchmarks", default=",".join(BENCHMARKS))
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from gpuaudiobench_tpu_torch import cli
    from gpuaudiobench_tpu_torch.analysis.compare import card_label

    names = [n for n in args.benchmarks.split(",") if n]
    cmd = cli_argv(names, args.reps, args.out_json, extra)
    print("+ python -m gpuaudiobench_tpu_torch.cli " + " ".join(cmd))
    rc = cli.main(cmd, device=args.device)
    if rc != 0:
        return rc
    with open(args.out_json) as f:
        results = json.load(f)
    if isinstance(results, dict):  # one benchmark's run is one object
        results = [results]
    rows = rows_of(results)
    card = card_label(next((r.get("device") for r in results
                            if r.get("device")), None))
    with open(args.out_md, "w") as f:
        f.write(render_md(rows, args.reps, card,
                          os.path.basename(args.out_json)))
    print(f"written: {args.out_md} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
