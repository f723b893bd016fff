"""RndMemRead track-count sweep: the DAFx-24 poster's complete tab6.

The port's copy of the repo-level ``tools/rndmem_sweep.py``. It covers
every published track count -- 32, 128, 1,024, 4,096, 16,384 and
65,536 -- on the CUDA reference's default 512 MiB pool
(``bench_rndmem.cuh``; the poster's tab6 caption says 128 MiB, and the
larger pool is the harder one for the caches), through the port's
harness on the gather kernel (``csrc/rndmem.cu``). Each row records the
round-trip p50 / p95 (one block: playheads up, gather, the (T, 512)
output read back; the published numbers' basis), the saturated p50 and
marginal p50 (a pipeline of blocks at the row's depth, one CUDA graph a
depth) and the device p50, beside the published RTX 4070 ("PC") and M2
Pro ("AS") round-trip p50s, validated (spot) and labelled with the
card. The depth shrinks with the track count to bound a sweep's time
and is recorded per row.

Writes ``<out>.json`` (the rows) and ``<out>.md``.

Usage: python -m gpuaudiobench_tpu_torch.tools.rndmem_sweep [out.md]
           [--nRuns 5] [--satReps 11] [--device cuda|cpu]
       (default out: <temp dir>/rndmem_sweep.md)
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

# (tracks, pipeline depth, RTX 4070 p50 ms, M2 Pro p50 ms): BASELINE.md
# tab6.
POINTS = [
    (32, 256, 0.138, 0.229),
    (128, 256, 0.163, 0.657),
    (1024, 256, 0.364, 0.723),
    (4096, 256, 1.030, 0.719),
    (16384, 64, 3.810, 0.924),
    (65536, 32, 19.297, 4.801),
]
POOL_MIB = 512


def run(points, pool_mib: int, n_runs: int, sat_reps: int,
        dev) -> List[Dict]:
    from gpuaudiobench_tpu_torch.config import BenchConfig

    rows = []
    for tracks, depth, pc, as_ in points:
        cfg = BenchConfig(
            n_tracks=tracks, rndmem_pool_mb=pool_mib, n_runs=n_runs,
            warmup=2, pipeline_depth=depth, saturated_reps=sat_reps,
            write_latencies=False, verification="spot", quiet=True)
        rec = run_json("RndMemRead", cfg, dev)
        st, sat = rec["statistics"], rec.get("saturated") or {}
        dst = rec.get("device_statistics") or {}
        row = {
            "tracks": tracks, "depth": depth, "pc_p50_ms": pc,
            "as_p50_ms": as_,
            "roundtrip_p50_ms": st["p50_ms"],
            "roundtrip_p95_ms": st["p95_ms"],
            "saturated_p50_ms": sat.get("p50_ms"),
            "marginal_p50_ms": (sat.get("marginal") or {}).get("p50_ms"),
            "device_p50_ms": dst.get("median_ms"),
            "device_method": dst.get("method"),
            "validation": validated(rec),
        }
        rows.append(row)
        print(f"tab6: {tracks} tracks (depth {depth}): round trip p50 "
              f"{fmt(row['roundtrip_p50_ms'], 4)} ms (PC {pc}), saturated "
              f"{fmt(row['saturated_p50_ms'], 4)}, device "
              f"{fmt(row['device_p50_ms'], 4)}, {row['validation']}",
              flush=True)
    return rows


def render_md(payload: Dict) -> str:
    rows = payload["rows"]
    lines = [
        f"# RndMemRead track sweep (tab6, {payload['pool_mib']} MiB pool) "
        f"on {payload['card']}",
        "",
        "All six published track counts (BASELINE.md tab6; the poster's "
        "caption says a 128 MiB pool, this sweep keeps the CUDA "
        "reference's default). Round trip = playheads up, one gather, the "
        "(T, 512) output read back through pageable memory: the published "
        "p50s' basis. Saturated = a pipeline of blocks over its depth; "
        "marginal = its depth-differenced cost; device = one block on "
        "resident buffers.",
        "",
        "| Tracks | PC p50 | AS p50 | round trip p50 | p95 | saturated "
        "(depth) | marginal | device [method] | validation |",
        "|---:|---:|---:|---:|---:|---:|---:|---:|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['tracks']} | {r['pc_p50_ms']:.3f} | {r['as_p50_ms']:.3f} "
            f"| {fmt(r['roundtrip_p50_ms'], 4)} | "
            f"{fmt(r['roundtrip_p95_ms'], 4)} | "
            f"{fmt(r['saturated_p50_ms'], 4)} ({r['depth']}) | "
            f"{fmt(r['marginal_p50_ms'], 4)} | "
            f"{fmt(r['device_p50_ms'], 4)} [{r['device_method']}] | "
            f"{r['validation']} |")

    def beats(col, base):
        return sum(1 for r in rows
                   if r.get(col) is not None and r[col] < r[base])

    n = len(rows)
    rt_pc = beats("roundtrip_p50_ms", "pc_p50_ms")
    rt_as = beats("roundtrip_p50_ms", "as_p50_ms")
    dev_pc = beats("device_p50_ms", "pc_p50_ms")
    dev_as = beats("device_p50_ms", "as_p50_ms")
    lines += [
        "",
        f"Round trip below the published p50: {rt_pc}/{n} sizes against "
        f"the RTX 4070, {rt_as}/{n} against the M2 Pro. Device p50 below "
        f"them: {dev_pc}/{n} and {dev_as}/{n}.",
        "",
        f"All times in ms on {payload['card']}. Campaign: python -m "
        f"gpuaudiobench_tpu_torch.tools.rndmem_sweep, nRuns "
        f"{payload['n_runs']}, satReps {payload['sat_reps']}.",
    ]
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="")
    ap.add_argument("--nRuns", type=int, default=5)
    ap.add_argument("--satReps", type=int, default=11)
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from gpuaudiobench_tpu_torch.utils import device as dv

    dev = dv.device(args.device)
    payload = {"card": card(dev), "pool_mib": POOL_MIB,
               "n_runs": args.nRuns, "sat_reps": args.satReps,
               "rows": run(POINTS, POOL_MIB, args.nRuns, args.satReps, dev)}
    paths = write_report(out_base(args.out, "rndmem_sweep"), payload,
                         render_md(payload))
    print(f"written: {' / '.join(paths)}")
    return 0 if all(r["validation"] == "passed"
                    for r in payload["rows"]) else 1


if __name__ == "__main__":
    sys.exit(main())
