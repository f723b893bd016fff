"""tab5 campaign: the poster's 100 MiB transfer tier, measured.

The port's copy of the repo-level ``tools/transfer_tab5.py``. Every
published transfer baseline of ``BASELINE.md`` is a 100 MiB row (PC
~10 ms pinned, Apple silicon ~8-9 ms, AS unified ~0.15 ms), where the
CUDA code's default is 10 MiB. This campaign runs the five datacopy
mixes at ``--mib`` (100) through the port's harness, uploads staged in
pinned memory, with the overlapped-infeed tier on, and writes them
beside the published numbers with the pinned / pageable A/B of each
direction (``metadata.transferMemoryClass``). An optional 1 GiB tier
(the poster's tab8 scale, no published absolutes) runs datacopy5050
unless ``--skip1gib``. Every number names the card.

A row whose run raises is recorded with its error and the others still
run; the campaign then exits 1.

Writes ``<out>.json`` and ``<out>.md``.

Usage: python -m gpuaudiobench_tpu_torch.tools.transfer_tab5 [--mib 100]
           [--nRuns 11] [--overlapDepth 16] [--overlapReps 5]
           [--out <temp dir>/transfer_tab5] [--skip1gib]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from typing import Dict, List, Optional

from gpuaudiobench_tpu_torch.tools.campaign import (
    card,
    fmt,
    out_base,
    run_json,
    validated,
    write_report,
)

# Published tab5 rows at 100 MiB (BASELINE.md:14-18): p50 ms per
# platform. PC = i7-12700 + RTX 4070 (cudaMallocHost pinned), AS =
# M2 Pro discrete-style copy, AS_unified = unified-memory no-copy.
TAB5_BASELINES = {
    "datacopy0199": {"pc_ms": 10.06, "as_ms": 9.14, "as_unified_ms": 0.15},
    "datacopy2080": {"pc_ms": 9.84, "as_ms": 8.77, "as_unified_ms": 0.134},
    "datacopy5050": {"pc_ms": 9.57, "as_ms": 8.49, "as_unified_ms": 0.157},
    "datacopy8020": {"pc_ms": 9.37, "as_ms": 7.93, "as_unified_ms": 0.130},
    "datacopy9901": {"pc_ms": 9.09, "as_ms": 7.66, "as_unified_ms": 0.133},
}


def run_family(mib: int, n_runs: int, overlap_depth: int,
               overlap_reps: int, dev, names=None) -> List[Dict]:
    from gpuaudiobench_tpu_torch.config import BenchConfig

    rows = []
    for name in (names or sorted(TAB5_BASELINES)):
        cfg = BenchConfig(
            transfer_mib=mib, n_runs=n_runs, warmup=2,
            overlap_depth=overlap_depth, overlap_reps=overlap_reps,
            verification="spot", write_latencies=False, quiet=True)
        print(f"tab5: {name} @ {mib} MiB ...", flush=True)
        try:
            rec = run_json(name, cfg, dev)
        except Exception as e:  # noqa: BLE001 - recorded as the row
            traceback.print_exc()
            rows.append({"benchmark": name, "mib": mib,
                         "error": f"{type(e).__name__}: {e}"})
            continue
        ov = rec.get("overlapped") or {}
        tc = (rec.get("metadata") or {}).get("transferMemoryClass") or {}
        row = {
            "benchmark": name, "mib": mib,
            "roundtrip_p50_ms": rec["statistics"]["p50_ms"],
            "roundtrip_p95_ms": rec["statistics"]["p95_ms"],
            "device_p50_ms": (rec.get("device_statistics")
                              or {}).get("median_ms"),
            "serial_ms": ov.get("serial_p50_ms"),
            "overlapped_ms": ov.get("overlapped_p50_ms"),
            "h2d_path": tc.get("h2d_path_used"),
            "h2d_pinned_ms": tc.get("h2d_pinned_ms"),
            "h2d_pageable_ms": tc.get("h2d_pageable_ms"),
            "d2h_pinned_ms": tc.get("d2h_pinned_ms"),
            "d2h_pageable_ms": tc.get("d2h_pageable_ms"),
            "validation": validated(rec),
            **TAB5_BASELINES.get(name, {}),
        }
        rows.append(row)
        print(f"  -> {json.dumps(row)[:240]}", flush=True)
    return rows


def render_md(payload: Dict) -> str:
    lines = [
        f"# tab5: the poster's 100 MiB transfer tier on {payload['card']}",
        "",
        "Published baselines: BASELINE.md tab5. PC = cudaMallocHost "
        "pinned over PCIe; AS = M2 Pro copy path; AS-unified = unified "
        "memory (no copy). Round trip = the block uploaded from pinned "
        "memory, copied on the card, read back; serial / overlapped = "
        "the overlapped-infeed tier (upload k+1 during compute k) and its "
        "serial twin, ms a block; the A/B columns copy the input through "
        "pinned and pageable memory, H2D and D2H.",
        "",
        "| config | PC p50 | AS p50 | AS-unif p50 | round trip p50 | p95 | "
        "serial | overlapped | H2D pinned / pageable | D2H pinned / "
        "pageable | h2d path | validation |",
        "|---|---:|---:|---:|---:|---:|---:|---:|---:|---:|---|---|",
    ]
    for r in payload["rows"]:
        if "error" in r:
            lines.append(f"| {r['benchmark']} | — | — | — | ERROR: "
                         f"{r['error'][:80]} | | | | | | | |")
            continue
        lines.append(
            f"| {r['benchmark']} | {fmt(r.get('pc_ms'))} | "
            f"{fmt(r.get('as_ms'))} | {fmt(r.get('as_unified_ms'))} | "
            f"{fmt(r.get('roundtrip_p50_ms'), 4)} | "
            f"{fmt(r.get('roundtrip_p95_ms'), 4)} | "
            f"{fmt(r.get('serial_ms'), 4)} | "
            f"{fmt(r.get('overlapped_ms'), 4)} | "
            f"{fmt(r.get('h2d_pinned_ms'), 4)} / "
            f"{fmt(r.get('h2d_pageable_ms'), 4)} | "
            f"{fmt(r.get('d2h_pinned_ms'), 4)} / "
            f"{fmt(r.get('d2h_pageable_ms'), 4)} | "
            f"{r.get('h2d_path') or '—'} | {r.get('validation')} |")
    extra = payload.get("gib_rows")
    if extra:
        lines += [
            "",
            "## 1 GiB tier (tab8 scale; no published absolute baselines)",
            "",
            "| config | round trip p50 | overlapped | H2D pinned | D2H "
            "pinned | validation |",
            "|---|---:|---:|---:|---:|---|",
        ]
        for r in extra:
            if "error" in r:
                lines.append(f"| {r['benchmark']} | ERROR: "
                             f"{r['error'][:100]} | | | | |")
                continue
            lines.append(
                f"| {r['benchmark']} | {fmt(r.get('roundtrip_p50_ms'), 2)} "
                f"| {fmt(r.get('overlapped_ms'), 2)} | "
                f"{fmt(r.get('h2d_pinned_ms'), 2)} | "
                f"{fmt(r.get('d2h_pinned_ms'), 2)} | "
                f"{r.get('validation')} |")
    lines += [
        "",
        f"All times in ms on {payload['card']}. Campaign: python -m "
        f"gpuaudiobench_tpu_torch.tools.transfer_tab5, nRuns "
        f"{payload['n_runs']}, overlapDepth {payload['overlap_depth']}.",
    ]
    return "\n".join(lines) + "\n"


def failed(rows) -> bool:
    return any("error" in r or r.get("validation") != "passed"
               for r in rows)


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=100)
    ap.add_argument("--nRuns", type=int, default=11)
    ap.add_argument("--overlapDepth", type=int, default=16)
    ap.add_argument("--overlapReps", type=int, default=5)
    ap.add_argument("--skip1gib", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from gpuaudiobench_tpu_torch.utils import device as dv

    dev = dv.device(args.device)
    base = out_base(args.out, "transfer_tab5")
    payload = {
        "card": card(dev), "n_runs": args.nRuns,
        "overlap_depth": args.overlapDepth,
        "rows": run_family(args.mib, args.nRuns, args.overlapDepth,
                           args.overlapReps, dev),
    }
    # The 100 MiB tier is written before the 1 GiB attempt, so a failure
    # there keeps the measured rows.
    write_report(base, payload, render_md(payload))
    rows = payload["rows"]
    if not args.skip1gib:
        # One mix at 1 GiB: 50/50 runs both directions.
        payload["gib_rows"] = run_family(
            1024, max(3, args.nRuns // 3), 4, 3, dev, names=["datacopy5050"])
        rows = rows + payload["gib_rows"]
        write_report(base, payload, render_md(payload))
    print(f"written: {base}.json / .md")
    return 1 if failed(rows) else 0


if __name__ == "__main__":
    sys.exit(main())
