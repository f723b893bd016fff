"""Serial against overlapped infeed, benchmark by benchmark.

The port's copy of the repo-level ``tools/overlap_campaign.py``. It runs
the overlapped-infeed tier (``harness/overlap.py``: the host blocks
staged in pinned memory, uploads on a copy stream into two device slots,
one read at the end) for the datacopy family and the stateful workloads
in one process, one after another, and writes per benchmark the serial
and overlapped ms a block, the speedup, the device-timing method and the
path the datacopy benchmarks' uploads took
(``metadata.transferMemoryClass.h2d_path_used``). The reference's two
projection columns (a co-located projection of its relay's round trip)
are not ported. Every row is validated (spot), and the card that ran it
is named in the table's header. A benchmark with no overlap body is
skipped with a line that says so.

Writes ``<out>.json`` (the rows) and ``<out>.md``.

Usage: python -m gpuaudiobench_tpu_torch.tools.overlap_campaign [out.md]
           [--depth 64] [--reps 7] [--bufferSize 512] [--benches a,b,...]
           [--device cuda|cpu]
       (default out: <temp dir>/overlap_campaign.md)
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

from gpuaudiobench_tpu_torch.tools.campaign import (
    card,
    out_base,
    run_json,
    validated,
    write_report,
)

BENCHES = [
    "datacopy0199", "datacopy5050", "datacopy9901",
    "gain", "GainStats", "FFT1D", "Conv1D", "IIRFilter",
    "DWG1DNaive", "RndMemRead", "NeuralAmp", "PartConv",
    "DAWSessionMix",
]


def run(names: List[str], depth: int, reps: int, buffer_size: int,
        dev) -> Dict:
    """Each name through the harness with the overlap tier: (rows, the
    names skipped for want of an overlap body)."""
    from gpuaudiobench_tpu_torch.config import BenchConfig

    rows, skipped = [], []
    for name in names:
        cfg = BenchConfig(
            n_runs=3, warmup=2, overlap_depth=depth, overlap_reps=reps,
            verification="spot", buffer_size=buffer_size,
            device_timing=True, write_latencies=False, quiet=True)
        rec = run_json(name, cfg, dev)
        ov = rec.get("overlapped")
        if ov is None:
            print(f"{name}: no overlap body (skipped)", flush=True)
            skipped.append(name)
            continue
        tc = (rec.get("metadata") or {}).get("transferMemoryClass") or {}
        rows.append({
            "name": name,
            "serial": ov["serial_p50_ms"],
            "overlapped": ov["overlapped_p50_ms"],
            "speedup": ov["speedup_vs_serial"],
            "device_method": (rec.get("device_statistics")
                              or {}).get("method", ""),
            "h2d_path": tc.get("h2d_path_used", ""),
            "validation": validated(rec),
            "overlap": {k: v for k, v in ov.items()
                        if not k.endswith("raw_ms")},
        })
        print(f"{name}: serial {ov['serial_p50_ms']:.3f} -> overlapped "
              f"{ov['overlapped_p50_ms']:.3f} ms/block "
              f"({ov['speedup_vs_serial']:.2f}x), {rows[-1]['validation']}",
              flush=True)
    return {"rows": rows, "skipped": skipped}


def render_md(payload: Dict) -> str:
    buf = payload["buffer_size"]
    lines = [
        "# Overlapped-infeed campaign (serial vs double-buffered upload, "
        f"measured) on {payload['card']}",
        "",
        f"Buffer {buf} @ 48 kHz (deadline {1000.0 * buf / 48000:.3f} ms). "
        f"`--overlapDepth {payload['depth']} --overlapReps "
        f"{payload['reps']}` (harness/overlap.py). Serial = upload, "
        "compute, probe read, a block at a time; overlapped = upload block "
        "k+1 from a pinned slot on a copy stream while block k computes, "
        "one read at the end of the pipeline. `h2d path` is the path the "
        "datacopy benchmarks' uploads took (metadata.transferMemoryClass).",
        "",
        "| Benchmark | serial ms/block | overlapped ms/block | speedup "
        "| device timing | h2d path | validation |",
        "|---|---:|---:|---:|---|---|---|",
    ]
    for r in payload["rows"]:
        lines.append(
            f"| {r['name']} | {r['serial']:.3f} | {r['overlapped']:.3f} "
            f"| {r['speedup']:.2f}x | {r['device_method'] or '—'} | "
            f"{r['h2d_path'] or '—'} | {r['validation']} |")
    if payload["skipped"]:
        lines += ["", "No overlap body (skipped): "
                  + ", ".join(payload["skipped"]) + "."]
    lines += ["", f"All times in ms on {payload['card']}. Campaign: python "
              "-m gpuaudiobench_tpu_torch.tools.overlap_campaign."]
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="")
    ap.add_argument("--depth", type=int, default=64)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--bufferSize", type=int, default=512)
    ap.add_argument("--benches", default=",".join(BENCHES))
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from gpuaudiobench_tpu_torch.utils import device as dv

    dev = dv.device(args.device)
    payload = {"card": card(dev), "depth": args.depth, "reps": args.reps,
               "buffer_size": args.bufferSize,
               **run(args.benches.split(","), args.depth, args.reps,
                     args.bufferSize, dev)}
    paths = write_report(out_base(args.out, "overlap_campaign"), payload,
                         render_md(payload))
    print(f"written: {' / '.join(paths)}")
    return 0 if all(r["validation"] == "passed"
                    for r in payload["rows"]) else 1


if __name__ == "__main__":
    sys.exit(main())
