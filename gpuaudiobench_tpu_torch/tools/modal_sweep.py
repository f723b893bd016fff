"""ModalFilterBank mode-count sweep: the DAFx-24 poster's tab4.

The port's copy of the repo-level ``tools/modal_sweep.py``. At each of
the poster's three mode counts, 1,024, 102,400 and 1,048,576 (the main
path's full width), folded onto 32 output tracks at ``--nTracks 1024``,
it runs the port's harness on the rotation kernel
(``csrc/modal_bank.cu``) and records the round-trip p50 / p95 (one
block: upload, launch, read back), the saturated p50 (a pipeline of
state-carried blocks, one CUDA graph a depth, over the depth) and the
device p50 (CUDA events around one block on resident buffers), beside
the published RTX 4070 ("PC") and M2 Pro ("AS") round-trip p50s
(``BASELINE.md`` tab4). Every row is validated against the NumPy golden
(spot) and names the card.

Writes ``<out>.json`` (the rows) and ``<out>.md``.

Usage: python -m gpuaudiobench_tpu_torch.tools.modal_sweep [out.md]
           [--nRuns 11] [--satReps 11] [--device cuda|cpu]
       (default out: <temp dir>/modal_sweep.md)
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

# (modes, pipeline depth, RTX 4070 p50 ms, M2 Pro p50 ms): BASELINE.md
# tab4.
POINTS = [
    (1024, 256, 0.050, 0.172),
    (102400, 256, 0.315, 0.611),
    (1048576, 512, 3.168, 5.717),
]
N_TRACKS = 1024


def run(points, n_runs: int, sat_reps: int, dev) -> List[Dict]:
    from gpuaudiobench_tpu_torch.config import BenchConfig

    rows = []
    for modes, depth, pc, as_ in points:
        cfg = BenchConfig(
            n_tracks=N_TRACKS, modal_num_modes=modes, n_runs=n_runs,
            warmup=2, pipeline_depth=depth, saturated_reps=sat_reps,
            write_latencies=False, verification="spot", quiet=True)
        rec = run_json("ModalFilterBank", cfg, dev)
        st = rec["statistics"]
        row = {
            "modes": modes, "depth": depth, "pc_p50_ms": pc,
            "as_p50_ms": as_,
            "roundtrip_p50_ms": st["p50_ms"],
            "roundtrip_p95_ms": st["p95_ms"],
            "saturated_p50_ms": (rec.get("saturated") or {}).get("p50_ms"),
            "device_p50_ms": (rec.get("device_statistics")
                              or {}).get("median_ms"),
            "device_method": (rec.get("device_statistics")
                              or {}).get("method"),
            "deadline_ms": rec["deadline"]["threshold_ms"],
            "validation": validated(rec),
        }
        rows.append(row)
        print(f"tab4: {modes} modes: round trip p50 "
              f"{fmt(row['roundtrip_p50_ms'], 4)} ms, saturated "
              f"{fmt(row['saturated_p50_ms'], 4)}, device "
              f"{fmt(row['device_p50_ms'], 4)}, {row['validation']}",
              flush=True)
    return rows


def render_md(payload: Dict) -> str:
    lines = [
        f"# Modal mode-count sweep (tab4) on {payload['card']}",
        "",
        "Round trip = one block uploaded, run and read back (the "
        "published numbers' basis); saturated = a pipeline of "
        "state-carried blocks over its depth; device = CUDA events around "
        "one block on resident buffers. Published p50s: BASELINE.md tab4 "
        "(PC = RTX 4070, AS = M2 Pro).",
        "",
        "| Modes | PC p50 | AS p50 | round trip p50 | p95 | saturated "
        "p50 (depth) | device p50 [method] | vs PC (round trip) | validation |",
        "|---:|---:|---:|---:|---:|---:|---:|---:|---|",
    ]
    for r in payload["rows"]:
        rt = r["roundtrip_p50_ms"]
        lines.append(
            f"| {r['modes']} | {r['pc_p50_ms']:.3f} | {r['as_p50_ms']:.3f} "
            f"| {fmt(rt, 4)} | {fmt(r['roundtrip_p95_ms'], 4)} | "
            f"{fmt(r['saturated_p50_ms'], 4)} ({r['depth']}) | "
            f"{fmt(r['device_p50_ms'], 4)} [{r['device_method']}] | "
            f"{r['pc_p50_ms'] / rt:.2f}x | {r['validation']} |")
    lines += ["", f"All times in ms on {payload['card']}. Campaign: "
              f"python -m gpuaudiobench_tpu_torch.tools.modal_sweep, "
              f"nRuns {payload['n_runs']}, satReps {payload['sat_reps']}."]
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="")
    ap.add_argument("--nRuns", type=int, default=11)
    ap.add_argument("--satReps", type=int, default=11)
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from gpuaudiobench_tpu_torch.utils import device as dv

    dev = dv.device(args.device)
    payload = {"card": card(dev), "n_tracks": N_TRACKS,
               "n_runs": args.nRuns, "sat_reps": args.satReps,
               "rows": run(POINTS, args.nRuns, args.satReps, dev)}
    paths = write_report(out_base(args.out, "modal_sweep"), payload,
                         render_md(payload))
    print(f"written: {' / '.join(paths)}")
    return 0 if all(r["validation"] == "passed"
                    for r in payload["rows"]) else 1


if __name__ == "__main__":
    sys.exit(main())
