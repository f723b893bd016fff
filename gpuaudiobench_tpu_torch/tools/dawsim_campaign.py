"""DAW-sim measurement campaign: the poster's tab7 and tab8.

The port's copy of the repo-level ``tools/dawsim_campaign.py``. It
measures how DAW-style buffer pacing (the host waits out each buffer
period, sleeping or spinning, before it sends the next block) perturbs
the round trip, through the port's harness (``harness/dawsim.py``, the
native g++ pacer where it builds; the JSON's ``deadline.pacer`` names
it): p50 / p95 / max per pacer (off, sleep, spin), the p50 runtime
multiplier paced over unpaced, and the deadline miss rate, at the
poster's own configurations and the 512-sample buffer (10.667 ms):

* tab7: ModalFilterBank at 1,048,576 modes (``--nTracks 1024``);
* tab8: the kernel invocation (NoOp), 100 MiB I/O 1/99
  (``datacopy0199``) and the 1M-mode bank.

The buffer is never enlarged to fit a round trip: where the round trip
exceeds the buffer period, the pacer has nothing to wait for and the
misses are reported. Published numbers beside each row; every number
names the card.

Writes ``<out>.json`` and ``<out>.md``.

Usage: python -m gpuaudiobench_tpu_torch.tools.dawsim_campaign [out.md]
           [--nRuns 30] [--device cuda|cpu]
       (default out: <temp dir>/dawsim_campaign.md)
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

MODES = ["off", "sleep", "spin"]

# (label, benchmark, cfg overrides, published PC / AS p50 multiplier
# (BASELINE.md tab8), published PC p50 / p95 / max per pacer (tab7)).
TAB7_PC = {"off": (2.87, 3.73, 3.96), "sleep": (7.37, 10.94, 11.07),
           "spin": (2.87, 8.07, 10.96)}
WORKLOADS = [
    ("Modal 1M modes", "ModalFilterBank", dict(n_tracks=1024),
     (1.093, 1.283), TAB7_PC),
    ("Kernel invocation (NoOp)", "NoOp", dict(), (2.740, 2.863), None),
    ("100 MiB I/O 1/99", "datacopy0199", dict(transfer_mib=100),
     (1.049, 1.108), None),
]


def run_one(name: str, overrides: Dict, mode: str, n_runs: int,
            dev) -> Dict:
    from gpuaudiobench_tpu_torch.config import BenchConfig

    cfg = BenchConfig(
        n_runs=n_runs, warmup=3, write_latencies=False, device_timing=False,
        verification="spot", quiet=True, dawsim=(mode != "off"),
        dawsim_mode=(mode if mode != "off" else "spin"), **overrides)
    from gpuaudiobench_tpu_torch.harness.dawsim import deadline_miss_rate

    rec = run_json(name, cfg, dev)
    st, dl = rec["statistics"], rec["deadline"]
    return {"p50_ms": st["p50_ms"], "p95_ms": st["p95_ms"],
            "max_ms": st["max_ms"],
            # The JSON has a miss rate only for a paced run.
            "miss_rate_percent": deadline_miss_rate(
                rec["raw_latencies_ms"], cfg.buffer_size, cfg.fs),
            "pacer": dl.get("pacer"), "deadline_ms": dl["threshold_ms"],
            "validation": validated(rec)}


def run(workloads, n_runs: int, dev) -> List[Dict]:
    rows = []
    for label, name, overrides, mult, tab7 in workloads:
        base = None
        for mode in MODES:
            r = run_one(name, overrides, mode, n_runs, dev)
            base = r["p50_ms"] if mode == "off" else base
            r.update(workload=label, benchmark=name, mode=mode,
                     multiplier=r["p50_ms"] / base if base else None,
                     pc_multiplier=mult[0], as_multiplier=mult[1],
                     pc_tab7=tab7[mode] if tab7 else None)
            rows.append(r)
            print(f"dawsim: {label} [{mode}]: p50 {fmt(r['p50_ms'], 4)} ms, "
                  f"x{fmt(r['multiplier'])}, miss "
                  f"{r['miss_rate_percent']:.1f} %, {r['validation']}",
                  flush=True)
    return rows


def render_md(payload: Dict) -> str:
    lines = [
        f"# DAW-sim pacing campaign (tab7 / tab8) on {payload['card']}",
        "",
        "Round trip with the DAW pacer off / sleep / spin at the "
        "512-sample buffer, its p50 multiplier over the unpaced run, and "
        "the share of round trips past the buffer period. Published: "
        "BASELINE.md tab7 (PC, 1M modes) and tab8 (PC / AS multipliers).",
        "",
        "| Workload | pacer | p50 | p95 | max | p50 mult | miss rate | "
        "PC tab7 p50 / p95 / max | tab8 mult PC / AS | validation |",
        "|---|---|---:|---:|---:|---:|---:|---:|---:|---|",
    ]
    for r in payload["rows"]:
        pacer = r["mode"] + (f" ({r['pacer']})" if r["pacer"] else "")
        tab7 = (" / ".join(f"{v:.2f}" for v in r["pc_tab7"])
                if r["pc_tab7"] else "—")
        miss = f"{r['miss_rate_percent']:.1f} %"
        lines.append(
            f"| {r['workload']} | {pacer} | {fmt(r['p50_ms'], 4)} | "
            f"{fmt(r['p95_ms'], 4)} | {fmt(r['max_ms'], 4)} | "
            f"x{fmt(r['multiplier'])} | {miss} | {tab7} | "
            f"x{r['pc_multiplier']:.3f} / x{r['as_multiplier']:.3f} | "
            f"{r['validation']} |")
    lines += [
        "",
        f"All times in ms on {payload['card']}; deadline "
        f"{payload['deadline_ms']:.3f} ms. Campaign: python -m "
        f"gpuaudiobench_tpu_torch.tools.dawsim_campaign, nRuns "
        f"{payload['n_runs']}.",
    ]
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="")
    ap.add_argument("--nRuns", type=int, default=30)
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from gpuaudiobench_tpu_torch.utils import device as dv

    dev = dv.device(args.device)
    rows = run(WORKLOADS, args.nRuns, dev)
    payload = {"card": card(dev), "n_runs": args.nRuns,
               "deadline_ms": rows[0]["deadline_ms"], "rows": rows}
    paths = write_report(out_base(args.out, "dawsim_campaign"), payload,
                         render_md(payload))
    print(f"written: {' / '.join(paths)}")
    return 0 if all(r["validation"] == "passed" for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
