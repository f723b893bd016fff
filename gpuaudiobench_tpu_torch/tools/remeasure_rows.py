"""Re-measure named rows of a suite JSON at a high rep count and splice
them into it.

The port's copy of the repo-level ``tools/remeasure_rows.py``. It re-runs
the named benchmarks with the suite's configuration (the CLI's defaults,
``--nRuns`` round trips at ``--pipelineDepth``, full verification) but
``--saturatedReps N`` (101 by default, enough for a p99), and replaces
their rows in the suite JSON in place; the CSV and the rendered docs
then re-derive from the updated JSON (``tools.json_to_csv``,
``tools.render_results``). Each replaced row's ``saturated.reps`` gives
its rep count, so a JSON of mixed rep counts describes itself.

The datacopy family has no saturated tier (its round trip is the
measurement): its re-measure runs ``--satReps`` round trips instead. The
JSON is written after every row, so a run cut short keeps the rows it
measured.

Usage:
    python -m gpuaudiobench_tpu_torch.tools.remeasure_rows suite.json NoOp IIRFilter ... \\
        [--satReps 101] [--nRuns 20] [--pipelineDepth 256] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from gpuaudiobench_tpu_torch.tools.campaign import run_json


def remeasure(name: str, args, dev) -> dict:
    from gpuaudiobench_tpu_torch.config import BenchConfig

    is_roundtrip = name.startswith("datacopy")
    cfg = BenchConfig(
        n_runs=(args.satReps if is_roundtrip else args.nRuns),
        warmup=3,
        pipeline_depth=0 if is_roundtrip else args.pipelineDepth,
        saturated_reps=args.satReps,
        verification="full",
        write_latencies=False,
        quiet=True,
    )
    return run_json(name, cfg, dev)


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("suite_json")
    ap.add_argument("benchmarks", nargs="+")
    ap.add_argument("--satReps", type=int, default=101)
    ap.add_argument("--nRuns", type=int, default=20)
    ap.add_argument("--pipelineDepth", type=int, default=256)
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    with open(args.suite_json) as f:
        data = json.load(f)
    suite = [data] if isinstance(data, dict) else data
    index = {r["benchmark"]: i for i, r in enumerate(suite)}
    for name in args.benchmarks:
        if name not in index:
            raise SystemExit(f"{name} not in {args.suite_json}")

    from gpuaudiobench_tpu_torch.utils import device as dv

    dev = dv.device(args.device)
    for name in args.benchmarks:
        print(f"remeasure: {name} (satReps {args.satReps}) ...", flush=True)
        row = remeasure(name, args, dev)
        sat = row.get("saturated") or {}
        stats = row.get("statistics") or {}
        print(f"  -> sat p50 {sat.get('p50_ms')} CV "
              f"{sat.get('cv_percent')}% ({sat.get('stability')}); "
              f"roundtrip CV {stats.get('cv_percent')}%; validation "
              f"{(row.get('validation') or {}).get('status')}", flush=True)
        suite[index[name]] = row
        # Written after every row: a run cut short keeps what it measured.
        with open(args.suite_json, "w") as f:
            json.dump(suite[0] if isinstance(data, dict) else suite, f,
                      indent=2)
    print(f"updated: {args.suite_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
