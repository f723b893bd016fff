"""Derive the CUDA-schema CSV from the port's JSON results.

The port's copy of the repo-level ``tools/json_to_csv.py``: one
measurement, two serializations. ``tools/regen_artifacts`` runs the suite
once (JSON) and derives the CSV from that JSON here, so the two can never
disagree. The columns are those of the CLI's live CSV
(``harness/output.py:csv_from_json_results``, which both surfaces use):
the reference's schema (globals.cu:69-122), the saturated and marginal
columns, the device-timing method and the timing environment. A JSON
object is taken as a one-row list.

Usage: python -m gpuaudiobench_tpu_torch.tools.json_to_csv RESULTS.json RESULTS.csv
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from gpuaudiobench_tpu_torch.harness.output import csv_from_json_results


def convert(results: list) -> str:
    return csv_from_json_results(results)


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    """Reads a result file only: ``device`` is taken for the tools'
    common signature and runs nothing."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("json_path")
    ap.add_argument("csv_path")
    args = ap.parse_args(argv)
    with open(args.json_path) as f:
        results = json.load(f)
    if isinstance(results, dict):
        results = [results]
    with open(args.csv_path, "w") as f:
        f.write(convert(results))
    print(f"wrote {args.csv_path} ({len(results)} rows) from {args.json_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
