"""The port's results beside the reference's published numbers.

The port's copy of the repo-level ``analysis/compare.py``: read a CSV
the port's CLI wrote (``--outputfile``, the CUDA schema of
``harness/output.py:_cuda_row``) or its JSON (``--json --outputfile``)
and print each benchmark's latency next to the published RTX 4070 ("PC")
and M2 Pro ("AS") numbers of ``BASELINE.md``, where they exist. The
port's column is labelled with the card the JSON names (its
``device.kind`` and ``device.power_limit``); a CSV does not name it.

Usage:
  python -m gpuaudiobench_tpu_torch.cli --benchmarkFilter /.*/ --json \
      --outputfile results.json
  python -m gpuaudiobench_tpu_torch.analysis.compare results.json
"""

from __future__ import annotations

import csv
import json
import sys
from typing import Dict, List, Optional, Tuple

# Published p50/p95 (ms) from BASELINE.md (DAFx-24 poster tab4/tab5/tab6).
PUBLISHED = {
    # benchmark: {platform: (p50, p95)}
    "ModalFilterBank": {"PC": (3.168, 3.941), "AS": (5.717, 5.87)},  # 1M modes
    "datacopy0199": {"PC": (10.06, 11.82), "AS": (9.14, 9.25)},  # 100 MiB scale
    "datacopy2080": {"PC": (9.84, 11.68), "AS": (8.77, 8.85)},
    "datacopy5050": {"PC": (9.57, 11.5), "AS": (8.49, 8.56)},
    "datacopy8020": {"PC": (9.37, 11.1), "AS": (7.93, 8.01)},
    "datacopy9901": {"PC": (9.09, 10.59), "AS": (7.66, 7.75)},
    "RndMemRead": {"PC": (0.163, 0.427), "AS": (0.657, 0.787)},  # 128 trk
    "NoOp": {"PC": (0.015, None), "AS": (0.125, None)},  # fig4 bulk
}

# Modal mode-count sweep (poster tab4): published p50/p95 per platform.
# tools/modal_sweep.py measures the port at these points.
MODAL_SWEEP = {
    # modes: {"PC": (p50, p95), "AS": (p50, p95)}
    1024:    {"PC": (0.050, 0.183), "AS": (0.172, 0.203)},
    102400:  {"PC": (0.315, 0.447), "AS": (0.611, 0.671)},
    1048576: {"PC": (3.168, 3.941), "AS": (5.717, 5.870)},
}

NOTES = {
    "ModalFilterBank": "published = 1M modes (run with --nTracks 1024)",
    "datacopy0199": "published = 100 MiB pool (harness default 10 MiB)",
    "datacopy2080": "published = 100 MiB pool",
    "datacopy5050": "published = 100 MiB pool",
    "datacopy8020": "published = 100 MiB pool",
    "datacopy9901": "published = 100 MiB pool",
    "RndMemRead": "published = 128 MiB pool, 128 tracks",
    "NoOp": "published = histogram bulk p50 (fig4)",
}

CSV_CARD = "port (the CSV names no card)"


def card_label(device: Optional[dict]) -> str:
    """"<name>, <power limit>" of a JSON result's ``device`` section; the
    power limit reads "power limit not read" where nvidia-smi gave none
    and a CPU run says "cpu"."""
    if not device:
        return "device not recorded"
    name = device.get("kind") or device.get("name") or "unknown device"
    if device.get("platform") != "gpu":
        return name
    return f"{name}, {device.get('power_limit') or 'power limit not read'}"


def load_rows(path: str) -> Tuple[List[Dict], str]:
    """(rows, card): one row a benchmark of the port's JSON (one object
    or an array) or CSV, and the label of the card that ran them."""
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            data = [data]
        rows = [{
            "benchmark": r["benchmark"],
            "p50_ms": r["statistics"]["p50_ms"],
            "p95_ms": r["statistics"]["p95_ms"],
            "p99_ms": r["statistics"]["p99_ms"],
            "threshold_ms": r["deadline"]["threshold_ms"],
            "meets_deadline": r["deadline"]["meets_deadline"],
        } for r in data]
        card = card_label(next((r.get("device") for r in data
                                if r.get("device")), None))
        return rows, card
    with open(path) as f:
        rows = [{
            "benchmark": row["benchmark"],
            "p50_ms": float(row["p50_ms"]),
            "p95_ms": float(row["p95_ms"]),
            "p99_ms": float(row["p99_ms"]),
            "threshold_ms": float(row["threshold_ms"]),
            "meets_deadline": row["meets_deadline"] == "true",
        } for row in csv.DictReader(f)]
    return rows, CSV_CARD


def print_modal_sweep() -> None:
    print("Modal mode-count sweep (tab4; measure the port with "
          "python -m gpuaudiobench_tpu_torch.tools.modal_sweep):")
    print(f"{'modes':>9} {'PC p50':>8} {'AS p50':>8}")
    for modes, row in MODAL_SWEEP.items():
        print(f"{modes:>9} {row['PC'][0]:>8.3f} {row['AS'][0]:>8.3f}")
    print()


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    """Reads result files only: ``device`` is taken for the tools' common
    signature and runs nothing."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    rows, card = load_rows(argv[0])
    print_modal_sweep()
    print(f"port: {card}")
    print(f"{'benchmark':<16} {'port p50':>9} {'port p95':>9} {'deadline':>9} "
          f"{'PC p50':>8} {'vs PC':>7}  note")
    print("-" * 86)
    for r in rows:
        name = r["benchmark"]
        pc = PUBLISHED.get(name, {}).get("PC", (None, None))[0]
        speedup = f"{pc / r['p50_ms']:.2f}x" if pc and r["p50_ms"] else "-"
        ok = "ok " if r["meets_deadline"] else "MISS"
        print(
            f"{name:<16} {r['p50_ms']:>9.3f} {r['p95_ms']:>9.3f} "
            f"{ok:>5}{r['threshold_ms']:>5.1f} "
            f"{pc if pc else '-':>8} {speedup:>7}  {NOTES.get(name, '')}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
