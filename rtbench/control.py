"""Readings that the limits of ``correct`` are set from, on the card.

    python -m rtbench.control --workload <cell> --seconds <s> \
        [--seeds 1,2,...] [--control-seeds 7,8,9] \
        [--faults unchanged,half,...] [--fault-seeds 11,12,13] [--out FILE]

Every reading is one run of the cell at its own size, as ``rtbench.run``
runs it, with a window of ``--seconds``, judged by the harness's own
comparison (``harness.judge``):

* ``--seeds``: the program as it is; the lower readings.
* ``--control-seeds``: the program's window, then what it produced
  replaced by the reference computed in the next precision below the
  configuration's (each judge's ``control``, at the same blocks and
  callbacks) before it is judged; the upper readings. Each must come out
  as not correct.
* ``--faults`` on ``--fault-seeds``: the program with a fault of the
  cell's ``faults/<config>.<kind>.py`` planted underneath; each must come
  out as not correct.

The benchmark's own runs never run these. One JSON line a reading on
standard output, and all of them in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from rtbench import harness, spec


class Patches:
    """``patch(owner, name, value)`` as pytest's ``monkeypatch.setattr``;
    ``undo()`` restores every attribute it set."""

    def __init__(self):
        self._saved: List[tuple] = []

    def __call__(self, owner, name: str, value) -> None:
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self) -> None:
        while self._saved:
            owner, name, value = self._saved.pop()
            setattr(owner, name, value)


def reading(cell: spec.Cell, seed: int, seconds: float, device: torch.device,
            substitute: Optional[Callable] = None) -> Dict:
    out = harness.run_cell(cell, seed, seconds, False, device,
                           harness.Setup(time.perf_counter()), substitute)
    return {"correct": out["correct"], "failed": out["failed"],
            "numbers": out["numbers"], "info": out["info"],
            "attempted": out["attempted"], "setup_s": out["setup_s"],
            **{k: out[k] for k in ("block_ms", "roundtrip_p50_ms",
                                   "roundtrip_p95_ms") if k in out}}


def _seeds(text: str) -> List[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m rtbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("rtbench.control: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    check = cell.check()
    rows = []

    def emit(side: str, seed: int, row: Dict) -> None:
        row = {"workload": cell.name, "side": side, "seed": seed, **row}
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in _seeds(args.seeds):
        emit("program", seed, reading(cell, seed, args.seconds, device))
    for seed in _seeds(args.control_seeds):
        emit("control", seed, reading(
            cell, seed, args.seconds, device,
            lambda inputs, got: check.control(inputs, cell.config, got, device)))
    faults = cell.faults()
    for name in (f for f in args.faults.split(",") if f):
        for seed in _seeds(args.fault_seeds):
            patches = Patches()
            faults[name](patches)
            try:
                row = reading(cell, seed, args.seconds, device)
            finally:
                patches.undo()
            emit(f"fault:{name}", seed, row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
