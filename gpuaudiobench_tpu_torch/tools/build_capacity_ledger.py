"""Assemble the capacity ledger with bracket semantics.

PyTorch port's copy of the reference's ``tools/build_capacity_ledger.py``
(pure JSON). Every capacity row carries the same class of evidence -- a
fresh-process confirm at the certified size -- and a boundary row
publishes the bracket [certified / edge] in the machine-readable record.

Inputs: for each family, the base SEARCH record
(``gpuaudiobench_tpu_torch.tools.capacity``'s search JSON) plus one
CONFIRM record (its ``--confirmOnly``, possibly several values). Output:
a merged record per family where

* ``capacity``  = the largest confirm-SUSTAINED value (the certified
  point -- the honest machine-readable number),
* ``bracket``   = {certified, edge, note} whenever the search found a
  larger value than the confirms certify (edge = the search's
  endpoint; note says what the confirm measured there),
* ``confirmation`` = the confirm detail at the certified size (device
  column included), ``confirm_reps`` = its rep count,
* ``device_over_saturated`` = whether that confirmation's device p50
  exceeds its own saturated p50 (``capacity.device_over_saturated``; the
  reference's ledger has no such field).

Usage:
  python -m gpuaudiobench_tpu_torch.tools.build_capacity_ledger out.json search.json confirm.json
  python -m gpuaudiobench_tpu_torch.tools.build_capacity_ledger out.json - confirm.json  # no search record
Then merge families with ``gpuaudiobench_tpu_torch.tools.merge_capacity``.
"""

from __future__ import annotations

import json
import sys

from gpuaudiobench_tpu_torch.tools.capacity import device_over_saturated


def build(search: dict | None, confirm: dict) -> dict:
    if confirm.get("kind") != "confirm":
        raise SystemExit("second input must be a --confirmOnly record")
    if search is None:
        # A row with no search record: the confirm record is the
        # evidence; synthesize the envelope.
        search = {
            "benchmark": confirm["benchmark"],
            "knob": confirm["knob"],
            "capacity": None,
            "ceiling_hit": False,
            "budget_exhausted": False,
            "boundary_gap": None,
            "deadline_ms": confirm["deadline_ms"],
            "margin": 0.0,
            "buffer_size": confirm["buffer_size"],
            "fs": confirm["fs"],
            "pipeline_depth": confirm["pipeline_depth"],
            "saturated_reps": confirm["saturated_reps"],
            "config_overrides": confirm.get("config_overrides", {}),
            "wall_class": None,
            "probes": [],
        }
    if confirm["benchmark"] != search["benchmark"]:
        raise SystemExit(
            f"benchmark mismatch: {search['benchmark']} vs "
            f"{confirm['benchmark']}")
    confirms = sorted(confirm["confirms"], key=lambda c: c["value"])
    sustained = [c for c in confirms if c.get("sustains")]
    certified = max((c["value"] for c in sustained), default=None)
    search_cap = search.get("capacity")
    edge_candidates = [c["value"] for c in confirms]
    if search_cap is not None:
        edge_candidates.append(search_cap)
    edge = max(edge_candidates, default=None)

    rec = dict(search)
    rec["capacity"] = certified
    rec["confirm_reps"] = confirm.get("saturated_reps")
    rec["confirmation"] = next(
        (c for c in confirms if c["value"] == certified), None)
    rec["device_over_saturated"] = device_over_saturated(rec["confirmation"])
    rec["all_confirms"] = confirms
    if edge is not None and certified is not None and edge > certified:
        edge_c = next((c for c in confirms if c["value"] == edge), None)
        if edge_c is not None:
            note = (f"edge confirm (n={confirm.get('saturated_reps')}): "
                    f"sat p50 {edge_c.get('saturated_p50_ms')} / p99 "
                    f"{edge_c.get('saturated_p99_ms')} ms vs "
                    f"{search['deadline_ms']:.3f}")
        else:
            note = "edge = search endpoint, not re-confirmed"
        rec["bracket"] = {"certified": certified, "edge": edge,
                         "note": note}
    else:
        rec.pop("bracket", None)
    return rec


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 3:
        print("usage: build_capacity_ledger.py out.json "
              "{search.json|-} confirm.json")
        return 2
    out, search_p, confirm_p = argv
    search = None if search_p == "-" else json.load(open(search_p))
    confirm = json.load(open(confirm_p))
    rec = build(search, confirm)
    with open(out, "w") as f:
        json.dump(rec, f, indent=2)
    b = rec.get("bracket")
    print(f"written: {out} capacity={rec['capacity']}"
          + (f" bracket=[{b['certified']} / {b['edge']}]" if b else "")
          + (" device p50 > sat p50" if rec["device_over_saturated"]
             else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
