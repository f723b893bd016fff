"""Write the port's headline block of a markdown file from its artifacts.

The port's copy of the repo-level ``tools/readme_headline.py``: the
headline sentences are generated from the same artifacts as the tables,
between ``<!-- torch-headline:begin -->`` and
``<!-- torch-headline:end -->``, and ``--check`` exits 1 when the block
has drifted from them. The sources, each read from ``--artifacts DIR``
where it is there (a missing source leaves its sentence out):

* ``bench.json``: the JSON line of ``python -m gpuaudiobench_tpu_torch.bench``
  (the modal headline: ms a block, blocks/s, against the RTX 4070);
* ``RESULTS.json``: the suite JSON of ``tools.regen_artifacts`` (the modal
  row's roofline share and its mode count);
* ``cap_*.json``: the capacity ledgers of ``tools.build_capacity_ledger``;
* ``overlap.json``: the JSON of ``tools.overlap_campaign`` (the range of
  its speedups).

The block names the card and its power limit (from the bench line, else
the suite's or the campaign's JSON). The file is given by path (there is
no default); a file without the port's pair of sentinels is refused, and
the reference's own headline block (``<!-- headline:begin -->``) is
never touched.

Usage:
    python -m gpuaudiobench_tpu_torch.tools.readme_headline FILE.md --artifacts DIR
    python -m gpuaudiobench_tpu_torch.tools.readme_headline FILE.md --artifacts DIR --check
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import List, Optional

from gpuaudiobench_tpu_torch.analysis.compare import card_label

BEGIN, END = "<!-- torch-headline:begin -->", "<!-- torch-headline:end -->"
BASELINE_PC_P50_MS = 3.168  # BASELINE.md tab4: Modal 1M, RTX 4070 p50
BENCH, SUITE, OVERLAP, CAPACITY = (
    "bench.json", "RESULTS.json", "overlap.json", "cap_*.json")


def _load(path: str):
    """A JSON file, or the last JSON object line of a file holding the
    bench's printed output; None where there is no such file."""
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    for line in reversed(text.splitlines()):
        try:
            cand = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(cand, dict):
            return cand
    return None


def _card(bench, suite, overlap) -> str:
    if bench and bench.get("device_name"):
        return (f"{bench['device_name']}, "
                f"{bench.get('power_limit') or 'power limit not read'}")
    for r in suite:
        if r.get("device"):
            return card_label(r["device"])
    if overlap and overlap.get("card"):
        return overlap["card"]
    return "card not recorded"


def generate(artifacts: str) -> str:
    bench = _load(os.path.join(artifacts, BENCH))
    if bench is not None and "value" not in bench:
        bench = None
    suite = _load(os.path.join(artifacts, SUITE)) or []
    if isinstance(suite, dict):
        suite = [suite]
    overlap = _load(os.path.join(artifacts, OVERLAP))
    parts = [f"**The PyTorch / CUDA port on {_card(bench, suite, overlap)}.**"]

    # -- the modal headline: bench.json ----------------------------------
    if bench:
        v = bench["value"]
        bps = bench.get("blocks_per_sec_per_chip", 1000.0 / v)
        ratio = bench.get("vs_baseline", BASELINE_PC_P50_MS / v)
        s = (f"1M-mode modal synthesis of a 512-sample block in **{v:.4f} "
             f"ms** (saturated rep-median, {bps:.0f} blocks/sec) against the "
             f"reference's {BASELINE_PC_P50_MS} ms on an RTX 4070: "
             f"**{ratio:.1f}× faster** (`{BENCH}`).")
        marg = bench.get("saturated_marginal_p50_ms")
        if marg:
            s += (f" The depth-differenced marginal cost a block, the "
                  f"chain's fixed launch and read cancelled, is "
                  f"**{marg:.4f} ms** ({1000.0 / marg:.0f} blocks/sec).")
        parts.append(s)

    # -- the modal suite row's roofline share: RESULTS.json --------------
    modal = next((r for r in suite
                  if r.get("benchmark") == "ModalFilterBank"), None)
    if modal:
        rl = (modal.get("metadata") or {}).get("roofline")
        modes = (modal.get("metadata") or {}).get("numModes")
        if rl and rl.get("flops_pct_of_peak") is not None:
            modes_s = f"{modes:,}-mode" if modes else "suite"
            parts.append(
                f"The {modes_s} suite configuration runs at "
                f"**{rl['achieved_gflops'] / 1000.0:.1f} TFLOP/s = "
                f"{rl['flops_pct_of_peak']:.0f}% of the card's "
                f"{rl['unit'].upper()} peak** ({rl.get('peak_source', '')}; "
                f"`{SUITE}`).")

    # -- capacity walls: cap_*.json ---------------------------------------
    walls = []
    for path in sorted(glob.glob(os.path.join(artifacts, CAPACITY))):
        cap = _load(path)
        if not cap or cap.get("capacity") is None:
            continue
        what = f"{cap.get('benchmark')} `{cap.get('knob')}`"
        bracket = cap.get("bracket")
        if bracket:
            walls.append(f"{what} **{bracket['certified']:,}** certified "
                         f"(edge {bracket['edge']:,}; "
                         f"`{os.path.basename(path)}`)")
        else:
            walls.append(f"{what} **{cap['capacity']:,}** "
                         f"({cap.get('wall_class') or 'deadline'} wall; "
                         f"`{os.path.basename(path)}`)")
    if walls:
        parts.append("Measured real-time capacity at 48 kHz (saturated p99 "
                     "against the deadline, confirmed in a fresh process): "
                     + "; ".join(walls) + ".")

    # -- overlapped infeed: overlap.json ----------------------------------
    ratios = sorted(r["speedup"] for r in (overlap or {}).get("rows", [])
                    if r.get("speedup"))
    if ratios:
        parts.append(
            f"Double-buffered infeed (`--overlapDepth`: pinned uploads on a "
            f"copy stream) measures **{ratios[0]:.2f}–{ratios[-1]:.2f}×** "
            f"over serial round trips across {len(ratios)} benchmarks "
            f"(`{OVERLAP}`).")

    return "\n".join([BEGIN] + parts + [END])


def process(path: str, artifacts: str, check: bool = False) -> bool:
    """Regenerate the port's headline block of ``path``; True when it
    changed (in ``check`` mode: would change)."""
    with open(path) as f:
        text = f.read()
    if BEGIN not in text or END not in text:
        raise ValueError(f"{path} has no {BEGIN} ... {END} markers")
    pattern = re.compile(re.escape(BEGIN) + r".*?" + re.escape(END), re.S)
    block = generate(artifacts)
    new_text = pattern.sub(lambda _: block, text, count=1)
    changed = new_text != text
    if changed and not check:
        with open(path, "w") as f:
            f.write(new_text)
    return changed


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    """Reads and writes files only: ``device`` is taken for the tools'
    common signature and runs nothing."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="the markdown file holding the port's "
                                 "headline sentinels")
    ap.add_argument("--artifacts", required=True,
                    help="the directory of the port's artifacts")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if the block drifted from the artifacts")
    args = ap.parse_args(argv)
    try:
        changed = process(args.path, args.artifacts, check=args.check)
    except ValueError as e:  # no sentinels of the port's own
        print(f"Error: {e}")
        return 1
    if args.check:
        if changed:
            print(f"{args.path}: the port's headline DRIFTED from "
                  f"{args.artifacts} (run without --check to regenerate)")
            return 1
        print(f"{args.path}: the port's headline matches {args.artifacts}")
        return 0
    print(f"{args.path}: the port's headline "
          + ("regenerated" if changed else "unchanged"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
