"""Regression comparison of two of the port's JSON artifacts.

The port's copy of the repo-level ``tools/compare_runs.py`` (the WebGPU
Statistics module's A/B compare, webgpu/js/core/Statistics.js, at suite
scale): given two JSON artifacts of the port's CLI (the same file
before and after a kernel change, or two runs on two cards), report the
per-benchmark delta on each timing tier with a noise-aware verdict -- a
delta only counts as a regression or an improvement when it exceeds
what the two runs' own run-to-run variation (CV) explains.

Tiers compared per benchmark, when both runs carry them:
  * device    -- device_statistics.median_ms (the card's time a block)
  * saturated -- saturated.p50_ms (throughput)
  * roundtrip -- statistics.p50_ms (the deployment path)

Exit code 1 when any REGRESSED verdict is emitted on the device or
saturated tier; the round-trip tier, which carries the host's copies
and scheduling, is reported but never gates.

Saturated-tier cross-check: the reps of one run share the host's state
(its clock, its other load), so within-run CV understates the saturated
tier's between-run variation. A saturated slowdown with the SAME
benchmark's device tier unchanged ran the same launches at the same
speed on the card; it is downgraded to a non-gating 'wall-drift'
verdict. The downgrade is bounded: beyond WALL_DRIFT_CEILING_PCT (25 %)
a device-same wall jump is more than drift explains -- likely a real
host or launch-path problem -- and gates anyway. The device tier is the
corroborating witness: saturated also still gates whenever the device
tier is missing or regressed. To audit host-side launch-path changes,
which a device-same cross-check would mask, pass --strict-wall to
restore unconditional saturated gating.

Waivers: a gating regression that a human has investigated and
explained can be waived with --waive 'NAME:TIER:reason'. The waiver is
surfaced in the output (verdict 'waived: reason'), applies to exactly
one benchmark and tier, and MUST be consumed -- a waiver whose row does
not gate is an error (exit 2), so stale waivers cannot outlive the
regression they explained.

Usage:
  python -m gpuaudiobench_tpu_torch.tools.compare_runs OLD.json NEW.json
      [--threshold-pct 5] [--all] [--strict-wall]
      [--waive 'NAME:TIER:reason' ...]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

from gpuaudiobench_tpu_torch.analysis.compare import card_label

# CUDA-event device medians resolve ~1 µs; deltas below this absolute
# floor are never significant on that tier.
DEVICE_ABS_FLOOR_MS = 0.001

# Largest saturated-tier delta attributed to between-run wall drift with
# the device tier unchanged; beyond it a device-same wall regression
# gates regardless.
WALL_DRIFT_CEILING_PCT = 25.0

TIERS = (
    # (name, extractor, cv extractor, gates exit code)
    ("device",
     lambda r: (r.get("device_statistics") or {}).get("median_ms"),
     lambda r: None,  # no per-tier CV recorded; abs floor applies
     True),
    ("saturated",
     lambda r: (r.get("saturated") or {}).get("p50_ms"),
     lambda r: (r.get("saturated") or {}).get("cv_percent"),
     True),
    ("roundtrip",
     lambda r: (r.get("statistics") or {}).get("p50_ms"),
     lambda r: (r.get("statistics") or {}).get("cv_percent"),
     False),
)


def _index(path: str) -> Dict[str, dict]:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = [data]
    return {r["benchmark"]: r for r in data}


def verdict(old: float, new: float, noise_pct: float,
            abs_floor: float = 0.0) -> Tuple[float, str]:
    """(delta_pct, verdict). delta > 0 means NEW is slower. A change
    within the runs' own variation band -- or below the tier's absolute
    resolution floor -- is 'same'."""
    if not old or not new:
        return 0.0, "n/a"
    delta = (new - old) / old * 100.0
    if abs(delta) <= noise_pct or abs(new - old) <= abs_floor:
        return delta, "same"
    return delta, ("REGRESSED" if delta > 0 else "improved")


def compare(old_path: str, new_path: str, threshold_pct: float = 5.0,
            strict_wall: bool = False,
            waivers: Optional[Dict[Tuple[str, str], str]] = None):
    """Returns (rows, gating_regressions). Each row:
    (benchmark, tier, old, new, delta_pct, verdict).

    ``waivers`` maps (benchmark, tier) -> reason; a gating REGRESSED row
    with a waiver becomes non-gating 'waived: reason'. Every waiver must
    be consumed by a row that gates, else ValueError -- a stale waiver is
    a bug, not a no-op.
    """
    waivers = dict(waivers or {})
    old_idx, new_idx = _index(old_path), _index(new_path)
    rows: List[tuple] = []
    gating: List[tuple] = []
    for name, old_r in old_idx.items():
        new_r = new_idx.get(name)
        if new_r is None:
            rows.append((name, "-", None, None, 0.0, "missing in new"))
            continue
        # Same-workload guard: a delta between runs of different shapes
        # (nTracks, bufferSize, ...) is another benchmark, not a
        # regression. Flag, don't gate.
        oc = old_r.get("configuration") or {}
        nc = new_r.get("configuration") or {}
        diff_keys = sorted(
            k for k in set(oc) | set(nc)
            if k != "nRuns" and oc.get(k) != nc.get(k))
        if diff_keys:
            rows.append((name, "-", None, None, 0.0,
                         f"config mismatch ({', '.join(diff_keys)})"))
            continue
        tier_verdicts: Dict[str, str] = {}
        for tier, get, get_cv, gates in TIERS:
            ov, nv = get(old_r), get(new_r)
            if ov is None or nv is None:
                continue
            # Noise band: the larger of the threshold and both runs' own
            # CVs (a tier that wobbles 12 % run to run cannot evidence an
            # 8 % regression).
            cvs = [c for c in (get_cv(old_r), get_cv(new_r))
                   if c is not None]
            noise = max([threshold_pct] + cvs)
            floor = DEVICE_ABS_FLOOR_MS if tier == "device" else 0.0
            d, v = verdict(ov, nv, noise, abs_floor=floor)
            # Cross-check (docstring): a saturated REGRESSED whose device
            # tier measured 'same' is wall drift. 'improved' does NOT
            # qualify: an improved device tier means the code changed,
            # and a change can speed the block while adding
            # streaming-only work the device tier never sees, so a wall
            # regression there must gate and be explained by a human.
            if (tier == "saturated" and v == "REGRESSED"
                    and not strict_wall
                    and d <= WALL_DRIFT_CEILING_PCT
                    and tier_verdicts.get("device") == "same"):
                v = "wall-drift"
            tier_verdicts[tier] = v
            if gates and v == "REGRESSED" and (name, tier) in waivers:
                v = f"waived: {waivers.pop((name, tier))}"
            rows.append((name, tier, ov, nv, d, v))
            if gates and v == "REGRESSED":
                gating.append((name, tier, d))
    for name in new_idx:
        if name not in old_idx:
            rows.append((name, "-", None, None, 0.0, "new benchmark"))
    if waivers:
        stale = ", ".join(f"{n}:{t}" for n, t in waivers)
        raise ValueError(
            f"unconsumed waiver(s) for rows that do not gate: {stale}")
    return rows, gating


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    """Reads two result files only: ``device`` is taken for the tools'
    common signature and runs nothing."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_json")
    ap.add_argument("new_json")
    ap.add_argument("--threshold-pct", type=float, default=5.0,
                    help="minimum noise band (default 5%%)")
    ap.add_argument("--all", action="store_true",
                    help="print 'same' rows too")
    ap.add_argument("--strict-wall", action="store_true",
                    help="gate saturated regressions even when the "
                         "device tier is unchanged")
    ap.add_argument("--waive", action="append", default=[],
                    metavar="NAME:TIER:REASON",
                    help="waive one investigated gating regression; "
                         "must actually gate or this errors (exit 2)")
    args = ap.parse_args(argv)
    waivers = {}
    for w in args.waive:
        parts = w.split(":", 2)
        if len(parts) != 3 or not parts[2].strip():
            print(f"--waive needs NAME:TIER:REASON, got {w!r}")
            return 2
        waivers[(parts[0], parts[1])] = parts[2].strip()
    try:
        rows, gating = compare(args.old_json, args.new_json,
                               args.threshold_pct,
                               strict_wall=args.strict_wall,
                               waivers=waivers)
    except ValueError as e:
        print(f"error: {e}")
        return 2
    cards = [card_label(next((r.get("device") for r in _index(p).values()
                              if r.get("device")), None))
             for p in (args.old_json, args.new_json)]
    print(f"old: {cards[0]}; new: {cards[1]}")
    print(f"{'benchmark':<28} {'tier':<10} {'old ms':>10} {'new ms':>10} "
          f"{'delta':>8}  verdict")
    for name, tier, ov, nv, d, v in rows:
        if v == "same" and not args.all:
            continue
        ov_s = f"{ov:.4f}" if ov is not None else "—"
        nv_s = f"{nv:.4f}" if nv is not None else "—"
        print(f"{name:<28} {tier:<10} {ov_s:>10} {nv_s:>10} "
              f"{d:>+7.1f}%  {v}")
    n_same = sum(1 for r in rows if r[5] == "same")
    print(f"\n{len(rows)} comparisons: {n_same} within noise, "
          f"{sum(1 for r in rows if r[5] == 'improved')} improved, "
          f"{sum(1 for r in rows if r[5] == 'REGRESSED')} regressed "
          f"({len(gating)} on gating tiers)")
    return 1 if gating else 0


if __name__ == "__main__":
    raise SystemExit(main())
