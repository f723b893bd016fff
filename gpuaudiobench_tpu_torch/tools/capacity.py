"""Real-time capacity search: the largest workload the card sustains.

PyTorch counterpart of the reference's ``tools/capacity.py``: the DAFx-24
poster's question "at what scale does GPU audio still make the buffer
deadline?" answered directly, by a search over a workload knob (modal
modes, the track count, FDTD3D's room) for the largest value whose
SATURATED p99 stays at or under the buffer deadline (1000*bufferSize/fs
ms, cuda/globals.cu:55). Device timing is off during the search and on
for one confirmation run at the found capacity (method "cuda-events",
the port's device tier).

Search semantics (``search_capacity``, the reference's): the pass/fail is
assumed monotone in the knob. Geometric ascent from --lo until the first
miss, then bisection to the --quantum, bounded by --maxEvals probes.

Walls (``classify_wall``): a probe that runs and misses is the
"deadline" wall. A probe that raises is "memory" for an allocation
failure (``torch.cuda.OutOfMemoryError``, CUDA error 2), which leaves
the process usable and counts as a miss, as in the reference. Any other
CUDA error ("device") is sticky: it poisons the process's CUDA context,
so every later probe would fail too. The search stops at it, in the
process (no child process a probe), records the error and the probes so
far (``stopped``), runs no confirmation and exits 1. The reference's
"transport" wall (its relay's HTTP 413) has no counterpart here.

Each probe releases what it held before the next: the benchmark, its
graphs and their memory pool go out of scope, then ``gc.collect()`` and
``torch.cuda.empty_cache()`` (the reference's ``jax.clear_caches()``).

``render_md`` flags a row whose device p50 exceeds its own saturated p50
(a block's busy time above the wall a block: the two tiers disagree),
which the reference prints unflagged (``VERDICT.md`` weak #3).

Usage:
  python -m gpuaudiobench_tpu_torch.tools.capacity --benchmark ModalFilterBank
  python -m gpuaudiobench_tpu_torch.tools.capacity --benchmark FDTD3D \\
      --set fdtd_per_track_receivers=true --json out.json --md out.md
  ... --confirmOnly 108 (one fresh process a confirmation)
  add --device cpu to run on the CPU (tests).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import sys

# benchmark -> (BenchConfig field, lo, hi, quantum). Everything not
# listed scales on the track axis. The quanta are the reference's (128
# tracks, 1,024 modes, 2 rooms), so rows compare with its tables; the
# ceilings are the card's.
KNOBS = {
    "ModalFilterBank": ("modal_num_modes", 1024, 1 << 24, 1024),
    # PartConv's memory_report at the 1 s (48,000-tap) IR, bytes a track:
    # shift 779,744, ring 1,165,520 (its spectra doubled), nupols
    # 1,352,120 (the doubled tail ring). 80 GB holds the largest for
    # 59,167 tracks: hi is that on the 128-track quantum. The stream's
    # copies of the state fill the card before it; an allocation failure
    # is a "memory" wall, not a miss of the deadline.
    "PartConv": ("n_tracks", 128, 59136, 128),
    # FDTD3D's load axis is the room, not the track count (one shared
    # field; grid = room + 2). 128 is the largest room the port's config
    # and kernels take (config.py).
    "FDTD3D": ("fdtd_room", 16, 128, 2),
}
TRACK_KNOB = ("n_tracks", 128, 1 << 16, 128)
EXCLUDED = ("NoOp", "SOL_", "datacopy")
# A row whose confirmation's device p50 exceeds its saturated p50.
DEVICE_OVER_SATURATED = "device p50 > sat p50"


class StickyDeviceError(RuntimeError):
    """A CUDA error other than an allocation failure: the process's CUDA
    context is poisoned, so the search stops."""


def quantize(v: int, quantum: int, lo: int) -> int:
    return max(lo, (v // quantum) * quantum)


def classify_wall(err: str) -> str:
    """What stopped a failed probe, from its error text
    (``"<type>: <message>"``). A deadline miss never raises, so an
    exception is not the reference's criterion:
      memory -- an allocation failed (``OutOfMemoryError``, "out of
                memory", a kernel wrapper's CUDA error 2); the process
                can go on;
      device -- any other CUDA error (``AcceleratorError``, "CUDA
                error", an illegal access, a device-side assert): sticky,
                the search stops;
      error  -- anything else (investigate the probe record)."""
    low = err.lower()
    if ("outofmemoryerror" in low or "out of memory" in low
            or re.search(r"cuda error 2\b", low)):
        return "memory"
    if ("acceleratorerror" in low or "cuda error" in low
            or "cudaerror" in low or "illegal memory access" in low
            or "device-side assert" in low):
        return "device"
    return "error"


def search_capacity(evaluate, lo, hi, quantum, max_evals):
    """Largest v in [lo, hi] (quantum grid) with evaluate(v) True.

    evaluate(v) -> bool, assumed monotone (True below some threshold).
    Returns (capacity, probes, ceiling_hit):
      capacity     None if even lo fails; otherwise the largest passing
                   value the probe budget could certify.
      probes       [(value, passed), ...] in evaluation order.
      ceiling_hit  True if hi itself passed (real capacity may exceed hi).
    """
    if lo % quantum or hi % quantum:
        raise ValueError("lo and hi must be multiples of quantum")
    if lo > hi:
        raise ValueError("lo > hi")
    probes = []

    def ev(v):
        ok = bool(evaluate(v))
        probes.append((v, ok))
        return ok

    if not ev(lo):
        return None, probes, False
    good, bad = lo, None
    # Geometric ascent: doubling finds the miss region in log probes.
    v = lo
    while v < hi and len(probes) < max_evals:
        v = min(v * 2, hi)
        if ev(v):
            good = v
        else:
            bad = v
            break
    # Bisection between the last pass and the first miss.
    while bad is not None and bad - good > quantum and len(probes) < max_evals:
        mid = quantize((good + bad) // 2, quantum, lo)
        if mid <= good or mid >= bad:
            break
        if ev(mid):
            good = mid
        else:
            bad = mid
    return good, probes, bad is None and good == hi


def knob_for(benchmark: str):
    if any(benchmark.startswith(p) for p in EXCLUDED):
        raise SystemExit(
            f"{benchmark}: no capacity knob (NoOp/speedoflight measure "
            "overhead, not load; datacopy* are round-trip transfer "
            "benchmarks with no saturated tier)")
    return KNOBS.get(benchmark, TRACK_KNOB)


def release_device() -> None:
    """Free what a finished probe held: its objects (graphs, their pool),
    then the allocator's cached blocks."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def harness_probe(benchmark, field, args, device_timing=False):
    """Returns evaluate(value) -> (sustains, detail dict)."""
    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.harness.runner import run_benchmark
    from gpuaudiobench_tpu_torch.registry import create_benchmark
    from gpuaudiobench_tpu_torch.utils import device as dv

    torch_dev = dv.device(args.device)

    def evaluate(value):
        cfg = BenchConfig(
            fs=args.fs,
            buffer_size=args.bufferSize,
            n_runs=args.nRuns,
            warmup=args.warmup,
            pipeline_depth=args.pipelineDepth,
            saturated_reps=args.satReps,
            verification=args.verification,
            write_latencies=False,
            quiet=True,
            device_timing=device_timing,
            **dict(parse_overrides(args.set), **{field: value}),
        )
        cfg.validate()
        b = create_benchmark(benchmark, cfg, torch_dev)
        try:
            b.setup()
            r = run_benchmark(b, cfg, verbose=False)
            b.cleanup()
        finally:
            del b
            release_device()
        valid = r.validation is None or r.validation.passed
        ss = r.saturated_statistics
        p99 = ss.p99 if ss else float("inf")
        deadline = cfg.deadline_ms() * (1.0 - args.margin)
        detail = {
            "value": value,
            "saturated_p50_ms": round(ss.median, 4) if ss else None,
            "saturated_p99_ms": round(p99, 4) if ss else None,
            "valid": valid,
            "device_p50_ms": (round(r.device_statistics.median, 4)
                              if r.device_statistics else None),
            # The device tier's method ("cuda-events" on the card).
            "device_method": (r.device_timing_method
                              if r.device_statistics else None),
        }
        return valid and p99 <= deadline, detail

    return evaluate


def parse_overrides(pairs):
    """--set FIELD=VALUE list -> BenchConfig kwargs, coerced to the
    dataclass field's type (unknown fields raise with the field list,
    so a typo cannot silently probe the default config)."""
    import dataclasses

    from gpuaudiobench_tpu_torch.config import BenchConfig

    types = {f.name: f.type for f in dataclasses.fields(BenchConfig)}
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--set needs FIELD=VALUE, got {pair!r}")
        name, raw = pair.split("=", 1)
        if name not in types:
            raise SystemExit(
                f"--set: unknown BenchConfig field {name!r}")
        t = types[name]
        if t in ("bool", bool):
            out[name] = raw.lower() in ("1", "true", "yes", "on")
        elif t in ("int", int) or "int" in str(t):
            out[name] = int(raw)
        elif t in ("float", float) or "float" in str(t):
            out[name] = float(raw)
        else:
            out[name] = raw
    return out


def _failure(value, e: Exception) -> dict:
    text = f"{type(e).__name__}: {e}"
    return {"value": value, "error": text, "wall_class": classify_wall(text)}


def run_confirm_only(benchmark: str, args) -> dict:
    """No search: archive-grade confirmation probe(s) at explicit knob
    value(s) (--confirmOnly v1[,v2,...]) with device timing on. Run each
    invocation in its own process; --satReps >= 101 makes the p99 a real
    percentile. A sticky CUDA error stops the list there."""
    field = args.knob or knob_for(benchmark)[0]
    if args.knob:
        parse_overrides([f"{field}=0"])  # existence check (typed)
    deadline = 1000.0 * args.bufferSize / args.fs
    values = [int(v) for v in str(args.confirmOnly).split(",")]
    probe = harness_probe(benchmark, field, args, device_timing=True)
    confirms = []
    stopped = None
    for v in values:
        print(f"confirm: {benchmark} {field}={v} "
              f"(satReps {args.satReps}, verification "
              f"{args.verification})", flush=True)
        try:
            ok, d = probe(v)
            d["sustains"] = ok
        except Exception as e:  # noqa: BLE001 - record, don't crash
            d = dict(_failure(v, e), saturated_p99_ms=None, sustains=False)
        confirms.append(d)
        print(f"  {field}={v}: sat p50 {d.get('saturated_p50_ms')} "
              f"p99 {d.get('saturated_p99_ms')} ms vs {deadline:.3f} -> "
              f"{'sustains' if d['sustains'] else 'MISSES'}", flush=True)
        if d.get("wall_class") == "device":
            stopped = d["error"]
            break
    record = {
        "benchmark": benchmark,
        "knob": field,
        "kind": "confirm",
        "deadline_ms": deadline,
        "buffer_size": args.bufferSize,
        "fs": args.fs,
        "pipeline_depth": args.pipelineDepth,
        "saturated_reps": args.satReps,
        "config_overrides": parse_overrides(args.set),
        "confirms": confirms,
    }
    if stopped:
        record["stopped"] = stopped
    return record


def run_one(benchmark: str, args) -> dict:
    """Search one benchmark's capacity; returns the JSON-able record."""
    if getattr(args, "confirmOnly", ""):
        return run_confirm_only(benchmark, args)
    if args.knob:
        # Explicit knob (e.g. ir_length for PartConv's real-time IR
        # length): the caller supplies the range.
        if args.lo is None or args.hi is None or args.quantum is None:
            raise SystemExit("--knob requires --lo/--hi/--quantum")
        field, lo, hi, quantum = (args.knob, args.lo, args.hi,
                                  args.quantum)
        parse_overrides([f"{field}=0"])  # existence check (typed)
    else:
        field, lo, hi, quantum = knob_for(benchmark)
        lo = args.lo if args.lo is not None else lo
        hi = args.hi if args.hi is not None else hi
        quantum = args.quantum if args.quantum is not None else quantum
    deadline = 1000.0 * args.bufferSize / args.fs

    print(f"capacity: {benchmark} knob={field} range=[{lo}, {hi}] "
          f"quantum={quantum} deadline={deadline:.3f} ms "
          f"(buffer {args.bufferSize} @ {args.fs} Hz, margin {args.margin})")

    probe = harness_probe(benchmark, field, args)
    details = []
    outcomes = []  # (value, passed) of every probe, as search_capacity's

    def flush_partial():
        # A timeout mid-bisection must not lose the probes so far: after
        # every probe the trace is written beside the final JSON, which
        # replaces it on completion.
        if not getattr(args, "json", None):
            return
        with open(args.json + ".partial", "w") as f:
            json.dump({"benchmark": benchmark, "knob": field,
                       "incomplete": True, "probes": details}, f,
                      indent=2)

    def evaluate(v):
        try:
            ok, d = probe(v)
        except Exception as e:  # noqa: BLE001 - classified below
            fail = _failure(v, e)
            details.append(fail)
            outcomes.append((v, False))
            flush_partial()
            if fail["wall_class"] == "device":
                print(f"  probe {field}={v}: FAILED ({fail['error']}) -> "
                      "sticky CUDA error; the search stops",
                      file=sys.stderr)
                raise StickyDeviceError(fail["error"]) from e
            print(f"  probe {field}={v}: FAILED ({type(e).__name__}) "
                  "-> treated as infeasible", file=sys.stderr)
            return False
        details.append(d)
        outcomes.append((v, ok))
        flush_partial()
        print(f"  probe {field}={v}: sat p99 "
              f"{d['saturated_p99_ms']} ms -> "
              f"{'sustains' if ok else 'MISSES' if d['valid'] else 'INVALID'}")
        if not d["valid"]:
            print(f"  WARNING: validation failed at {field}={v}; "
                  "treated as infeasible but investigate", file=sys.stderr)
        return ok

    stopped = None
    try:
        capacity, probes, ceiling = search_capacity(
            evaluate, lo, hi, quantum, args.maxEvals)
    except StickyDeviceError as e:
        stopped, probes, ceiling = str(e), outcomes, False
        capacity = max((v for v, ok in probes if ok), default=None)

    confirm = None
    if capacity is not None and stopped is None:
        # Confirmation at the found capacity with device timing on.
        # Release everything the search held first: near a memory wall
        # the failed probes can leave the allocator fragmented.
        release_device()
        cargs = argparse.Namespace(**vars(args))
        if args.confirmVerification:
            cargs.verification = args.confirmVerification
        try:
            ok, confirm = harness_probe(
                benchmark, field, cargs, device_timing=True)(capacity)
            confirm["sustains"] = ok
        except Exception as e:  # noqa: BLE001
            confirm = dict(_failure(capacity, e), saturated_p99_ms=None)
            print(f"  confirmation at {field}={capacity} FAILED: {e}",
                  file=sys.stderr)

    # Budget-ended searches are lower bounds, not capacities: (a) no miss
    # was observed and hi was not reached; (b) a miss was observed but
    # the boundary was only localized to a gap coarser than --quantum.
    fail_vals = [v for v, ok in probes if not ok]
    pass_vals = [v for v, ok in probes if ok]
    boundary_gap = (min(fail_vals) - max(pass_vals)
                    if fail_vals and pass_vals else None)
    # Which wall bounds the capacity: the deadline (a probe that ran and
    # missed), or the wall of the bounding probe that raised.
    wall_class = None
    if fail_vals:
        bounding = min(fail_vals)
        for d in details:
            if d.get("value") == bounding and "error" in d:
                wall_class = d["wall_class"]
                break
        else:
            wall_class = "deadline"
    budget_exhausted = (capacity is not None and not ceiling
                        and (stopped is not None or not fail_vals
                             or (boundary_gap is not None
                                 and boundary_gap > quantum)))
    record = {
        "benchmark": benchmark,
        "knob": field,
        "capacity": capacity,
        "ceiling_hit": ceiling,
        "budget_exhausted": budget_exhausted,
        "boundary_gap": boundary_gap,
        "deadline_ms": deadline,
        "margin": args.margin,
        "buffer_size": args.bufferSize,
        "fs": args.fs,
        "pipeline_depth": args.pipelineDepth,
        "saturated_reps": args.satReps,
        "config_overrides": parse_overrides(args.set),
        "wall_class": wall_class,
        "probes": details,
        "confirmation": confirm,
    }
    if stopped is not None:
        record["stopped"] = stopped
        print(f"RESULT: {benchmark} search stopped by a sticky CUDA error "
              f"at {field}={details[-1]['value']}: {stopped}")
        return record

    if capacity is None:
        print(f"RESULT: {benchmark} misses deadline even at {field}={lo}")
        return record
    if ceiling:
        qualifier = " (>= search ceiling; raise --hi)"
    elif budget_exhausted and fail_vals:
        qualifier = (f" (>= only: budget ended bisection with the "
                     f"boundary localized to a {boundary_gap}-wide gap, "
                     f"not --quantum {quantum}; raise --maxEvals)")
    elif budget_exhausted:
        qualifier = (" (>= only: probe budget exhausted before a miss; "
                     "raise --maxEvals)")
    else:
        qualifier = ""
    if wall_class and wall_class != "deadline":
        qualifier += (f" [bounded by a {wall_class} wall, not the "
                      "deadline]")
    print(f"RESULT: {benchmark} sustains {field}={capacity}{qualifier} "
          f"at buffer {args.bufferSize} @ {args.fs} Hz "
          f"(sat p99 {confirm.get('saturated_p99_ms')} ms vs "
          f"{deadline:.3f} ms deadline"
          + (f", device p50 {confirm['device_p50_ms']} ms" if
             confirm.get("device_p50_ms") is not None else "") + ")")
    if confirm is not None and not confirm.get("sustains", True):
        print("NOTE: confirmation run regressed past the deadline; the "
              "boundary is noise-adjacent -- re-run with --margin 0.05",
              file=sys.stderr)
    return record


def device_over_saturated(confirmation) -> bool:
    """Whether a confirmation's device p50 exceeds its own saturated p50:
    a block's busy time above the wall time a block."""
    c = confirmation or {}
    dev, sat = c.get("device_p50_ms"), c.get("saturated_p50_ms")
    return dev is not None and sat is not None and dev > sat


def render_md(records, path=None):
    """Markdown table of capacity records; returns the markdown string
    and writes it to ``path`` when one is given. The reference's table
    with one more column, ``flag``: ``DEVICE_OVER_SATURATED`` where the
    device p50 exceeds the saturated p50."""
    lines = [
        "# Real-time capacity (saturated p99 vs buffer deadline)",
        "",
        f"Deadline {records[0]['deadline_ms']:.3f} ms (buffer "
        f"{records[0]['buffer_size']} @ {records[0]['fs']} Hz); criterion "
        "= largest knob value whose saturated p99 meets it "
        "(tools/capacity.py).",
        "",
        "| Benchmark | Knob | Capacity | sat p50 ms | sat p99 ms |"
        " device p50 ms [method] | note | flag |",
        "|---|---|---:|---:|---:|---:|---|---|",
    ]
    for r in records:
        c = r.get("confirmation") or {}
        if r["ceiling_hit"]:
            note = ">= search ceiling"
        elif r["capacity"] is None:
            note = "below lo"
        elif r.get("budget_exhausted"):
            gap = r.get("boundary_gap")
            note = (f">= only (budget; boundary gap {gap})"
                    if gap is not None else ">= only (budget)")
        else:
            note = ""
        wc = r.get("wall_class")
        if wc and wc != "deadline":
            wall = f"{wc} wall"
            note = f"{note}; {wall}" if note else wall
        over = r.get("config_overrides") or {}
        if over:
            pairs = " ".join(f"{k}={v}" for k, v in sorted(over.items()))
            note = f"{note}; {pairs}" if note else pairs
        dev = c.get("device_p50_ms")
        meth = c.get("device_method")
        dev_s = ("—" if dev is None
                 else f"{dev} [{meth}]" if meth else f"{dev}")
        # A bracketed row's Capacity cell carries the certified point and
        # names the edge.
        br = r.get("bracket")
        cap_s = (f"{r['capacity']} (edge {br['edge']})" if br
                 else f"{r['capacity'] if r['capacity'] is not None else '—'}")
        if br:
            note = f"{note}; {br['note']}" if note else br["note"]
        if r.get("confirm_reps"):
            conf_note = f"confirm n={r['confirm_reps']}"
            note = f"{note}; {conf_note}" if note else conf_note
        flag = DEVICE_OVER_SATURATED if device_over_saturated(c) else ""
        lines.append(
            f"| {r['benchmark']} | {r['knob']} | "
            f"{cap_s} | "
            f"{c.get('saturated_p50_ms', '—')} | "
            f"{c.get('saturated_p99_ms', '—')} | "
            f"{dev_s} | {note} | {flag} |")
    text = "\n".join(lines) + "\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
        print(f"written: {path}")
    return text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gpuaudiobench_tpu_torch.tools.capacity",
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--benchmark", required=True, action="append",
                    help="repeatable; with several benchmarks the "
                         "per-benchmark default ranges apply "
                         "(--lo/--hi/--quantum must be unset)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default) or the CPU")
    ap.add_argument("--fs", type=int, default=48000)
    ap.add_argument("--bufferSize", type=int, default=512)
    ap.add_argument("--lo", type=int, default=None)
    ap.add_argument("--hi", type=int, default=None)
    ap.add_argument("--quantum", type=int, default=None)
    ap.add_argument("--maxEvals", type=int, default=12,
                    help="probe budget; each probe is a set-up + run")
    ap.add_argument("--nRuns", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--pipelineDepth", type=int, default=256)
    ap.add_argument("--satReps", type=int, default=11)
    ap.add_argument("--verification", default="spot",
                    help="validation mode during search probes; 'none' "
                         "skips the host golden (linear in workload size "
                         "-- minutes at 10M+ modes)")
    ap.add_argument("--confirmVerification", default="",
                    help="validation mode for the confirmation run at "
                         "the found capacity (default: same as "
                         "--verification)")
    ap.add_argument("--margin", type=float, default=0.0,
                    help="safety fraction shaved off the deadline "
                         "(0.1 = require p99 <= 90%% of deadline); the "
                         "reference criterion is exactly p99 <= deadline")
    ap.add_argument("--json", default="",
                    help="write the search record(s) to this path (one "
                         "object for a single benchmark, a list for "
                         "several)")
    ap.add_argument("--md", default="",
                    help="write a markdown capacity table to this path")
    ap.add_argument("--set", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="BenchConfig override applied to every probe "
                         "(e.g. --set partconv_form=nupols); recorded "
                         "in the JSON as config_overrides")
    ap.add_argument("--knob", default="",
                    metavar="FIELD",
                    help="search this BenchConfig field instead of the "
                         "benchmark's default knob (requires "
                         "--lo/--hi/--quantum)")
    ap.add_argument("--confirmOnly", default="",
                    metavar="V1[,V2,...]",
                    help="no search: confirmation probe(s) at these knob "
                         "values (device timing on; one fresh process "
                         "per invocation; --satReps >= 101 for boundary "
                         "certification)")
    args = ap.parse_args(argv)

    if len(args.benchmark) > 1 and (args.lo is not None or
                                    args.hi is not None or
                                    args.quantum is not None):
        ap.error("--lo/--hi/--quantum apply to a single --benchmark; "
                 "with several, the per-benchmark defaults are used")

    records = []
    for b in args.benchmark:
        records.append(run_one(b, args))
        if records[-1].get("stopped"):
            break  # the CUDA context is poisoned

    if args.json:
        payload = records[0] if len(records) == 1 else records
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"written: {args.json}")
        partial = args.json + ".partial"
        if os.path.exists(partial):  # superseded by the real record
            os.remove(partial)
    if args.md:
        render_md(records, args.md)

    def ok(r):
        if r.get("stopped"):
            return False
        if r.get("kind") == "confirm":
            return all(c.get("sustains") for c in r["confirms"])
        return r["capacity"] is not None

    return 0 if len(records) == len(args.benchmark) and all(
        ok(r) for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
