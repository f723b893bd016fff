"""Buffer-64 low-latency floor: attribute the overlapped per-block cost.

PyTorch counterpart of the reference's ``tools/overlap64_attrib.py``. At
bufferSize 64 (a 1.333 ms deadline, cuda/globals.cu:55 basis) the
per-block cost of a streamed workload is split into its mechanisms, on
the port's overlap tier (``harness/overlap.py``: pinned sources, two
device slots, a copy stream):

* ``upload_only``: one pinned upload a block on the copy stream, one
  read at the end: the per-block host-to-device cost.
* ``dispatch_only``: one block of compute a block on a resident input,
  one read at the end: the per-block launch cost.
* ``serial``: upload, compute, probe read, a block at a time.
* ``overlapped``: upload k+1 while k computes, at depth 64, and
  ``overlapped_deep`` at depth 256 (does the floor amortize further?).
* ``batched_B``: B blocks an upload (``measure_overlap_batched``), which
  cuts uploads by B at the cost of B blocks of input buffering at the
  producer: throughput under the deadline, not end-to-end latency.

Verdict a workload: the best per-block time among the overlapped and
batched tiers (``MEASURED_TIERS``) against the 1.333 ms deadline. The
reference picks the best among every key ending in ``_ms``, its deadline
among them, so a workload could "pass" on the deadline itself; here only
a measured tier can be the best (``best_tier``).

Usage: python -m gpuaudiobench_tpu_torch.tools.overlap64_attrib
           [out_base] [--reps 5] [--workloads gain,IIRFilter]
           [--device cuda|cpu]
       (writes out_base.json and out_base.md; default out_base
        <temp dir>/overlap64)
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, Optional, Tuple

WORKLOADS = ["gain", "IIRFilter", "Conv1D", "DAWSessionMix"]
DEPTH = 64
DEEP_DEPTH = 256
BATCHES = (8, 32)
BUFFER_SIZE = 64
# The tiers the verdict chooses among: measured per-block times only.
MEASURED_TIERS = ("overlapped", "overlapped_deep") + tuple(
    f"batched_{b}" for b in BATCHES)
# Every per-block time a record measures.
COMPONENTS = ("upload_only_ms", "dispatch_only_ms", "serial_ms") + tuple(
    f"{t}_ms" for t in MEASURED_TIERS)


def best_tier(rec: Dict) -> Optional[Tuple[str, float]]:
    """(tier, ms) of the fastest measured tier of a record, or None when
    none was measured."""
    measured = [(t, rec[f"{t}_ms"]) for t in MEASURED_TIERS
                if rec.get(f"{t}_ms") is not None]
    return min(measured, key=lambda tm: tm[1]) if measured else None


def _measure_components(name: str, reps: int, device: str) -> dict:
    import torch

    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.harness.overlap import (
        Infeed,
        _probe,
        measure_overlap,
        measure_overlap_batched,
    )
    from gpuaudiobench_tpu_torch.harness.statistics import (
        calculate_statistics,
    )
    from gpuaudiobench_tpu_torch.registry import create_benchmark
    from gpuaudiobench_tpu_torch.utils import device as dv

    torch_dev = dv.device(device)
    cfg = BenchConfig(buffer_size=BUFFER_SIZE, n_runs=2, warmup=2,
                      verification="spot", write_latencies=False,
                      device_timing=False, quiet=True)
    b = create_benchmark(name, cfg, torch_dev)
    b.setup()
    ob = b.overlap_body()
    if ob is None:
        return {"benchmark": name, "skipped": "no overlap_body"}
    step_fn, host_blocks, carry = ob
    host_blocks = list(host_blocks)

    rec = {"benchmark": name, "buffer_size": BUFFER_SIZE, "depth": DEPTH,
           "deadline_ms": cfg.deadline_ms()}

    def p50(vals):
        return calculate_statistics(vals).median

    # upload_only: an upload a block on the copy stream, one read at the
    # end.
    infeed = Infeed(host_blocks, torch_dev)

    def read_slot(j):
        # The read waits for slot j's upload on the copy stream.
        if infeed.cuda:
            torch.cuda.current_stream(torch_dev).wait_event(
                infeed.uploaded[j % 2])
        _probe(infeed.slots[j % 2])

    infeed.upload(0)
    read_slot(0)
    vals = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for k in range(DEPTH):
            infeed.upload(k)
        read_slot(DEPTH - 1)
        vals.append((time.perf_counter() - t0) / DEPTH * 1000.0)
    rec["upload_only_ms"] = p50(vals)
    infeed.upload(0)
    read_slot(0)

    # dispatch_only: a block of compute a block on a resident input, one
    # read at the end.
    xd = infeed.slots[0]
    c = carry
    y, c = step_fn(xd, c)
    _probe(y)
    vals = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _k in range(DEPTH):
            y, c = step_fn(xd, c)
        _probe(y)
        vals.append((time.perf_counter() - t0) / DEPTH * 1000.0)
    rec["dispatch_only_ms"] = p50(vals)

    # overlapped at depth 64 and 4x the depth.
    ser, ovl = measure_overlap(step_fn, host_blocks, carry, DEPTH, reps,
                               torch_dev)
    rec["serial_ms"] = p50(ser)
    rec["overlapped_ms"] = p50(ovl)
    _, ovl_deep = measure_overlap(step_fn, host_blocks, carry, DEEP_DEPTH,
                                  max(3, reps // 2), torch_dev)
    rec["overlapped_deep_ms"] = p50(ovl_deep)
    rec["deep_depth"] = DEEP_DEPTH

    # batched uploads.
    for batch in BATCHES:
        try:
            vals = measure_overlap_batched(
                step_fn, host_blocks, carry, DEEP_DEPTH, batch,
                max(3, reps // 2), torch_dev)
            rec[f"batched_{batch}_ms"] = p50(vals)
        except Exception as e:  # noqa: BLE001 - record, keep going
            rec[f"batched_{batch}_ms"] = None
            rec[f"batched_{batch}_error"] = f"{type(e).__name__}: {e}"

    best = best_tier(rec)
    rec["best_tier"], rec["best_ms"] = best if best else (None, None)
    rec["meets_deadline_64"] = bool(
        best is not None and best[1] <= cfg.deadline_ms())
    return rec


def render_md(rows, reps, card: str) -> str:
    lines = [
        f"# Buffer-64 low-latency floor: attribution + batched-upload "
        f"attack ({card})",
        "",
        "Deadline 1.333 ms (64 samples @ 48 kHz, cuda/globals.cu:55 "
        "basis). Components per workload: upload_only = a pinned upload "
        "a block on the copy stream (one trailing read); dispatch_only = "
        "a block of compute a block on a resident input; overlapped = "
        "upload k+1 while k computes at depth 64 and 256; batched_B = B "
        "blocks an upload (harness/overlap.measure_overlap_batched) -- "
        "NOTE: batching adds B blocks of producer-side input latency; it "
        "buys throughput under the deadline, not end-to-end latency. The "
        "best is chosen among the overlapped and batched tiers only.",
        "",
        "| Workload | upload only | dispatch only | serial | "
        "overlapped@64 | overlapped@256 | batched@8 | batched@32 | "
        "best (tier) | meets 1.333? |",
        "|---|---:|---:|---:|---:|---:|---:|---:|---:|---|",
    ]
    for r in rows:
        if r.get("skipped"):
            lines.append(f"| {r['benchmark']} | skipped: "
                         f"{r['skipped']} | | | | | | | | |")
            continue

        def f(k):
            return f"{r[k]:.3f}" if r.get(k) is not None else "—"

        best = (f"{r['best_ms']:.3f} ({r['best_tier']})"
                if r.get("best_tier") else "—")
        lines.append(
            f"| {r['benchmark']} | {f('upload_only_ms')} | "
            f"{f('dispatch_only_ms')} | {f('serial_ms')} | "
            f"{f('overlapped_ms')} | {f('overlapped_deep_ms')} | "
            f"{f('batched_8_ms')} | {f('batched_32_ms')} | "
            f"{best} | {'YES' if r['meets_deadline_64'] else 'no'} |")
    lines += [
        "",
        "Reading: if upload_only ~ overlapped, the floor is the "
        "per-block upload and batching is the lever; if dispatch_only "
        "dominates, it is the per-block launch and deeper pipelining "
        "cannot help (each block is still its own launches). "
        f"reps={reps}; python -m "
        "gpuaudiobench_tpu_torch.tools.overlap64_attrib.",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gpuaudiobench_tpu_torch.tools.overlap64_attrib")
    ap.add_argument("out", nargs="?",
                    default=os.path.join(tempfile.gettempdir(), "overlap64"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--workloads", default=",".join(WORKLOADS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from gpuaudiobench_tpu_torch.utils import device as dv

    torch_dev = dv.device(args.device)
    ident = dv.gpu_identity(torch_dev)
    card = (f"{ident['device_name']}, {ident['power_limit']}"
            if torch_dev.type == "cuda" else "cpu")
    rows = []
    for name in args.workloads.split(","):
        print(f"overlap64: {name} ...", flush=True)
        try:
            rec = _measure_components(name, args.reps, args.device)
        except Exception as e:  # noqa: BLE001 - record, keep going
            rec = {"benchmark": name,
                   "skipped": f"{type(e).__name__}: {e}"}
        rows.append(rec)
        print(f"  -> {json.dumps(rec)[:240]}", flush=True)

    with open(args.out + ".json", "w") as f:
        json.dump({"reps": args.reps, "card": card, "rows": rows}, f,
                  indent=2)
    with open(args.out + ".md", "w") as f:
        f.write(render_md(rows, args.reps, card))
    print(f"written: {args.out}.json / .md")
    # A skipped workload or a batched tier that raised fails the run.
    return 0 if not any(r.get("skipped") or any(
        k.endswith("_error") for k in r) for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
