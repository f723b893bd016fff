"""FDTD3D's per-track receivers on the card, A/B: the field form's block
with its receivers bucketed by plane on the device (one bucketing launch
before the field kernel) against another checkout of the port.

At rooms 50 and 82 (the field kernel's two face layouts' main rooms),
128 tracks x 512 samples, the receivers on the benchmark's line
(``ops.fdtd3d.receiver_line``), through ``fdtd3d_block_field``:

* ``ms room R``: the CUDA-event time of a block, the median over 20 reps
  of 10 blocks back to back (as ``chip_smoke.py`` times its rows);
* ``device_ms room R``: a block's device time, CUDA events around 10
  blocks behind a ~1 ms spin (so the host's launches hide), median of 11
  reps;
* ``cli_p50_ms``: the device p50 of ``--benchmark FDTD3D
  --fdtdPerTrackReceivers`` through the CLI at room 50 (10 runs, depth
  32, spot verification, as ``chip_smoke.py`` runs it), and its
  saturated p50.

Where the checkout has the bucketing kernel (``receiver_buckets``), also
its device time alone at room 50 with 128 tracks (the line) and 65,536
(cells drawn over [-2 n^3, 2 n^3)), 10 calls behind a spin, median of 11
reps, and its launches in one block.

    python -m gpuaudiobench_tpu_torch.tools.receivers_ab [--other DIR]
        [--out FILE]

With ``--other`` (the root of another checkout, e.g. a ``git archive`` of
the parent commit unpacked into a gitignored directory) it measures in
fresh processes in turns, other, this, this, other, each importing its
own checkout's package and building its own kernels; without it, this
checkout once. ``--out`` writes the results as JSON. On the card only.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
ROOMS, TRACKS, SAMPLES = (50, 82), 128, 512
WIDE = 65536
REPS, CALLS = 20, 10
SPIN_REPS = 11
CLI = ["--benchmark", "FDTD3D", "--fdtdPerTrackReceivers", "--nRuns", "10",
       "--warmup", "2", "--pipelineDepth", "32", "--saturatedReps", "5",
       "--verification", "spot", "--json"]


def _back_to_back_ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(CALLS):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / CALLS)
    return statistics.median(times)


def _device_ms(fn) -> float:
    from gpuaudiobench_tpu_torch.harness.device_timing import (
        event_device_times,
    )

    def body():
        for _ in range(CALLS):
            fn()

    return statistics.median(event_device_times(body, SPIN_REPS)) / CALLS


def _cli() -> Dict[str, float]:
    from gpuaudiobench_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(CLI)
    lines = buf.getvalue().splitlines()
    if rc != 0:
        raise RuntimeError("receivers_ab: the CLI run failed:\n"
                           + "\n".join(lines[-20:]))
    start = lines.index("{")
    end = len(lines) - 1 - lines[::-1].index("}")
    rec = json.loads("\n".join(lines[start:end + 1]))
    if rec["validation"]["status"] != "SUCCESS":
        raise RuntimeError(f"receivers_ab: validation {rec['validation']}")
    return {"cli_p50_ms": rec["device_statistics"]["median_ms"],
            "cli_saturated_p50_ms": rec["saturated"]["p50_ms"]}


def measure() -> Dict[str, float]:
    """This process's package's numbers, on the card."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("receivers_ab: CUDA requested but "
                           "torch.cuda.is_available() is False")
    from gpuaudiobench_tpu_torch.ops import fdtd3d

    device = torch.device("cuda")
    g = np.random.Generator(np.random.MT19937(11))
    x = torch.from_numpy(
        (g.random((TRACKS, SAMPLES), dtype=np.float32) * 2 - 1).astype(
            np.float32)).to(device)
    out = {}
    for room in ROOMS:
        n = fdtd3d.grid_n(room)
        src, rcv = fdtd3d.source_pos(room), fdtd3d.receiver_pos(room)
        xs, ys, zs = fdtd3d.receiver_line(TRACKS, n)
        cells = torch.from_numpy(((xs.astype(np.int64) * n + ys) * n + zs)
                                 .astype(np.int32)).to(device)
        fields = fdtd3d.zero_fields(n, device)

        def block():
            return fdtd3d.fdtd3d_block_field(x, *fields, src, rcv,
                                             receivers=cells)

        before = dict(fdtd3d.KERNEL_LAUNCHES)
        block()
        torch.cuda.synchronize()
        out.update({f"launches {k} room {room}": v - before[k]
                    for k, v in fdtd3d.KERNEL_LAUNCHES.items()
                    if v != before[k]})
        out[f"ms room {room}"] = _back_to_back_ms(torch, block)
        out[f"device_ms room {room}"] = _device_ms(block)
        if room == ROOMS[0] and hasattr(fdtd3d, "receiver_buckets"):
            wide = torch.from_numpy(g.integers(-2 * n ** 3, 2 * n ** 3, WIDE)
                                    .astype(np.int32)).to(device)
            for label, r in ((TRACKS, cells), (WIDE, wide)):
                out[f"buckets_us {label}"] = 1e3 * _device_ms(
                    lambda r=r, n=n: fdtd3d.receiver_buckets(r, n))
    out.update(_cli())
    return out


def _worker(root: Path) -> Dict[str, float]:
    """``measure`` in a fresh process that imports ``root``'s package."""
    code = ("import runpy, sys; sys.argv = ['receivers_ab', '--worker']; "
            f"runpy.run_path({str(Path(__file__).resolve())!r}, "
            "run_name='__main__')")
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"receivers_ab: the worker in {root} failed:\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="receivers_ab", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--other", help="root of the checkout to compare with")
    ap.add_argument("--out", help="write the results as JSON here")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(measure()))
        return 0
    try:
        if args.other is None:
            runs = {"this": [_worker(ROOT)]}
        else:
            other = Path(args.other).resolve()
            runs = {"other": [], "this": []}
            for side in ("other", "this", "this", "other"):
                runs[side].append(_worker(other if side == "other" else ROOT))
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    card = _card()
    print(f"per-track receivers A/B on {card}: FDTD3D field block, "
          f"{TRACKS} x {SAMPLES}, runs in turns")
    keys = sorted({k for reps in runs.values() for r in reps for k in r})
    for key in keys:
        cells = [f"{side} " + " / ".join(
                     f"{r[key]:.4f}" if isinstance(r[key], float)
                     else str(r[key]) for r in reps)
                 for side, reps in runs.items() if key in reps[0]]
        print(f"{key}: " + "; ".join(cells))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "runs": runs},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
