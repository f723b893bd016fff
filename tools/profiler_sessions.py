"""How often a short torch.profiler session comes back with no device event.

    python3 tools/profiler_sessions.py [--sessions 40] [--fresh 4]

Each session profiles one call of each IIR cascade wrapper at 1,000 x 96,
K = 10, as ``chip_smoke.py``'s cascade proof does (the chain wrapper's
kernel and its constant-bank copy, then the systolic wrapper's kernel
alone), the device synchronised before the session and inside it. Three
kinds of session take turns, ``--sessions`` times each:

* ``cuda``: ``activities=[CUDA]``, the proof's own session;
* ``cpu+cuda``: ``activities=[CPU, CUDA]``, ``harness.profiler.
  capture_trace``'s;
* ``capture_trace``: ``harness.profiler.capture_trace`` itself, which
  raises on an empty trace (the raise is counted, not caught silently);
* ``cpu+cuda x50``: the ``cpu+cuda`` session around 50 calls, not one.

Then ``--fresh`` new processes each open one ``cuda`` session first
thing, since a process's first session is the one that starts CUPTI.
Prints, for each kind and wrapper, the sessions with no device event and
the device events seen, and the card's name and power limit.

Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402
from gpuaudiobench_tpu_torch.harness import profiler  # noqa: E402
from gpuaudiobench_tpu_torch.ops import iir as iops  # noqa: E402
from gpuaudiobench_tpu_torch.utils import device as dev  # noqa: E402

WRAPPERS = {"iir_cascade_chain": iops.iir_cascade_chain,
            "iir_cascade": iops.iir_cascade}


def session(kind: str, fn, args, tmpdir: str):
    """The device events of one session of ``kind`` around ``fn(*args)``,
    or None when capture_trace raised on an empty trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    if kind == "capture_trace":
        try:
            with profiler.capture_trace(tmpdir, args[0].device,
                                        "session") as path:
                fn(*args)
        except RuntimeError:
            return None
        return profiler.trace_events(path)
    acts = [ProfilerActivity.CUDA] if kind == "cuda" else [
        ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(50 if kind.endswith("x50") else 1):
            fn(*args)
        torch.cuda.synchronize()
    return profiler.device_events(prof)


def fresh_process() -> str:
    """One ``cuda`` session first thing in a new process: its device
    events' names."""
    code = ("import runpy; runpy.run_path('tools/profiler_sessions.py', "
            "run_name='fresh')['first_session']()")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"fresh process failed: {out.stderr[-2000:]}")
    return out.stdout.strip().splitlines()[-1]


def first_session() -> None:
    device = dev.device("cuda")
    x, c, z = cs.iir_inputs(torch, 1000, 96, device, stages=cs.IIR_STAGES)
    iops.iir_cascade(x, c, z)  # builds and loads the kernel
    torch.cuda.synchronize()
    events = session("cuda", iops.iir_cascade, (x, c, z), "")
    print(sorted({e[0][:40] for e in events}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=40)
    ap.add_argument("--fresh", type=int, default=4)
    args = ap.parse_args()
    device = dev.device("cuda")
    print(dev.nvidia_smi("name,power.limit"))
    x, c, z = cs.iir_inputs(torch, 1000, 96, device, stages=cs.IIR_STAGES)
    for fn in WRAPPERS.values():
        fn(x, c, z)
    torch.cuda.synchronize()
    kinds = ("cuda", "cpu+cuda", "capture_trace", "cpu+cuda x50")
    empty = {(k, w): 0 for k in kinds for w in WRAPPERS}
    names = {(k, w): set() for k in kinds for w in WRAPPERS}
    with tempfile.TemporaryDirectory() as tmpdir:
        for _ in range(args.sessions):
            for kind in kinds:
                for w, fn in WRAPPERS.items():
                    events = session(kind, fn, (x, c, z), tmpdir)
                    if not events:
                        empty[(kind, w)] += 1
                    else:
                        names[(kind, w)] |= {e[0][:40] for e in events}
    for (kind, w), n in empty.items():
        print(f"{kind} session, {w}: {n} of {args.sessions} with no device "
              f"event; events seen {sorted(names[(kind, w)])}")
    for i in range(args.fresh):
        print(f"fresh process {i}: first cuda session saw {fresh_process()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
