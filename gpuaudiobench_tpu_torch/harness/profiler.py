"""Phase profiler, the ``--capture`` trace, and readers of device events.

PyTorch counterpart of ``gpuaudiobench_tpu/harness/profiler.py``.
``PerformanceProfiler`` is the port's own copy of the reference's
(Metal's BenchmarkUtilities.swift:577-607, pure Python).
``capture_trace`` is the ``--capture`` hook: a ``torch.profiler``
session (the MTLCaptureManager / GPU-trace analog) that writes a Chrome
trace named after the benchmark. The reference warns and carries on
where its runtime cannot trace; here a CUDA trace that holds no device
event raises, and nothing takes the session again.

``device_events`` reads the device's kernels and copies from a finished
``torch.profiler`` session, ``trace_events`` from a written trace file
(optionally inside one of the runner's phase ranges), and ``summarize``
turns either into time per kernel, busy time and idle share.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch

Event = Tuple[str, float, float]  # (name, start_us, end_us)

# The Chrome trace categories of the device's work.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class PerformanceProfiler:
    def __init__(self):
        self._samples: Dict[str, List[float]] = defaultdict(list)

    def record(self, label: str, seconds: float) -> None:
        self._samples[label].append(seconds)

    @contextlib.contextmanager
    def measure(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(label, time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for label, vals in self._samples.items():
            total = sum(vals)
            out[label] = {
                "count": len(vals),
                "total_ms": total * 1e3,
                "mean_ms": total / len(vals) * 1e3,
                "min_ms": min(vals) * 1e3,
                "max_ms": max(vals) * 1e3,
            }
        return out

    def print_summary(self) -> None:
        print(f"{'phase':<24} {'count':>6} {'total ms':>10} {'mean ms':>9}")
        for label, s in sorted(self.summary().items()):
            print(
                f"{label:<24} {s['count']:>6} {s['total_ms']:>10.3f} "
                f"{s['mean_ms']:>9.3f}"
            )

    def reset(self) -> None:
        self._samples.clear()


def trace_dir(capture_dir: str) -> str:
    """``capture_dir``, or ``<temp dir>/tpuaudiobench_trace`` for "" (the
    reference's default is ``/tmp/tpuaudiobench_trace``)."""
    return capture_dir or os.path.join(tempfile.gettempdir(),
                                       "tpuaudiobench_trace")


def device_events(prof) -> List[Event]:
    """(name, start_us, end_us) of every event a finished profiler
    session saw on the device (kernels and copies)."""
    out = []
    for e in prof.events():
        if "CUDA" in str(getattr(e, "device_type", "")):
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


@contextlib.contextmanager
def capture_trace(directory: str, device: torch.device,
                  name: str) -> Iterator[str]:
    """Profile the body with ``torch.profiler`` (CPU activity, and CUDA
    on a CUDA device) and write its Chrome trace to
    ``<directory>/<name>.trace.json``; yields that path. The device is
    synchronised before the session starts and before it stops, so the
    trace holds all the body's device work. On a CUDA device a trace
    with no device event raises ``RuntimeError``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.trace.json")
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        yield path
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    if cuda and not device_events(prof):
        raise RuntimeError(
            f"capture_trace: the {name} trace ({path}) holds no device "
            "event")
    print(f"Profiler trace written to {path}")


def trace_events(path: str, phase: Optional[str] = None) -> List[Event]:
    """The device events of a Chrome trace written by ``capture_trace``:
    all of them, or those inside the (first) CPU range named ``phase``
    (the runner's ``record_function`` ranges: "warmup", "timed",
    "device-timing", "saturated", "overlap", "validate", and inside
    "saturated" the timed reps' "saturated-reps")."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    lo, hi = -float("inf"), float("inf")
    if phase is not None:
        ranges = [e for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and e.get("name") == phase]
        if not ranges:
            raise ValueError(f"trace_events: {path} has no {phase!r} range")
        lo = float(ranges[0]["ts"])
        hi = lo + float(ranges[0]["dur"])
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            a = float(e["ts"])
            b = a + float(e["dur"])
            if a >= lo and b <= hi:
                out.append((e["name"], a, b))
    return out


def summarize(events: List[Event], blocks: int) -> Dict[str, object]:
    """Device time per kernel and per block, the busy time per block (the
    union of the events' intervals) and the idle share of the window
    from the first device event to the last."""
    if not events:
        return {"error": "the profiler saw no device time"}
    per_kernel: Dict[str, float] = {}
    for name, a, b in events:
        per_kernel[name] = per_kernel.get(name, 0.0) + (b - a)
    busy, cur_a, cur_b = 0.0, None, None
    for _, a, b in sorted(events, key=lambda x: x[1]):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    window = max(b for _, _, b in events) - min(a for _, a, _ in events)
    return {
        "blocks": blocks,
        "kernel_us_per_block": {
            k: v / blocks for k, v in sorted(per_kernel.items(),
                                             key=lambda kv: -kv[1])},
        "device_busy_us_per_block": busy / blocks,
        "window_us_per_block": window / blocks,
        "device_idle_share": 1.0 - busy / window if window > 0 else 0.0,
    }
