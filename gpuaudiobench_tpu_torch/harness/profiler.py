"""The port's span recorder, the ``--capture`` trace, and readers of
device events.

PyTorch counterpart of ``gpuaudiobench_tpu/harness/profiler.py``.
``PerformanceProfiler`` is the port's own copy of the reference's
label -> durations recorder (Metal's BenchmarkUtilities.swift:577-607),
grown into the port's span recorder: ``span(name)`` marks one stretch of
host work, and ``SPANS`` is the process's one recorder, which the
program's own boundaries feed:

* ``gpuab.iterate``: one ``Benchmark.iterate()`` call, the unit of a
  round trip (``harness/base.py``);
* ``gpuab.op``: one ``torch.ops.gpuab`` operator call, from the call to
  its return: the dispatcher, the operator's allocations, its launches
  (``ops/gpuab.py:call``);
* ``gpuab.d2h`` and ``gpuab.h2d``: a copy to the host and to the device
  (``utils/device.py``), the d2h's wait for the device included;
* ``gpuab.replay``: one replay of a chain's CUDA graph
  (``harness/graph.py``).

A span records only while the recorder is on: while a ``torch.profiler``
session runs, so that ``--capture`` and any profiled window collect the
spans with no switch, and between ``enable()`` and ``disable()``, which
read the spans without the profiler's own cost. It never records while a
program is being traced (``torch.export``, ``torch.compile``). Off, a
span costs one look at two flags and records nothing. On, it stamps
``time.perf_counter_ns()`` at entry and exit into a bounded ring of
``capacity`` records that overwrites its oldest and counts what it
dropped; each record names its parent span and the serial of its root,
so the spans of one round trip share the root's serial. Under a profiler
session the span is also a ``record_function`` range of the same name,
on the profiler's clock beside the device's events.

``capture_trace`` is the ``--capture`` hook: a ``torch.profiler``
session (the MTLCaptureManager / GPU-trace analog) that writes a Chrome
trace named after the benchmark. The reference warns and carries on
where its runtime cannot trace; here a CUDA trace that holds no device
event raises, and nothing takes the session again.

``device_events`` reads the device's kernels and copies from a finished
``torch.profiler`` session, ``trace_events`` from a written trace file
(optionally inside one of the runner's phase ranges), and ``summarize``
turns either into time per kernel, busy time and idle share;
``trace_summary`` does so for a phase of a written trace, over the
phase's range, with each idle gap named by the innermost ``gpuab.*``
range the host was in.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

Event = Tuple[str, float, float]  # (name, start_us, end_us)

# The Chrome trace categories of the device's work.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# The prefix of the program's own span names.
SPAN_PREFIX = "gpuab."
# Records the process's recorder keeps before it overwrites the oldest.
RING_SPANS = 65536

# One finished span: its name, its entry and exit on the
# ``time.perf_counter_ns`` clock, its serial, the serial of the span it
# was opened in (0 for a root) and the serial of its root (its own for a
# root).
SpanRecord = collections.namedtuple(
    "SpanRecord", "name start_ns end_ns serial parent root")


# The span of a recorder that is off: records nothing.
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("_rec", "_name", "_range", "_ids", "_t0")

    def __init__(self, rec: "PerformanceProfiler", name: str, profiled: bool):
        self._rec, self._name = rec, name
        self._range = (_autograd_profiler.record_function(name) if profiled
                       else None)

    def __enter__(self):
        rec = self._rec
        serial = next(rec._serials)
        try:
            stack = rec._local.stack
        except AttributeError:
            stack = rec._local.stack = []
        # (serial, parent, root); a root is its own root.
        ids = self._ids = ((serial, stack[-1][0], stack[-1][2]) if stack
                           else (serial, 0, serial))
        stack.append(ids)
        # The stamps enclose the profiler's range: a span's profiled time
        # holds the cost of its own range, not its parent's.
        self._t0 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
        t1 = time.perf_counter_ns()
        rec = self._rec
        rec._local.stack.pop()
        rec._write((self._name, self._t0, t1) + self._ids)
        return False


class PerformanceProfiler:
    """Durations by label (``record``, ``measure``: the reference's), and
    the program's spans (``span``) in a bounded ring of ``capacity``
    records. ``summary`` covers both, by label and span name; ``reset``
    empties both."""

    def __init__(self, capacity: int = RING_SPANS):
        self._samples: Dict[str, List[float]] = defaultdict(list)
        self.capacity = capacity
        self.enabled = False  # on between enable() and disable()
        self._ring: List[Optional[tuple]] = [None] * capacity
        self._written = 0
        self._serials = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def record(self, label: str, seconds: float) -> None:
        self._samples[label].append(seconds)

    @contextlib.contextmanager
    def measure(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(label, time.perf_counter() - t0)

    def span(self, name: str):
        """A context manager around one stretch of host work named
        ``name``; it records only while the recorder is on (``enabled``
        or a profiler session runs) and no program is being traced."""
        if ((self.enabled or _autograd_profiler._is_profiler_enabled)
                and not torch.compiler.is_compiling()):
            return _Span(self, name, _autograd_profiler._is_profiler_enabled)
        return _OFF

    def _write(self, rec: tuple) -> None:
        """Keep one record, the fields of a ``SpanRecord``."""
        with self._lock:
            self._ring[self._written % self.capacity] = rec
            self._written += 1

    @property
    def dropped(self) -> int:
        """Records overwritten since the last ``reset``."""
        return max(0, self._written - self.capacity)

    def records(self) -> List[SpanRecord]:
        """The spans the ring holds, in the order they closed."""
        with self._lock:
            n = self._written
            i = n % self.capacity
            held = (self._ring[:n] if n <= self.capacity
                    else self._ring[i:] + self._ring[:i])
        return [SpanRecord._make(r) for r in held]

    def trees(self, last: Optional[int] = None
              ) -> List[Tuple[SpanRecord, List[SpanRecord]]]:
        """Each root the ring holds with the spans opened inside it, in
        the order the roots closed: the last ``last`` of them, or all."""
        inside: Dict[int, List[SpanRecord]] = defaultdict(list)
        roots = []
        for r in self.records():
            if r.parent == 0:
                roots.append(r)
            else:
                inside[r.root].append(r)
        if last is not None:
            roots = roots[-last:] if last > 0 else []
        return [(r, inside.get(r.serial, [])) for r in roots]

    def summary(self) -> Dict[str, Dict[str, float]]:
        samples: Dict[str, List[float]] = defaultdict(list)
        for label, vals in self._samples.items():
            samples[label].extend(vals)
        for r in self.records():
            samples[r.name].append((r.end_ns - r.start_ns) * 1e-9)
        out = {}
        for label, vals in samples.items():
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
        with self._lock:
            self._ring = [None] * self.capacity
            self._written = 0


def self_ns(span: SpanRecord, inside: Sequence[SpanRecord],
            names: Optional[Sequence[str]] = None) -> int:
    """``span``'s duration less its children's (those of ``names``
    only, where given), in nanoseconds."""
    return (span.end_ns - span.start_ns) - sum(
        c.end_ns - c.start_ns for c in inside
        if c.parent == span.serial and (names is None or c.name in names))


# The process's recorder, which the program's spans feed.
SPANS = PerformanceProfiler()
span = SPANS.span


def enable() -> None:
    """Record the program's spans without a profiler session, until
    ``disable()``."""
    SPANS.enabled = True


def disable() -> None:
    SPANS.enabled = False


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


def _load_trace(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _ranges(events: List[dict], name=None, prefix: str = "") -> List[Event]:
    """The host's ``record_function`` ranges of a Chrome trace named
    ``name``, or whose names start with ``prefix``, in order of start."""
    out = []
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and (e.get("name") == name if name is not None
                     else str(e.get("name", "")).startswith(prefix))):
            a = float(e["ts"])
            out.append((e["name"], a, a + float(e["dur"])))
    return sorted(out, key=lambda r: r[1])


def _phase(events: List[dict], path: str,
           phase: Optional[str]) -> Tuple[float, float]:
    """The (first) range named ``phase``; everything for None."""
    if phase is None:
        return -float("inf"), float("inf")
    ranges = _ranges(events, name=phase)
    if not ranges:
        raise ValueError(f"trace_events: {path} has no {phase!r} range")
    return ranges[0][1], ranges[0][2]


def _device(events: List[dict], lo: float, hi: float) -> List[Event]:
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            a = float(e["ts"])
            b = a + float(e["dur"])
            if a >= lo and b <= hi:
                out.append((e["name"], a, b))
    return out


def trace_events(path: str, phase: Optional[str] = None) -> List[Event]:
    """The device events of a Chrome trace written by ``capture_trace``:
    all of them, or those inside the (first) CPU range named ``phase``
    (the runner's ``record_function`` ranges: "warmup", "timed",
    "device-timing", "saturated", "overlap", "validate", and inside
    "saturated" the timed reps' "saturated-reps")."""
    events = _load_trace(path)
    return _device(events, *_phase(events, path, phase))


def trace_summary(path: str, blocks: int,
                  phase: Optional[str] = None) -> Dict[str, object]:
    """``summarize`` of a Chrome trace written by ``capture_trace``: the
    device events inside the (first) range named ``phase``, with the
    idle share over that range (first to last device event where no
    phase is named), and each idle gap named by the innermost of the
    program's spans (``gpuab.*`` ranges) the host was in."""
    events = _load_trace(path)
    lo, hi = _phase(events, path, phase)
    return summarize(_device(events, lo, hi), blocks,
                     None if phase is None else (lo, hi),
                     _ranges(events, prefix=SPAN_PREFIX))


def _busy(events: Sequence[Event], lo: float,
          hi: float) -> List[Tuple[float, float]]:
    """The union of the events' intervals, clipped to [lo, hi]."""
    out: List[List[float]] = []
    for _, a, b in sorted(events, key=lambda x: x[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _attribute(gaps: Sequence[Tuple[float, float]], ranges: Sequence[Event]):
    """Each gap named by the innermost of ``ranges`` that holds its middle
    ("" where none does), and the gaps' time split by the innermost range
    at each instant."""
    rs = sorted(ranges, key=lambda r: r[1])
    starts = [r[1] for r in rs]
    longest = max((r[2] - r[1] for r in rs), default=0.0)

    def around(a: float, b: float) -> List[Event]:
        i = bisect.bisect_left(starts, b)
        out = []
        while i > 0 and starts[i - 1] >= a - longest:
            i -= 1
            if rs[i][2] > a:
                out.append(rs[i])
        return out

    def inner(cands: List[Event], t: float) -> str:
        held = [r for r in cands if r[1] <= t <= r[2]]
        return min(held, key=lambda r: r[2] - r[1])[0] if held else ""

    named, split = [], {}
    for a, b in gaps:
        cands = around(a, b)
        named.append((inner(cands, (a + b) / 2), b - a))
        cuts = sorted({a, b, *(x for r in cands for x in r[1:] if a < x < b)})
        for x, y in zip(cuts, cuts[1:]):
            k = inner(cands, (x + y) / 2)
            split[k] = split.get(k, 0.0) + (y - x)
    return named, split


def summarize(events: List[Event], blocks: int,
              window: Optional[Tuple[float, float]] = None,
              ranges: Sequence[Event] = ()) -> Dict[str, object]:
    """Device time per kernel and per block, the busy time per block (the
    union of the events' intervals) and the idle share of ``window`` (a
    phase's range; from the first device event to the last where None).
    Each idle gap is named by the innermost of ``ranges`` (name, start,
    end) that holds its middle ("" where none does): the longest ten
    (name, us); and the idle time per block is split by the innermost
    range the host was in at each instant."""
    if not events:
        return {"error": "the profiler saw no device time"}
    per_kernel: Dict[str, float] = {}
    for name, a, b in events:
        per_kernel[name] = per_kernel.get(name, 0.0) + (b - a)
    lo, hi = window or (min(a for _, a, _ in events),
                        max(b for _, _, b in events))
    busy_iv = _busy(events, lo, hi)
    busy = sum(b - a for a, b in busy_iv)
    span_ = hi - lo
    edges = [lo] + [x for iv in busy_iv for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    named, split = _attribute(gaps, ranges)
    return {
        "blocks": blocks,
        "kernel_us_per_block": {
            k: v / blocks for k, v in sorted(per_kernel.items(),
                                             key=lambda kv: -kv[1])},
        "device_busy_us_per_block": busy / blocks,
        "window_us_per_block": span_ / blocks,
        "device_idle_share": 1.0 - busy / span_ if span_ > 0 else 0.0,
        "idle_gaps": sorted(named, key=lambda g: -g[1])[:10],
        "idle_us_per_block_by_range": {k: v / blocks
                                       for k, v in split.items()},
    }
