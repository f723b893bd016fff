"""What the per-layer metrics read: one ``torch.profiler`` session over a
steady sub-window of a cell, held in memory.

The harness marks its own work with ``record_function`` ranges named
``rtbench.*``: ``rtbench.window`` around the whole traced sub-window
(its final wait included), and inside it ``rtbench.replay`` (a chain's
replay and its probe read-out enqueued), ``rtbench.wait`` (the host
waiting for an earlier replay) or ``rtbench.callback`` (one
``iterate()``). ``TraceView`` gives a reader the device's events and
these spans in the profiler's one clock (microseconds), with the
sub-window's block and unit counts, the cell's configuration and the
host clock's reading of the measured window before it.
Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from rtbench import spec
from rtbench.stats import merged

Event = Tuple[str, float, float]  # (name, start_us, end_us)

SPAN_PREFIX = "rtbench."
PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def split_events(prof) -> Tuple[List[Event], Dict[str, List[Tuple[float, float]]]]:
    """The device's kernels, copies and sets of a finished session, in
    order of start, and the harness's spans by name. A range's device
    shadow (the profiler's user annotation on the GPU timeline) is a
    span, not device work."""
    device: List[Event] = []
    spans: Dict[str, List[Tuple[float, float]]] = {}
    for e in prof.events():
        start, end = float(e.time_range.start), float(e.time_range.end)
        on_device = "CUDA" in str(getattr(e, "device_type", ""))
        if e.name.startswith(SPAN_PREFIX):
            if not on_device:
                spans.setdefault(e.name, []).append((start, end))
            continue
        if on_device and not getattr(e, "is_user_annotation", False):
            device.append((e.name, start, end))
    device.sort(key=lambda ev: ev[1])
    for v in spans.values():
        v.sort()
    return device, spans


def is_d2h(name: str) -> bool:
    """A copy from the device to the host. In a stream cell the only one
    is the harness's read-out of a replay's probes."""
    return "DtoH" in name


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The data sheet's peaks of the card named ``device_name``, or None
    where ``peaks.json`` does not list it."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)["cards"]
    return table.get(device_name)


class TraceView:
    """A traced sub-window as the per-layer readers see it."""

    def __init__(self, *, kind: str, config: Dict, device_name: str,
                 events: Sequence[Event],
                 spans: Dict[str, List[Tuple[float, float]]],
                 blocks: int, units: int, measured: Dict[str, float]):
        self.kind = kind  # the traffic's kind, a ``generators/<kind>.py``
        self.config = config
        self.device_name = device_name
        self.spans = spans
        if not spans.get("rtbench.window"):
            raise ValueError("trace: no rtbench.window span")
        self.window = spans["rtbench.window"][0]
        lo, hi = self.window
        self.events = [e for e in events if e[1] >= lo and e[2] <= hi]
        self._busy = merged((a, b) for _, a, b in self.events)
        self._busy_starts = [a for a, _ in self._busy]
        self.blocks = blocks  # blocks run inside the window
        self.units = units  # replays or callbacks inside the window
        # The measured (untraced) window before it: its wall ``window_us``,
        # its ``units`` and what its generator adds (``unit_p50_us``,
        # ``blocks``), for readers that leave the profiler's own cost out.
        self.measured = measured

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_us(self, lo: Optional[float] = None,
                hi: Optional[float] = None) -> float:
        """The union of the device's events, clipped to [lo, hi] (the
        window by default), in microseconds."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        total = 0.0
        i = max(0, bisect.bisect_right(self._busy_starts, lo) - 1)
        while i < len(self._busy) and self._busy[i][0] < hi:
            a, b = max(self._busy[i][0], lo), min(self._busy[i][1], hi)
            if b > a:
                total += b - a
            i += 1
        return total

    def time_us(self, match) -> float:
        """Summed device time of the events whose name ``match`` accepts."""
        return sum(b - a for name, a, b in self.events if match(name))

    def cost(self, kernel: str):
        return spec.load_module("cost", kernel)

    def kernel_us(self, kernel: str) -> float:
        """Device time of the named kernel's events (``cost/<kernel>.py``'s
        ``NAMES``) in the window."""
        names = self.cost(kernel).NAMES
        return self.time_us(lambda n: any(k in n for k in names))

    def least_us(self, kernel: str) -> Optional[float]:
        """A block's least time on this card by the data sheet: the larger
        of its operations over the FP32 peak and its bytes over the HBM
        peak; None for a card ``peaks.json`` does not list."""
        pk = peaks(self.device_name)
        if pk is None:
            return None
        c = self.cost(kernel).cost(self.config)
        return max(c["flops"] / pk["fp32_flops_per_s"],
                   c["bytes"] / pk["hbm_bytes_per_s"]) * 1e6

    def replays(self) -> List[List[Event]]:
        """The device events of each replay: the runs of events between
        the harness's probe read-outs."""
        out: List[List[Event]] = [[]]
        for e in self.events:
            if is_d2h(e[0]):
                if out[-1]:
                    out.append([])
            else:
                out[-1].append(e)
        return [r for r in out if r]


def breakdown(view: TraceView, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps of the window, each named by the harness span the host was in at
    the gap's middle."""
    per_op: Dict[str, float] = {}
    for name, a, b in view.events:
        per_op[name] = per_op.get(name, 0.0) + (b - a)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = view.window
    edges = [lo] + [x for iv in view._busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    host = [(name, a, b) for name, ivs in view.spans.items()
            if name != "rtbench.window" for a, b in ivs]

    def label(a: float, b: float) -> str:
        mid = (a + b) / 2
        inside = [n for n, x, y in host if x <= mid <= y]
        return inside[0] if inside else "rtbench.window"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[n, t * 1e-6] for n, t in ops],
        "idle_gaps": [[label(a, b), (b - a) * 1e-6] for a, b in longest],
    }
