"""What the program's spans read on the modal round trip, and what they
cost.

ModalFilterBank's ``iterate()`` (the round trip: the model's and the
wrapper's Python, the operator call, the copy back to the host), by
default at 1,000,000 modes folded onto 32 tracks, 512 samples, in rounds
of ``--callbacks`` callbacks under each of three settings, in turns (the
order reversed every other round):

* ``off``: the recorder off (no profiler session, no ``enable()``);
* ``on``: the spans recorded without the profiler (``enable()``);
* ``traced``: under a ``torch.profiler`` session (CPU, and CUDA on the
  card), which turns the spans on and makes each a range.

For each setting: the round trip's median and p95 on the host clock
around ``iterate()``; for ``on`` and ``traced`` the median a callback of
each span: the root (``gpuab.iterate``), its own time (less its
``gpuab.op``, ``gpuab.d2h`` and ``gpuab.h2d`` children), the operator
calls and the copies; and the largest gap between a root's duration and
its own time plus its children's. Beside them the cost of one empty span,
off and on, from a loop of them, and the two children apart, unprofiled
(``drained``): the model's device work alone (``device_iterate()``, its
operator call with the card idle), the card drained, then a copy back of
an output of the same shape already on the card (no kernel to wait for:
the copy, the wake-up and the array).

    python -m gpuaudiobench_tpu_torch.tools.span_cost [--modes N]
        [--tracks N] [--buffer N] [--callbacks N] [--rounds N]
        [--device cuda|cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict, List, Optional

import torch

from gpuaudiobench_tpu_torch.harness import profiler
from gpuaudiobench_tpu_torch.harness.statistics import interpolated_percentile

SETTINGS = ("off", "on", "traced")
COPIES = ("gpuab.d2h", "gpuab.h2d")
EMPTY_SPANS = 200_000


def _bench(modes: int, tracks: int, buffer: int, device: torch.device):
    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.registry import create_benchmark

    cfg = BenchConfig(n_tracks=tracks, buffer_size=buffer,
                      modal_num_modes=modes, verification="none",
                      device_timing=False, write_latencies=False, quiet=True)
    bench = create_benchmark("ModalFilterBank", cfg, device)
    bench.setup()
    return bench


def _callbacks(bench, n: int) -> List[float]:
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        bench.iterate()
        lat.append(time.perf_counter() - t0)
    return lat


def run_setting(bench, setting: str, n: int, device: torch.device):
    """``n`` callbacks under ``setting``: (latencies s, the roots and the
    spans inside them; none when off)."""
    profiler.SPANS.reset()
    if setting == "off":
        return _callbacks(bench, n), []
    if setting == "on":
        profiler.enable()
        try:
            lat = _callbacks(bench, n)
        finally:
            profiler.disable()
    else:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts):
            lat = _callbacks(bench, n)
    return lat, profiler.SPANS.trees(n)


def span_medians(trees) -> Dict[str, float]:
    """The median a callback (us) of the root, its own time, the operator
    calls and each copy; and the largest gap (us) of a root's own time
    plus its children's from its duration."""
    rows: Dict[str, List[float]] = {"gpuab.iterate": [], "wrapper": [],
                                    "gpuab.op": [], "gpuab.d2h": [],
                                    "gpuab.h2d": []}
    gap = 0.0
    for root, inside in trees:
        dur = (root.end_ns - root.start_ns) * 1e-3
        kids = [c for c in inside if c.parent == root.serial]
        own = profiler.self_ns(root, inside) * 1e-3
        gap = max(gap, abs(own + sum(c.end_ns - c.start_ns for c in kids)
                           * 1e-3 - dur))
        rows["gpuab.iterate"].append(dur)
        rows["wrapper"].append(profiler.self_ns(
            root, inside, ("gpuab.op",) + COPIES) * 1e-3)
        for name in ("gpuab.op",) + COPIES:
            rows[name].append(sum(c.end_ns - c.start_ns for c in inside
                                  if c.name == name) * 1e-3)
    out = {k: statistics.median(v) for k, v in rows.items() if v}
    out["self_plus_children_gap_us"] = gap
    return out


def drained(bench, n: int, device: torch.device) -> Dict[str, float]:
    """The median (us) of the ``gpuab.op`` and ``gpuab.d2h`` spans of
    ``n`` rounds of: the device work alone, the card drained, a copy back
    of a ready output of the round trip's shape (on the CPU the device
    work is the plain twin, with no operator call)."""
    from gpuaudiobench_tpu_torch.utils import device as dev

    ready = torch.zeros((bench.output_tracks, bench.buffer_size),
                        device=device)
    profiler.SPANS.reset()
    profiler.enable()
    try:
        for _ in range(n):
            bench.device_iterate()
            dev.block(device)
            dev.from_device(ready)
    finally:
        profiler.disable()
    times: Dict[str, List[float]] = {}
    for r in profiler.SPANS.records():
        times.setdefault(r.name, []).append((r.end_ns - r.start_ns) * 1e-3)
    return {name: statistics.median(v) for name, v in times.items()}


def empty_span_ns(n: int = EMPTY_SPANS) -> Dict[str, float]:
    """ns a ``with span(...)`` of an empty body, off and on."""
    out = {}
    for setting in ("off", "on"):
        profiler.SPANS.reset()
        if setting == "on":
            profiler.enable()
        try:
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with profiler.span("gpuab.op"):
                    pass
            out[setting] = (time.perf_counter_ns() - t0) / n
        finally:
            profiler.disable()
    profiler.SPANS.reset()
    return out


def measure(modes: int, tracks: int, buffer: int, callbacks: int,
            rounds: int, device: torch.device) -> Dict[str, object]:
    from gpuaudiobench_tpu_torch.utils.device import gpu_identity

    bench = _bench(modes, tracks, buffer, device)
    _callbacks(bench, max(1, callbacks // 4))  # warm
    lat: Dict[str, List[float]] = {s: [] for s in SETTINGS}
    spans: Dict[str, List[Dict[str, float]]] = {"on": [], "traced": []}
    apart: List[Dict[str, float]] = []
    for r in range(rounds):
        for setting in (SETTINGS if r % 2 == 0 else SETTINGS[::-1]):
            got, trees = run_setting(bench, setting, callbacks, device)
            lat[setting].extend(got)
            if setting in spans:
                spans[setting].append(span_medians(trees))
        apart.append(drained(bench, callbacks, device))
    result: Dict[str, object] = {
        "card": gpu_identity(device), "modes": modes, "tracks": tracks,
        "buffer": buffer, "callbacks": callbacks, "rounds": rounds,
        "empty_span_ns": empty_span_ns(),
        "drained_us": {k: statistics.median(a[k] for a in apart)
                       for k in apart[0]}}
    for setting in SETTINGS:
        xs = sorted(lat[setting])
        result[setting] = {"roundtrip_p50_us": interpolated_percentile(
            xs, 50.0) * 1e6, "roundtrip_p95_us": interpolated_percentile(
            xs, 95.0) * 1e6}
        if setting in spans:
            per_round = spans[setting]
            result[setting]["spans_us"] = {
                k: statistics.median(r[k] for r in per_round)
                for k in per_round[0] if k != "self_plus_children_gap_us"}
            result[setting]["self_plus_children_gap_us"] = max(
                r["self_plus_children_gap_us"] for r in per_round)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="span_cost",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--modes", type=int, default=1_000_000)
    p.add_argument("--tracks", type=int, default=32)
    p.add_argument("--buffer", type=int, default=512)
    p.add_argument("--callbacks", type=int, default=2000)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from gpuaudiobench_tpu_torch.utils.device import device

    res = measure(args.modes, args.tracks, args.buffer, args.callbacks,
                  args.rounds, device(args.device))
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
