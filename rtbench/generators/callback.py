"""Traffic of kind ``callback``: the program's round trip in a closed
loop of one client.

``Benchmark.iterate()`` launches the block, runs the kernel and copies
the output back to the host; the next callback is issued when the last
one's output is in host memory. Each callback is timed on the host
clock. The mix's file gives ``warm_callbacks`` (run in set-up),
``trace_callbacks`` (the traced sub-window) and ``kept_callbacks``: about
that many outputs of the window, spread over it from an offset drawn
from the seed, the last always among them, are kept for the judge. A
callback past the configuration's ``deadline_ms`` is late, not failed,
and is counted apart.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from rtbench.harness import peak, profile, span
from rtbench.stats import interpolated_percentile


def drive(bench, cell, seconds: float, traced: bool, device: torch.device,
          seed: int, setup) -> tuple:
    traffic = cell.traffic
    for _ in range(int(traffic["warm_callbacks"])):
        bench.iterate()
    kept: Dict[int, np.ndarray] = {}
    t0 = time.perf_counter()
    for _ in range(16):
        bench.iterate()
    each = max((time.perf_counter() - t0) / 16, 1e-6)
    stride = max(1, int(seconds / each) // int(traffic["kept_callbacks"]))
    offset = random.Random(seed).randrange(stride)
    setup.mark("warm")

    def window(seconds: Optional[float], count: Optional[int], on: bool):
        """Callbacks until ``seconds`` have passed or ``count`` are done;
        returns the latencies (s) and the wall time (s)."""
        lat: List[float] = []
        start = time.perf_counter()
        with span("rtbench.window", on):
            while True:
                i = len(lat)
                issued = time.perf_counter()
                with span("rtbench.callback", on):
                    bench.iterate()
                done = time.perf_counter()
                lat.append(done - issued)
                if not on and i % stride == offset:
                    kept[i] = bench.host_output
                if count is not None and len(lat) >= count:
                    break
                if seconds is not None and done - start >= seconds:
                    break
            kept[-1] = bench.host_output
        return lat, time.perf_counter() - start

    out: Dict = {"setup_s": setup.total()}
    lat, wall = window(seconds, None, False)
    lat.sort()
    out["roundtrip_p50_ms"] = interpolated_percentile(lat, 50.0) * 1e3
    out["roundtrip_p95_ms"] = interpolated_percentile(lat, 95.0) * 1e3
    out["late"] = sum(1 for x in lat if x * 1e3 > cell.config["deadline_ms"])
    out["attempted"] = len(lat)
    out["measured"] = {"window_us": wall * 1e6, "units": len(lat),
                       "unit_p50_us": out["roundtrip_p50_ms"] * 1e3}
    if traced:
        n = int(traffic["trace_callbacks"])

        def traced_window():
            return len(window(None, n, True)[0])

        events, spans, n, units = profile(traced_window, device)
        out["trace"] = (events, spans, n, n)
        out["attempted"] += units
    out["memory_peak_bytes"] = peak(device)
    got = {"outputs": [kept[i] for i in sorted(kept)]}
    return out, got
