"""Traffic of kind ``stream``: blocks chained back to back.

The program's ``Benchmark.stream_body()`` step is captured as one
continuing ``ChainGraph`` of ``depth`` blocks and replayed back to back
for the window, with up to ``in_flight`` replays queued; each replay's
probes are copied to pinned host memory behind it, and the host waits
only for the replay ``in_flight - 1`` before the newest. ``block_ms`` is
the window's wall time over all the blocks it ran. The mix's file gives
``depth``, ``in_flight``, ``warm_replays`` (run before the window, in
set-up), ``trace_replays`` (the traced sub-window) and
``checked_blocks`` (drawn from the seed for the comparison, the last
always among them).

What the window produced, for the judge: the carry it ends in, as the
configuration's ``program_state`` reads it, the probes of the checked
blocks, numbered from the inputs (the loader's own blocks first), and
the number of blocks run from the inputs.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from rtbench.harness import checked_blocks, peak, profile, span, sync

CHUNK_ROWS = 256  # replays of probes a pinned read-out buffer holds


class LoopChain:
    """A chain on the CPU: ``depth`` calls of the step from the carry,
    the carry kept for the next replay."""

    def __init__(self, step: Callable, carry, depth: int):
        self.step, self.state, self.depth = step, carry, depth
        self.probes = None

    def replay(self) -> None:
        probes = []
        for _ in range(self.depth):
            self.state, p = self.step(self.state)
            probes.append(p)
        self.probes = torch.cat(probes)

    def carry(self):
        return self.state


class GraphChain:
    """The program's continuing ``ChainGraph``: a replay runs ``depth``
    blocks from its static carry and leaves the exit carry there."""

    def __init__(self, step: Callable, carry, depth: int, name: str):
        from gpuaudiobench_tpu_torch.harness.graph import ChainGraph

        self.graph = ChainGraph(step, carry, depth, name=name, continuing=True)
        self.probes = self.graph.probes

    def replay(self) -> None:
        self.graph.graph.replay()

    def carry(self):
        return self.graph.carry()


class ProbeLog:
    """Every replay's probes, copied behind the replay into page-locked
    host rows (on the CPU, plain rows)."""

    def __init__(self, depth: int, device: torch.device):
        self.depth, self.device = depth, device
        self.chunks: List[torch.Tensor] = []
        self.rows = 0

    def add(self, probes: torch.Tensor) -> None:
        if self.rows == len(self.chunks) * CHUNK_ROWS:
            self.chunks.append(torch.empty(
                (CHUNK_ROWS, self.depth), dtype=torch.float32,
                pin_memory=self.device.type == "cuda"))
        row = self.chunks[-1][self.rows % CHUNK_ROWS]
        row.copy_(probes, non_blocking=self.device.type == "cuda")
        self.rows += 1

    def values(self) -> np.ndarray:
        """All probes in block order; read after the device is synchronised."""
        flat = torch.cat(self.chunks)[: self.rows] if self.chunks else torch.empty(0)
        return flat.reshape(-1).numpy().astype(np.float64)


def drive(bench, cell, seconds: float, traced: bool, device: torch.device,
          seed: int, setup) -> tuple:
    traffic = cell.traffic
    depth, ahead = int(traffic["depth"]), int(traffic["in_flight"])
    step, carry = bench.stream_body()
    chain = (GraphChain(step, carry, depth, cell.name)
             if device.type == "cuda" else LoopChain(step, carry, depth))
    setup.mark("capture")
    log = ProbeLog(depth, device)
    marks = ([torch.cuda.Event() for _ in range(ahead)]
             if device.type == "cuda" else [])

    def window(seconds: Optional[float], replays: Optional[int], on: bool):
        """Replays back to back until ``seconds`` have passed or
        ``replays`` are done; returns (replays, wall s)."""
        k = 0
        sync(device)
        t0 = time.perf_counter()
        with span("rtbench.window", on):
            while True:
                with span("rtbench.replay", on):
                    chain.replay()
                    log.add(chain.probes)
                    if marks:
                        marks[k % ahead].record()
                if marks and k + 1 >= ahead:
                    with span("rtbench.wait", on):
                        marks[(k + 1) % ahead].synchronize()
                k += 1
                if replays is not None and k >= replays:
                    break
                if seconds is not None and time.perf_counter() - t0 >= seconds:
                    break
            sync(device)
        return k, time.perf_counter() - t0

    window(None, int(traffic["warm_replays"]), False)
    warm = log.rows
    setup.mark("warm")
    out: Dict = {"setup_s": setup.total()}
    replays, wall = window(seconds, None, False)
    out["block_ms"] = wall / (replays * depth) * 1e3
    out["attempted"] = replays * depth
    out["measured"] = {"window_us": wall * 1e6, "units": replays,
                       "blocks": replays * depth}
    if traced:
        def traced_window():
            return window(None, int(traffic["trace_replays"]), True)[0]

        events, spans, n, units = profile(traced_window, device)
        out["trace"] = (events, spans, n * depth, n)
        out["attempted"] += units * depth
    out["memory_peak_bytes"] = peak(device)
    probes = log.values()
    loader_blocks = int(cell.config["program"]["loader_blocks"])
    first = loader_blocks + warm * depth
    picks = checked_blocks((log.rows - warm) * depth,
                           int(traffic["checked_blocks"]), seed)
    got = {"state": cell.check().program_state(chain.carry()),
           "probes": {first + b: float(probes[warm * depth + b]) for b in picks},
           "blocks": loader_blocks + log.rows * depth,
           "checked": [first + b for b in picks]}
    return out, got
