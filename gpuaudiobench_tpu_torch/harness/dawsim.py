"""DAW-load simulator and deadline tracking.

PyTorch-package copy of ``gpuaudiobench_tpu/harness/dawsim.py`` (pure
Python; the port keeps its own). Port of Metal's DAWSimulator
(BenchmarkUtilities.swift:140-178): between iterations, wait until the
next audio-buffer boundary (nextStart += bufferDuration) by spinning or
sleeping, with optional uniform random jitter (+-jitter_us). This models
a plugin called back once per hardware buffer instead of free-running,
which is what perturbs the GPU's scheduling in the paper's tab7/tab8
measurements.

``deadline_miss_rate`` ports Statistics.swift:172-192: the percentage of
iteration latencies above bufferSize/fs.

``utils/native.py`` has the same pacer in C++; ``make_dawsim`` there
prefers it and falls back to this one. Each pacer names itself in
``pacer``.
"""

from __future__ import annotations

import random
import time
from typing import Sequence


class DAWSimulator:
    pacer = "python"

    def __init__(
        self,
        buffer_size: int,
        fs: int,
        mode: str = "spin",
        jitter_us: float = 0.0,
        seed: int = 42,
    ):
        if mode not in ("spin", "sleep"):
            raise ValueError(f"invalid dawsim mode: {mode}")
        self.buffer_duration = buffer_size / fs
        self.mode = mode
        self.jitter_us = jitter_us
        self._rng = random.Random(seed)
        self._next_start = None

    def reset(self) -> None:
        self._next_start = None

    def wait(self) -> None:
        """Block until the next buffer boundary
        (BenchmarkUtilities.swift:154-177)."""
        now = time.perf_counter()
        if self._next_start is None:
            self._next_start = now + self.buffer_duration
            return
        target = self._next_start
        if self.jitter_us > 0.0:
            target += self._rng.uniform(-self.jitter_us, self.jitter_us) * 1e-6
        if self.mode == "sleep":
            remaining = target - now
            if remaining > 0:
                time.sleep(remaining)
        else:  # spin
            while time.perf_counter() < target:
                pass
        # Advance the schedule; after an overrun, resynchronize from now so
        # one slow iteration does not make every later wait a no-op.
        self._next_start += self.buffer_duration
        if self._next_start < time.perf_counter():
            self._next_start = time.perf_counter() + self.buffer_duration


def deadline_miss_rate(latencies_ms: Sequence[float], buffer_size: int,
                       fs: int) -> float:
    """Percentage of iterations exceeding the buffer deadline
    (Statistics.swift:180-191)."""
    if not latencies_ms:
        return 0.0
    deadline_ms = 1000.0 * buffer_size / fs
    missed = sum(1 for v in latencies_ms if v > deadline_ms)
    return 100.0 * missed / len(latencies_ms)
