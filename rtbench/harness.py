"""One run of one cell: set-up, the measured window, the traced
sub-window, then the comparison with the plain reference.

The traffic's ``kind`` names the general generator that drives the
program, ``generators/<kind>.py``, and reads the mix's parameters from its
file. A generator's ``drive(bench, cell, seconds, traced, device, seed,
setup)`` warms every shape the window uses, marks the end of set-up,
runs the measured window (and with ``traced`` a profiled sub-window
after it), and returns the run's numbers and what the window produced,
on the host. The configuration's judge for that kind,
``reference/<config>.<kind>.py``, compares those outputs with the plain
reference once the device's peak memory has been read and the program's
state is freed.

Set-up makes the inputs from the seed on the device, hands a host copy
of them to the program's loader and keeps them on the device for the
reference. On the CPU (the tests) a chain is a loop of the step, since a
CUDA graph needs the card.
"""

from __future__ import annotations

import contextlib
import gc
import random
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from rtbench import trace as tr
from rtbench.spec import Cell

PROFILE_SESSIONS = 3  # a traced sub-window is taken again where it saw no device event


class Setup:
    """The phases of set-up on the ``time.perf_counter`` clock, from the
    process's start: ``mark(name)`` closes the phase ``name``."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.phases: Dict[str, float] = {}
        self._last = t_start

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.phases[name] = now - self._last
        self._last = now

    def total(self) -> float:
        return self._last - self.t_start


def span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile(fn: Callable[[], int], device: torch.device):
    """Run ``fn`` (which returns the units it ran) under ``torch.profiler``
    and return (device events, spans, the units of that session, the units
    of every session taken). A session with no device event is taken
    again, up to ``PROFILE_SESSIONS`` times in all; then the run fails: it
    never reports an empty trace as an idle card."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    units = 0
    for _ in range(PROFILE_SESSIONS):
        with torch_profile(activities=acts) as prof:
            n = fn()
        units += n
        events, spans = tr.split_events(prof)
        if events and spans.get("rtbench.window"):
            return events, spans, n, units
    raise RuntimeError(f"rtbench: {PROFILE_SESSIONS} profiler sessions saw "
                       "no device event")


def checked_blocks(total: int, count: int, seed: int) -> List[int]:
    """``count`` blocks of ``total`` drawn from the seed, the last always
    among them, in order."""
    rng = random.Random(seed ^ 0x5EED)
    picks = set(rng.sample(range(total), min(count, total)))
    picks.add(total - 1)
    return sorted(picks)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, setup: Setup,
             substitute: Optional[Callable] = None) -> Dict:
    """Run the cell once; returns the pieces of the result line.
    ``substitute(inputs, got)``, where given, replaces what the window
    produced before it is judged (the control of ``rtbench.control``)."""
    conf = cell.config
    inputs = cell.reference().make_inputs(conf, seed, device)
    setup.mark("inputs")
    # The program's objects live only inside ``drive``: what it returns
    # is on the host, and its device memory is freed before the
    # reference runs.
    out, got = cell.generator().drive(_program(conf, inputs, device, setup),
                                      cell, seconds, traced, device, seed,
                                      setup)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if substitute is not None:
        got = substitute(inputs, got)
    out.update(judge(cell, inputs, got, device))
    out["reference_s"] = time.perf_counter() - t_ref
    out["setup_phases"] = setup.phases
    return out


def judge(cell: Cell, inputs: Dict[str, torch.Tensor], got: Dict,
          device: torch.device) -> Dict:
    """The judge's numbers against its limits. ``correct`` holds where
    every limit is met; an item (a checked block, a kept callback) counts
    as failed where its own reading is past the limit of ``ITEM``, and a
    run that is not correct fails one at least."""
    check = cell.check()
    verdict = check.judge(inputs, cell.config, got, device)
    numbers, limits = verdict["numbers"], check.LIMITS
    correct = (set(numbers) == set(limits)
               and all(_within(v, limits[k]) for k, v in numbers.items()))
    failed = sum(1 for e in verdict["items"]
                 if not _within(e, limits[check.ITEM]))
    if not correct and failed == 0:
        failed = 1
    return {"correct": correct, "failed": failed, "numbers": numbers,
            "limits": limits, "info": verdict.get("info", {})}


def host_inputs(inputs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in inputs.items()}


def _program(conf: Dict, inputs: Dict[str, torch.Tensor],
             device: torch.device, setup: Setup):
    """The program's benchmark object with the inputs handed over by the
    loader the configuration names, which takes host arrays."""
    from gpuaudiobench_tpu_torch.config import BenchConfig
    from gpuaudiobench_tpu_torch.registry import create_benchmark

    prog = conf["program"]
    bench = create_benchmark(prog["benchmark"],
                             BenchConfig(**prog["bench_config"]), device)
    setup.mark("program")
    load = getattr(bench, prog["load"])
    host = host_inputs(inputs)
    if prog["load_args"] == "dict":
        load(host)
    else:
        load(*(host[k] for k in prog["load_args"]))
    setup.mark("load")
    return bench


def _within(value: float, limit: Optional[float]) -> bool:
    """A reading within its limit; a missing limit (not yet set) or a
    reading that is not a number fails."""
    return limit is not None and value == value and value <= limit


def peak(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    sync(device)
    return int(torch.cuda.max_memory_allocated(device))
