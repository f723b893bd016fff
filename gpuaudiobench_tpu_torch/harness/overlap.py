"""Overlapped-infeed measurement: the input upload double-buffered
against device compute.

PyTorch counterpart of ``gpuaudiobench_tpu/harness/overlap.py``. Every
other tier is either fully serial (the round trip: upload, compute,
read, one block at a time) or fully on the device (the saturated chain:
no per-block host traffic). The steady state a DAW runs, uploading block
k+1 while block k computes, sits between them, and this module measures
it beside its serial twin in the same reps.

Mechanics on a CUDA device (``Infeed``): the host blocks are staged into
page-locked buffers once, before any timing (a ``non_blocking`` copy from
pageable memory is synchronous, so only pinned sources can overlap).
Uploads run on a side ``torch.cuda.Stream`` into two device input slots;
compute runs on the current stream and waits on an event for its slot's
upload, and an upload into a slot waits on an event for the compute that
last read it. A side stream does not synchronise with the current one on
its own: a missing wait gives wrong numbers silently, which is why
``run_overlapped`` returns its last output and carry, to be held equal to
``run_serial``'s. The serial twin uses the same slots and streams with a
probe read after every block, so the A/B measures the overlap alone. On
the CPU both loops run the same synchronous copies.

State: a stateful benchmark carries its device-resident state through the
loop (block k+1's filter memory depends on block k); only the input
upload is pipelined.
"""

from __future__ import annotations

import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from gpuaudiobench_tpu_torch.utils import device as dv


def _probe(y) -> None:
    """Read one element of a block's output to the host: waits for the
    current stream up to that block."""
    t = y if isinstance(y, torch.Tensor) else y[0]
    t.reshape(-1)[:1].cpu()


def _distinct(host_blocks, what: str) -> list:
    blocks = list(host_blocks)
    if len(blocks) < 2:
        raise ValueError(
            f"{what} needs >= 2 distinct host blocks (a single repeated "
            "buffer makes the upload dedupable; see "
            "base.Benchmark.overlap_body)")
    return blocks


class Infeed:
    """The host blocks of an overlap pass, staged for upload, and two
    device input slots; on a CUDA device also the copy stream and its
    events. ``upload(j)`` fills slot j % 2 with block j % len(blocks);
    ``compute(step_fn, j, carry)`` runs one block on slot j % 2 (on its
    row ``row`` when given)."""

    def __init__(self, host_blocks: Sequence, dev: torch.device):
        blocks = _distinct(host_blocks, "Infeed")
        self.dev = dev
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.sources = [
                b if isinstance(b, torch.Tensor) and b.is_pinned()
                else dv.stage_pinned(np.asarray(b), dev) for b in blocks]
        else:
            self.sources = [torch.from_numpy(np.ascontiguousarray(b))
                            for b in blocks]
        first = self.sources[0]
        for src in self.sources[1:]:
            if src.shape != first.shape or src.dtype != first.dtype:
                raise ValueError(
                    f"host blocks differ: {first.dtype} {tuple(first.shape)} "
                    f"and {src.dtype} {tuple(src.shape)}")
        self.slots = [torch.empty(first.shape, dtype=first.dtype, device=dev)
                      for _ in range(2)]
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(dev)
            for slot in self.slots:
                # The copy stream writes the slots: their memory is not
                # reused before its work on them is done.
                slot.record_stream(self.copy_stream)
            self.uploaded = [torch.cuda.Event() for _ in range(2)]
            self.consumed = [torch.cuda.Event() for _ in range(2)]

    def upload(self, j: int) -> None:
        s = j % 2
        src = self.sources[j % len(self.sources)]
        if not self.cuda:
            self.slots[s].copy_(src)
            return
        with torch.cuda.stream(self.copy_stream):
            # Not before the compute that last read the slot (a wait on
            # an event never recorded is a no-op).
            self.copy_stream.wait_event(self.consumed[s])
            self.slots[s].copy_(src, non_blocking=True)
            self.uploaded[s].record(self.copy_stream)

    def compute(self, step_fn: Callable, j: int, carry, row=None):
        s = j % 2
        x = self.slots[s] if row is None else self.slots[s][row]
        if not self.cuda:
            return step_fn(x, carry)
        stream = torch.cuda.current_stream(self.dev)
        stream.wait_event(self.uploaded[s])
        y, carry = step_fn(x, carry)
        self.consumed[s].record(stream)
        return y, carry


def run_serial(infeed: Infeed, step_fn: Callable, carry, depth: int):
    """upload(k), compute(k), probe read, then upload(k+1): ``depth``
    blocks; returns the last output and the carry."""
    y = None
    for k in range(depth):
        infeed.upload(k)
        y, carry = infeed.compute(step_fn, k, carry)
        _probe(y)
    return y, carry


def run_overlapped(infeed: Infeed, step_fn: Callable, carry, depth: int):
    """compute(k) enqueued, then upload(k+1) while it runs; one probe
    read at the end covers the pipeline. Returns the last output and the
    carry, which must be ``run_serial``'s from the same carry."""
    infeed.upload(0)
    y = None
    for k in range(depth):
        y, carry = infeed.compute(step_fn, k, carry)
        if k + 1 < depth:
            infeed.upload(k + 1)
    _probe(y)
    return y, carry


def measure_overlap(
    step_fn: Callable,
    host_blocks,
    carry,
    depth: int,
    reps: int,
    dev: torch.device,
) -> Tuple[List[float], List[float]]:
    """(serial_ms, overlapped_ms): per-block wall latencies, one of each
    per rep, serial first.

    ``step_fn(x_dev, carry) -> (y, carry')`` runs ONE block of device
    compute on an uploaded input block; ``host_blocks`` is a sequence of
    >= 2 DISTINCT host payloads (numpy arrays or pinned tensors) cycled
    across blocks (a single repeated buffer could make the upload
    dedupable); ``carry`` is the initial device-resident state (an empty
    tuple for stateless blocks), carried through every rep.
    """
    infeed = Infeed(host_blocks, dev)
    # Warm outside any timing.
    infeed.upload(0)
    y, carry = infeed.compute(step_fn, 0, carry)
    _probe(y)

    serial: List[float] = []
    overlapped: List[float] = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        _, carry = run_serial(infeed, step_fn, carry, depth)
        serial.append((time.perf_counter() - t0) / depth * 1000.0)

        t0 = time.perf_counter()
        _, carry = run_overlapped(infeed, step_fn, carry, depth)
        overlapped.append((time.perf_counter() - t0) / depth * 1000.0)
    return serial, overlapped


def batch_groups(host_blocks, batch: int) -> List[np.ndarray]:
    """The two stacked (batch, ...) groups that ``measure_overlap_batched``
    cycles: entry i of group g is block (g + i) % n. Group 1 is group 0
    shifted by one block, so the two differ whenever the blocks do. (The
    reference takes block (g*batch + i) % n, which repeats group 0 when
    n divides batch, e.g. two blocks and an even batch.)"""
    blocks = _distinct(host_blocks, "measure_overlap_batched")
    n = len(blocks)
    return [np.stack([np.asarray(blocks[(g + i) % n]) for i in range(batch)])
            for g in range(2)]


def run_batched(infeed: Infeed, step_fn: Callable, carry, depth: int,
                batch: int):
    """The overlapped loop with ``batch`` blocks an upload: group g + 1
    is enqueued at the start of group g, so batch - 1 blocks of compute
    overlap it. Returns the last output and the carry."""
    infeed.upload(0)
    y = None
    for k in range(depth):
        g, i = divmod(k, batch)
        if i == 0 and k + batch < depth:
            infeed.upload(g + 1)
        y, carry = infeed.compute(step_fn, g, carry, row=i)
    _probe(y)
    return y, carry


def measure_overlap_batched(
    step_fn: Callable,
    host_blocks,
    carry,
    depth: int,
    batch: int,
    reps: int,
    dev: torch.device,
) -> List[float]:
    """Overlapped steady state with ``batch`` blocks an upload: the
    blocks are stacked into (batch, ...) groups (``batch_groups``), one
    upload a group, and block k is row k % batch of its group on the
    device. Compute still runs one block at a time; batching adds
    ``batch`` blocks of input buffering at the producer. Returns
    per-block wall latencies (ms), one per rep, on the same terms as
    ``measure_overlap``'s overlapped list."""
    if depth % batch != 0:
        raise ValueError(f"depth ({depth}) must be a multiple of "
                         f"batch ({batch})")
    infeed = Infeed(batch_groups(host_blocks, batch), dev)
    infeed.upload(0)
    y, carry = infeed.compute(step_fn, 0, carry, row=0)
    _probe(y)

    out: List[float] = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        _, carry = run_batched(infeed, step_fn, carry, depth, batch)
        out.append((time.perf_counter() - t0) / depth * 1000.0)
    return out
