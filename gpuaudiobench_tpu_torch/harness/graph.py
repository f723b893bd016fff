"""One block of device work captured once as a CUDA graph and replayed.

A block made of many small launches (the LSTM's 512 dependent steps, a
handful of torch ops each) costs more host time to enqueue than the card
spends on it. ``CapturedBlock`` records such a block once with
``torch.cuda.CUDAGraph`` and replays the recording: one host call a
block, whatever its launch count.

A graph reads and writes fixed addresses. So the block is a function
over tensors the ``CapturedBlock`` owns (``static``): a call copies its
arguments into them (skipping one that already is its static tensor),
replays, and returns the tensors the function returned at capture. Every
replay writes those same output tensors again: a caller that keeps an
output across replays must copy it.

The function must not write its inputs, must not wait for the device
(no ``.item()``, no branch on a tensor's value) and must allocate the
same shapes on every call. A capture that breaks a rule raises; nothing
falls back to running the function eagerly. On the CPU there is no
graph, and the constructor raises.

``ChainGraph`` captures a whole saturated chain: ``depth`` chained calls
of a benchmark's stream step, the counterpart of the reference's one
``lax.scan`` executable a depth (``harness/streaming.py``). Its
continuing form carries the state from replay to replay instead, the
counterpart of the soak's ``one_second`` scan whose exit carry is the
next call's entry carry (``tools/soak.py``). A kernel wrapper counts its
launch with ``count_launch``: under a chain's capture the call records
the launch, which every replay then makes. A chain's graph is a
``ChainCUDAGraph``, whose ``replay()`` itself counts: one in
``CHAIN_REPLAYS`` and the chain's recorded launches in
``REPLAYED_LAUNCHES``, under a ``gpuab.replay`` span, whoever calls it.
Each capture records its chain's depth and graph nodes in ``CHAINS``.
"""

from __future__ import annotations

import collections
import ctypes
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from gpuaudiobench_tpu_torch.harness.profiler import span

WARMUP_CALLS = 2

# Kernel launches made by chain replays, by the wrappers' kernel names,
# and the replays themselves (chip_smoke.py reads both: a kernel's
# launches on a path are its wrapper's count plus its replayed count).
REPLAYED_LAUNCHES: Dict[str, int] = collections.defaultdict(int)
CHAIN_REPLAYS: Dict[str, int] = {"chain": 0}
# The launch tally of the chain being captured, if one is.
_RECORDING: List[Dict[str, int]] = []
# Every chain captured in this process, under its name: one entry a
# capture, its ``depth`` (blocks), its graph's ``nodes`` and whether it is
# ``continuing``.
CHAINS: Dict[str, List[Dict[str, int]]] = collections.defaultdict(list)


def count_launch(counts: Dict[str, int], key: str) -> None:
    """Count one launch of kernel ``key`` in its wrapper's ``counts``; a
    call inside a chain's capture records the launch instead, in that
    chain's tally, and each replay of the chain makes it."""
    if _RECORDING:
        _RECORDING[-1][key] += 1
    else:
        counts[key] += 1


def leaves(carry) -> list:
    """The leaves of a carry (a tensor, or nested tuples and lists of
    tensors and Python values), in order: its tensors and Python values."""
    if isinstance(carry, (tuple, list)):
        return [leaf for c in carry for leaf in leaves(c)]
    return [carry]


def rebuild(carry, values):
    """``carry`` with every leaf taken in order from the iterator
    ``values``."""
    if isinstance(carry, (tuple, list)):
        return type(carry)(rebuild(c, values) for c in carry)
    return next(values)


def _tensors(carry) -> List[torch.Tensor]:
    """The tensors of a carry, in order."""
    return [leaf for leaf in leaves(carry) if isinstance(leaf, torch.Tensor)]


def python_values(carry) -> list:
    """The leaves of a carry that are not tensors (a ring head, a phase),
    in order. A graph fixes them as its capture saw them."""
    return [leaf for leaf in leaves(carry)
            if not isinstance(leaf, torch.Tensor)]


def clone_carry(carry):
    """``carry`` with every tensor cloned."""
    return rebuild(carry, iter([leaf.clone() if isinstance(leaf, torch.Tensor)
                                else leaf for leaf in leaves(carry)]))


class CapturedBlock:
    """``fn(*static)`` captured as one CUDA graph. ``block(*args)`` copies
    ``args`` into ``static`` and replays; ``block()`` replays on the
    static inputs as they stand. Both return the captured outputs (a
    tuple). Each replay adds one to ``counts[key]`` when ``counts`` is
    given."""

    def __init__(self, fn: Callable[..., Tuple[torch.Tensor, ...]],
                 static: Sequence[torch.Tensor],
                 counts: Optional[Dict[str, int]] = None, key: str = ""):
        self.static = tuple(static)
        devices = {t.device for t in self.static}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(
                "CapturedBlock: the static tensors must lie on one CUDA "
                f"device, got {sorted(str(d) for d in devices)}")
        self.device = next(iter(devices))
        self.counts, self.key = counts, key
        # Warm up on a side stream (cuBLAS handles and workspaces, the
        # allocator's blocks), then capture on the stream torch.cuda.graph
        # provides. The function is pure, so warming up on the static
        # inputs leaves them as they were.
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                fn(*self.static)
        current.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                out = fn(*self.static)
        except RuntimeError as e:
            raise RuntimeError(
                f"CapturedBlock: capturing {key or 'the block'} failed: "
                f"{e}") from e
        self.outputs = tuple(out) if isinstance(out, (tuple, list)) else (out,)

    def __call__(self, *args: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if args:
            if len(args) != len(self.static):
                raise ValueError(f"CapturedBlock: {len(args)} arguments for "
                                 f"{len(self.static)} static inputs")
            for a, s in zip(args, self.static):
                if a.shape != s.shape:
                    raise ValueError(f"CapturedBlock: argument of shape "
                                     f"{tuple(a.shape)} for a static input "
                                     f"of {tuple(s.shape)}")
                if a.data_ptr() != s.data_ptr():
                    s.copy_(a)
        self.graph.replay()
        if self.counts is not None:
            self.counts[self.key] += 1
        return self.outputs


def _graph_nodes(graph: "torch.cuda.CUDAGraph") -> int:
    """The node count of a captured graph (``cuGraphGetNodes`` on its
    ``cudaGraph_t``, the same handle as a ``CUgraph``)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    err = cuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                               ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUDA error {err}")
    return count.value


class ChainCUDAGraph(torch.cuda.CUDAGraph):
    """A chain's CUDA graph: each ``replay()`` runs under a
    ``gpuab.replay`` span and counts itself in ``CHAIN_REPLAYS`` and the
    launches its capture recorded (``captured``) in
    ``REPLAYED_LAUNCHES``."""

    captured: Dict[str, int]

    def replay(self) -> None:
        with span("gpuab.replay"):
            super().replay()
        CHAIN_REPLAYS["chain"] += 1
        for key, n in self.captured.items():
            REPLAYED_LAUNCHES[key] += n


class AdvancingCarry(ValueError):
    """A continuing chain's body moves a Python value of its carry within
    the chain: a replay would run every later chain with the values its
    capture saw."""


def check_continues(entry, exit_, depth: int, name: str = "") -> None:
    """Raise ``AdvancingCarry`` where a chain of ``depth`` steps leaves the
    carry's Python values (``exit_``) other than it found them
    (``entry``)."""
    if python_values(exit_) != python_values(entry):
        raise AdvancingCarry(
            f"ChainGraph: {name or 'the chain'}'s Python values go from "
            f"{python_values(entry)} to {python_values(exit_)} in {depth} "
            "blocks; a continuing graph would replay the first ones")


class ChainGraph:
    """``depth`` chained calls of ``step_fn`` from ``carry``, captured as
    one CUDA graph: ``run()`` replays it and returns the ``(depth,)``
    stacked probes on the host, a read that waits for the device.

    ``step_fn(carry) -> (carry', probe)`` obeys the capture rules of
    ``Benchmark.stream_body``. The graph owns a snapshot of the entry
    carry's tensors, taken at construction, and each replay begins with a
    captured copy of it into tensors of the graph's pool: so every replay
    gives the probes a loop of ``depth`` steps gives from a fresh clone
    of the entry carry, whatever the step writes in place, and a Python
    value of the carry (PartConv's ring head) advances from its entry
    value through the ``depth`` captured steps. The capture is warmed on
    a side stream first (``WARMUP_CALLS`` chains: cuBLAS handles, cuFFT
    plans, the kernels' cached attributes and the FDTD receiver buckets),
    and a capture that fails raises, naming ``name``.

    ``continuing=True`` makes the continuing form: the graph owns static
    copies of the carry's tensors (``carry()``), each replay runs the
    ``depth`` steps from them, and the captured tail copies the exit
    carry back into them, so a replay starts where the last one ended:
    ``n`` replays give the state and the probes of a loop of ``n *
    depth`` steps. The warm-up runs on the static copies and restores
    them after from ``carry``, which no chain writes. A body whose Python
    values leave the chain other than they entered it raises
    ``AdvancingCarry`` (``check_continues``) in the warm-up, before
    anything is captured; ``carry`` is then as it was.

    ``pool`` lets graphs that never run at once share memory
    (``torch.cuda.graph_pool_handle()``). ``captured`` holds the kernel
    launches the capture recorded, by wrapper name; ``capture_s``,
    ``instantiate_s`` and ``nodes`` describe the capture.
    """

    def __init__(self, step_fn: Callable, carry, depth: int,
                 pool=None, name: str = "", continuing: bool = False):
        entry = _tensors(carry)
        devices = {t.device for t in entry}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(
                f"ChainGraph: {name or 'the chain'}'s carry must lie on one "
                f"CUDA device, got {sorted(str(d) for d in devices)}")
        if depth < 1:
            raise ValueError(f"ChainGraph: depth {depth} < 1")
        device = next(iter(devices))
        self._entry_carry = clone_carry(carry)
        self.entry = _tensors(self._entry_carry)

        def chain():
            c = (self._entry_carry if continuing
                 else clone_carry(self._entry_carry))
            probes = []
            for _ in range(depth):
                c, p = step_fn(c)
                probes.append(p)
            if continuing:
                check_continues(carry, c, depth, name)
                exit_ = _tensors(c)
                # A static tensor handed on to another leaf (a swap) is
                # read before any copy writes it.
                moved = [t.clone() if t is not s
                         and any(t is e for e in self.entry) else t
                         for s, t in zip(self.entry, exit_)]
                for s, t in zip(self.entry, moved):
                    if t is not s:
                        s.copy_(t)
            return torch.cat(probes)

        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    chain()
                if continuing:  # back to the caller's carry, never written
                    for s, t in zip(self.entry, entry):
                        s.copy_(t)
        finally:
            current.wait_stream(side)
        torch.cuda.synchronize(device)
        self.graph = ChainCUDAGraph(keep_graph=True)
        self.captured: Dict[str, int] = collections.defaultdict(int)
        self.graph.captured = self.captured
        t0 = time.perf_counter()
        _RECORDING.append(self.captured)
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.probes = chain()
        except RuntimeError as e:
            raise RuntimeError(
                f"ChainGraph: capturing {depth} blocks of "
                f"{name or 'the chain'} failed: {e}") from e
        finally:
            _RECORDING.pop()
        self.capture_s = time.perf_counter() - t0
        self.nodes = _graph_nodes(self.graph)
        CHAINS[name].append({"depth": depth, "nodes": self.nodes,
                             "continuing": continuing})
        t0 = time.perf_counter()
        self.graph.instantiate()
        torch.cuda.synchronize(device)
        self.instantiate_s = time.perf_counter() - t0

    def carry(self):
        """The carry a replay starts from: the entry carry's structure and
        Python values over the graph's own tensors (the static copies of
        the continuing form, which each replay advances in place)."""
        return self._entry_carry

    def run(self) -> torch.Tensor:
        """One replay; the stacked probes on the host."""
        self.graph.replay()
        return self.probes.cpu()
