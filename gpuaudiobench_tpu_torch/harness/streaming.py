"""Saturated/streaming measurement: ``depth`` chained blocks per timing.

PyTorch counterpart of ``gpuaudiobench_tpu/harness/streaming.py``. The
chip's steady-state capability is the per-block cost with the launch
queue kept full: ``depth`` calls of the benchmark's ``step_fn`` with
state carried from block to block, each emitting a (1,) probe of its
output. The probes are stacked and copied to the host in ONE read,
which waits for the device (the counterpart of
``np.asarray(chained(carry))``), so the wall time covers all the work.

A chain takes one of two forms (``chain_form``):

* ``"cuda-graph"``, on a CUDA device for a capturable body: each depth's
  chain is one ``harness.graph.ChainGraph``, captured and instantiated
  before any timing and replayed once a rep, the counterpart of the
  reference's one ``lax.scan`` executable a depth. A replay starts from a
  copy of the entry carry, as every ``chained(carry)`` call of the
  reference does. A capture that fails raises.
* ``"loop"``, on the CPU and for a body its benchmark declares
  uncapturable (``Benchmark.stream_capturable``): ``run_chained``, a
  Python loop that launches every block from the host and hands the
  same carry to every rep (a body that writes its carry in place starts
  the next rep where the last one ended).

PyTorch runs eagerly, so nothing can hoist a loop-invariant block: every
``step_fn`` call launches its kernels, and a graph records them all.
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import torch
from torch.profiler import record_function

from gpuaudiobench_tpu_torch.harness.graph import ChainGraph


def probe(y: torch.Tensor) -> torch.Tensor:
    """Tiny per-block residue: mean |value| of the output block, (1,).
    It keeps every output element in use and gives soaks a
    state-integrity signal that tracks the whole block. A floating output
    takes one reduction pass, the L1 norm in float32 over the element
    count, with no full-size temporary (the reference's probe is one
    fused reduction). ``vector_norm`` refuses integers, so an integer
    output (SOL_MXU_int8) keeps ``abs`` then a float32 ``mean``: two
    passes."""
    if y.is_floating_point():
        norm = torch.linalg.vector_norm(y, 1, dtype=torch.float32)
        return (norm / y.numel()).reshape(1)
    return torch.mean(torch.abs(y), dtype=torch.float32).reshape(1)


def chain_form(device: torch.device, capturable: bool) -> str:
    """``"cuda-graph"`` for a capturable body on a CUDA device, else
    ``"loop"``."""
    return "cuda-graph" if device.type == "cuda" and capturable else "loop"


def run_chained(step_fn: Callable, carry, depth: int) -> torch.Tensor:
    """Run ``depth`` chained blocks from ``carry``; returns the stacked
    probes on the host, which waits for the device."""
    probes = []
    for _ in range(depth):
        carry, p = step_fn(carry)
        probes.append(p)
    return torch.cat(probes).cpu()


def measure_saturated(
    step_fn: Callable,
    carry,
    depth: int,
    reps: int = 5,
    form: str = "loop",
    name: str = "",
) -> List[float]:
    """Per-block wall latencies (ms) over ``reps`` runs of a
    ``depth``-block chain of ``form``, after one untimed warm pass."""
    return measure_saturated_multi(step_fn, carry, [depth], reps, form,
                                   name)[0]


def measure_saturated_marginal(
    step_fn: Callable,
    carry,
    depth: int,
    reps: int = 5,
    lo_depth: int = 0,
    form: str = "loop",
    name: str = "",
) -> Tuple[List[float], List[float], int]:
    """Amortized AND marginal per-block cost from one interleaved
    two-depth measurement: ``(amortized_ms, marginal_ms, lo_depth)``.

    * ``amortized_ms[i]`` = wall(depth)/depth for rep i.
    * ``marginal_ms[i]`` = (wall(depth) - wall(lo_depth)) /
      (depth - lo_depth) for rep i: every depth-independent cost (the
      probe read and its synchronisation, the first launches) cancels.

    Per-rep marginals of sub-noise bodies can go slightly negative; they
    are reported raw.
    """
    lo = lo_depth or max(1, depth // 4)
    if lo >= depth:
        raise ValueError(f"lo_depth ({lo}) must be < depth ({depth})")
    per_lo, per_hi = measure_saturated_multi(
        step_fn, carry, [lo, depth], reps, form, name
    )
    marginal = [
        (h * depth - l * lo) / (depth - lo)
        for l, h in zip(per_lo, per_hi)
    ]
    return per_hi, marginal, lo


def chains(step_fn: Callable, carry, depths: List[int], form: str,
           name: str = "") -> List[Callable[[], torch.Tensor]]:
    """One chain a depth, each a call that runs it and returns its probes
    on the host. ``"cuda-graph"``: the graphs are captured here, sharing
    one memory pool (they never run at once); ``"loop"``: ``run_chained``
    on ``carry``."""
    if form == "loop":
        return [lambda d=d: run_chained(step_fn, carry, d) for d in depths]
    if form != "cuda-graph":
        raise ValueError(f"invalid chain form: {form!r}")
    pool = torch.cuda.graph_pool_handle()
    return [ChainGraph(step_fn, carry, d, pool, name).run for d in depths]


def measure_saturated_multi(
    step_fn: Callable,
    carry,
    depths: List[int],
    reps: int = 5,
    form: str = "loop",
    name: str = "",
) -> List[List[float]]:
    """Per-block wall latencies (ms) for SEVERAL chain depths, timed
    round-robin WITHIN each rep (d1, d2, d1, d2, ...) so drift over the
    window cancels in depth-differencing consumers. Every depth's chain
    is built (a graph captured and instantiated) and run once untimed
    before any timing; ``name`` names the benchmark in a failed
    capture's error. The timed reps run inside a ``record_function``
    range, "saturated-reps", which a ``--capture`` trace shows. Returns
    one latency list per depth, in the order of ``depths``."""
    runs = chains(step_fn, carry, depths, form, name)
    for run in runs:
        run()

    out: List[List[float]] = [[] for _ in depths]
    with record_function("saturated-reps"):
        for _ in range(max(1, reps)):
            for i, (run, d) in enumerate(zip(runs, depths)):
                t0 = time.perf_counter()
                run()
                out[i].append((time.perf_counter() - t0) / d * 1000.0)
    return out
