"""The port's own spans and chain shapes, for the per-layer readers.

The program records its spans (``gpuaudiobench_tpu_torch.harness.profiler``:
``SPANS``, one ring a process) while a profiler session runs, so the
traced sub-window fills it with no switch: each callback's ``iterate()``
is a root span ``gpuab.iterate``, and the operator calls (``gpuab.op``)
and copies (``gpuab.d2h``, ``gpuab.h2d``) inside it are its children,
stamped on the host's ``time.perf_counter_ns`` clock. The traced
callbacks are the ring's last ``len(view.spans["rtbench.callback"])``
roots. Each chain graph the program captures records its depth and node
count (``harness.graph.CHAINS``). Where the program keeps no such records
(an older program) or the session left too few, every function here
returns None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from rtbench.stats import interpolated_percentile

ROOT = "gpuab.iterate"
COPIES = ("gpuab.d2h", "gpuab.h2d")


def _recorder():
    try:
        from gpuaudiobench_tpu_torch.harness import profiler
    except ImportError:
        return None
    return getattr(profiler, "SPANS", None)


def callbacks(view) -> Optional[List[Tuple[object, list]]]:
    """(root, the spans inside it) of each traced callback, in order, or
    None where the recorder holds fewer ``gpuab.iterate`` roots than the
    traced sub-window has callbacks."""
    n = len(view.spans.get("rtbench.callback", []))
    rec = _recorder()
    if view.kind != "callback" or n == 0 or rec is None:
        return None
    trees = rec.trees(n)
    if len(trees) != n or any(r.name != ROOT for r, _ in trees):
        return None
    return trees


def median(values: List[float]) -> Optional[float]:
    return interpolated_percentile(sorted(values), 50.0) if values else None


def children_us(root, inside, names) -> float:
    """The summed durations (us) of ``root``'s direct children named in
    ``names``."""
    return sum(c.end_ns - c.start_ns for c in inside
               if c.parent == root.serial and c.name in names) * 1e-3


def continuing_chain() -> Optional[Dict[str, int]]:
    """The depth and node count of the process's one continuing chain
    graph, or None where it has none or more than one."""
    try:
        from gpuaudiobench_tpu_torch.harness import graph
    except ImportError:
        return None
    chains = [c for cs in getattr(graph, "CHAINS", {}).values() for c in cs
              if c.get("continuing")]
    return chains[0] if len(chains) == 1 else None
