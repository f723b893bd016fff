"""callback_wrapper_us (us): the host time of a callback spent in the
model's and the wrapper's own Python (checks, the schedule's lookup, the
library's handle): the median over the traced callbacks of the program's
``gpuab.iterate`` span less its ``gpuab.op``, ``gpuab.d2h`` and
``gpuab.h2d`` children (``rtbench/program_spans.py``)."""

from rtbench import program_spans as ps


def read(view):
    trees = ps.callbacks(view)
    if trees is None:
        return None
    names = ("gpuab.op",) + ps.COPIES
    return ps.median([(r.end_ns - r.start_ns) * 1e-3
                      - ps.children_us(r, inside, names)
                      for r, inside in trees])
