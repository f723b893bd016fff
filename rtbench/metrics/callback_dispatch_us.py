"""callback_dispatch_us (us): the host time of a callback spent in the
``torch.ops.gpuab`` operator calls, from each call to its return (the
dispatcher, the operator's allocations, its launches): the median over
the traced callbacks of their summed ``gpuab.op`` spans
(``rtbench/program_spans.py``)."""

from rtbench import program_spans as ps


def read(view):
    trees = ps.callbacks(view)
    if trees is None:
        return None
    return ps.median([sum(c.end_ns - c.start_ns for c in inside
                          if c.name == "gpuab.op") * 1e-3
                      for _, inside in trees])
