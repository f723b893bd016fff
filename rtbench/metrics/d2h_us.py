"""d2h_us (us): the device time per callback of the copy of the output
back to the host (the profiler's device-to-host copies)."""

from rtbench.trace import is_d2h


def read(view):
    if view.kind != "callback" or view.units == 0:
        return None
    spent = view.time_us(is_d2h)
    if spent <= 0:
        return None
    return spent / view.units
