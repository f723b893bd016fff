"""device_idle_pct.callback (%): the share of the measured window of a
callback cell in which no device event runs: the device's busy time per
callback, from the traced sub-window (edge to edge of the harness's
``rtbench.window`` range, over its callbacks), times the measured
window's callbacks, against that window's wall time on the host clock.
The measured window runs without the profiler, whose own recording of
the host's calls would widen the idle gaps between callbacks."""


def read(view):
    if view.kind != "callback" or not view.events or view.units == 0:
        return None
    busy = view.busy_us() / view.units * view.measured["units"]
    return 100.0 * (1.0 - busy / view.measured["window_us"])
