"""device_idle_pct.stream (%): the share of the traced window of a stream
cell, edge to edge of the harness's ``rtbench.window`` range, in which
no device event runs."""


def read(view):
    if view.kind != "stream" or not view.events:
        return None
    return 100.0 * (1.0 - view.busy_us() / view.window_us)
