"""callback_host_us (us): the part of a callback in which the card waits
on the host (launch, the wrapper's checks, the wake-up after the copy
back): the measured window's median callback on the host clock, less the
median of the device's busy time inside a traced callback (the harness's
range around one ``iterate()``). The measured window runs without the
profiler, whose own recording of the host's calls lengthens a traced
callback; the device's busy time is the trace's."""

from rtbench.stats import interpolated_percentile


def read(view):
    spans = view.spans.get("rtbench.callback", [])
    p50 = view.measured.get("unit_p50_us")
    if view.kind != "callback" or not spans or not view.events or p50 is None:
        return None
    busy = sorted(view.busy_us(a, b) for a, b in spans)
    return p50 - interpolated_percentile(busy, 50.0)
