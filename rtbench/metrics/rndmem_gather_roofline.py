"""rndmem_gather_roofline (%): a chained gather block's least time on the
card (``cost/rndmem_gather.py`` against ``peaks.json``: its bytes over
the HBM peak) over the device time per block of the gather kernel, by
its name in the profiler. Read in stream cells whose kernel is the
gather; nothing elsewhere."""


def read(view):
    if view.kind != "stream" or view.config.get("kernel") != "rndmem_gather":
        return None
    spent = view.kernel_us("rndmem_gather")
    least = view.least_us("rndmem_gather")
    if spent <= 0 or least is None:
        return None
    return 100.0 * least * view.blocks / spent
