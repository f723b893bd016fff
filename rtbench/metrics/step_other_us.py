"""step_other_us (us): device time per chained block outside the
configuration's main kernel (``cost/<kernel>.py``'s names): the probe,
the carry update (the playheads' advance and wrap), the graph's carry
copies and the stacking of the probes. The harness's read-outs of the
probes to the host lie between replays and are not counted."""

from rtbench.trace import is_d2h


def read(view):
    if view.kind != "stream":
        return None
    names = view.cost(view.config["kernel"]).NAMES
    other = view.time_us(lambda n: not is_d2h(n)
                         and not any(k in n for k in names))
    if not view.events:
        return None
    return other / view.blocks
