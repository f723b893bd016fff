"""step_mfu.stream (%): the whole chained step's share of the card's
peak: a block's least time on the card (the configuration's kernel cost
against ``peaks.json``; the FP32 peak for the modal bank, the HBM peak
for the gather) over the traced window's length per block, idle time,
the probe, the carry update and the read-outs included. It bounds the
kernel's own roofline share from below, so it still speaks when a change
takes that kernel off the path."""


def read(view):
    if view.kind != "stream" or not view.events:
        return None
    least = view.least_us(view.config["kernel"])
    if least is None:
        return None
    return 100.0 * least * view.blocks / view.window_us
