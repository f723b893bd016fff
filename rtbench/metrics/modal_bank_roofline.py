"""modal_bank_roofline (%): a chained modal block's least time on the card
(``cost/modal_bank.py`` against ``peaks.json``) over the device time per
block of the kernels ``gpuab::modal_bank_launch`` launches, by their
names in the profiler. Read in stream cells whose kernel is the modal
bank; nothing elsewhere."""


def read(view):
    if view.kind != "stream" or view.config.get("kernel") != "modal_bank":
        return None
    spent = view.kernel_us("modal_bank")
    least = view.least_us("modal_bank")
    if spent <= 0 or least is None:
        return None
    return 100.0 * least * view.blocks / spent
