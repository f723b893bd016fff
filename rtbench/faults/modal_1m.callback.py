"""Faults planted in the program's path of a modal_1m callback, where
each produces its output: the bank of ``models/modal.py``. A callback
leaves the states as it found them, so it has no state to leave
unchanged. Each ``FAULTS`` entry takes ``patch(owner, name, value)`` and
plants the fault with it."""


def _bank(kind):
    from gpuaudiobench_tpu_torch.ops.modal import modal_bank

    def bank(amp, cos_w, sin_w, re, im, s, t):
        if kind == "half":  # half the modes left out, the rest doubled
            h = amp.shape[0] // 2
            out, _, _ = modal_bank(amp[:h], cos_w[:h], sin_w[:h], re[:h],
                                   im[:h], s, t)
            return out * 2, re, im
        out, _, _ = modal_bank(amp, cos_w, sin_w, re, im, s, t)
        out = out.clone()
        out[0, 0] += 0.05 * out.abs().max()  # one sample altered
        return out, re, im

    return bank


def _plant(kind):
    def plant(patch):
        from gpuaudiobench_tpu_torch.models import modal

        patch(modal, "modal_bank", _bank(kind))

    return plant


FAULTS = {k: _plant(k) for k in ("half", "altered")}
