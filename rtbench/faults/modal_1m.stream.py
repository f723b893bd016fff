"""Faults planted in the program's path of a modal_1m stream, where each
produces its output: the folded step of ``models/modal.py``. Each
``FAULTS`` entry takes ``patch(owner, name, value)`` (pytest's
``monkeypatch.setattr``, or ``rtbench.control``'s own) and plants the
fault with it; a sound judge finds every one."""

import torch


def _step(kind):
    from gpuaudiobench_tpu_torch.ops.modal import modal_folded_step

    def step(cos_w, sin_w, re, im, s, t):
        if kind == "unchanged":  # the state returned as it came
            out, _, _ = modal_folded_step(cos_w, sin_w, re, im, s, t)
            return out, re, im
        if kind == "half":  # half the modes left out, the rest doubled
            h = cos_w.shape[0] // 2
            out, re2, im2 = modal_folded_step(cos_w[:h], sin_w[:h], re[:h],
                                              im[:h], s, t)
            return (out * 2, torch.cat([re2, re[h:]]),
                    torch.cat([im2, im[h:]]))
        out, re2, im2 = modal_folded_step(cos_w, sin_w, re, im, s, t)
        out = out.clone()
        out[:, 0] *= 2  # one track's samples altered
        return out, re2, im2

    return step


def _plant(kind):
    def plant(patch):
        from gpuaudiobench_tpu_torch.models import modal

        patch(modal, "modal_folded_step", _step(kind))

    return plant


FAULTS = {k: _plant(k) for k in ("unchanged", "half", "altered")}
