"""Judge of the modal_1m configuration's stream: the states the window
ends in and the probes of its checked blocks, against the float64
rotation of ``modal_1m.py``.

``state_rms`` is the root mean square of the gap between the program's
and the reference's states over all modes, over the reference's;
``probe_err`` the largest relative gap of a checked block's probe (each
checked block is an item). The limits were set from the chip readings in
PERF.md: sound runs of the program below, the bfloat16 control above.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from rtbench.spec import load_module

base = load_module("reference", "modal_1m")

LIMITS = {"state_rms": 0.1, "probe_err": 3e-3}
ITEM = "probe_err"


def program_state(carry) -> Dict[str, np.ndarray]:
    """The states in the program's carry (cos, sin, re, im), on the host."""
    return {"re": carry[2].cpu().numpy().astype(np.float64),
            "im": carry[3].cpu().numpy().astype(np.float64)}


def judge(inputs, conf, got: Dict, device) -> Dict:
    want = base.stream_outputs(inputs, conf, got["blocks"], got["checked"],
                               device)
    w_re, w_im = want["state"]["re"], want["state"]["im"]
    m = len(w_re)
    g_re, g_im = got["state"]["re"][:m], got["state"]["im"][:m]
    dre, dim = g_re - w_re, g_im - w_im
    norm = np.sqrt(np.sum(w_re ** 2 + w_im ** 2))
    errs = [abs(got["probes"][b] - p) / abs(p)
            for b, p in want["probes"].items()]
    mag_w, mag_g = np.hypot(w_re, w_im), np.hypot(g_re, g_im)
    each = np.hypot(dre, dim) / np.maximum(mag_w, np.median(mag_w))
    turn = np.angle((g_re + 1j * g_im) * (w_re - 1j * w_im))
    return {
        "numbers": {"state_rms": float(np.sqrt(np.sum(dre ** 2 + dim ** 2)) / norm),
                    "probe_err": max(errs)},
        "items": errs,
        # Not compared: how the states part, for the record.
        "info": {"mag_bias": float(np.mean(mag_g / np.maximum(mag_w, 1e-30) - 1.0)),
                 "phase_rms": float(np.sqrt(np.mean(turn ** 2))),
                 "phase_mean": float(np.mean(turn)),
                 "state_max": float(each.max()),
                 "state_p99": float(np.quantile(each, 0.99))},
    }


def control(inputs, conf, got: Dict, device) -> Dict:
    """What the window would have produced from the reference computed on
    bfloat16 tables (``modal_1m.py``), at the same blocks."""
    low = base.stream_outputs(inputs, conf, got["blocks"], got["checked"],
                              device, precision="bf16")
    return dict(got, state=low["state"], probes=low["probes"])
