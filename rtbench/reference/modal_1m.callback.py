"""Judge of the modal_1m configuration's callbacks: every kept callback's
(T_out, S) output against the float64 bank of ``modal_1m.py`` rendered
from its entry state, which a callback leaves as it found it.

``out_err`` is the largest gap of a kept callback's output from the
reference, over the reference's peak (the program's own validation
measures so: summing thousands of float32 contributions rounds by a
share of the peak, and a sample's own value can be near 0); each kept
callback is an item. The limit was set from the chip readings in
PERF.md: sound runs of the program below, the bfloat16 control above.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from rtbench.spec import load_module

base = load_module("reference", "modal_1m")

LIMITS = {"out_err": 1e-3}
ITEM = "out_err"


def output(inputs, conf, device, precision: str = "f64") -> np.ndarray:
    """One callback's (T_out, S) output."""
    return base.block_output(inputs, conf, 0, device, precision).T.copy()


def judge(inputs, conf, got: Dict, device) -> Dict:
    want = output(inputs, conf, device)
    peak = float(np.abs(want).max())
    errs = [float(np.abs(o.reshape(want.shape) - want).max()) / peak
            for o in got["outputs"]]
    return {"numbers": {"out_err": max(errs)}, "items": errs}


def control(inputs, conf, got: Dict, device) -> Dict:
    """Every kept output replaced by the reference's on bfloat16 tables."""
    low = output(inputs, conf, device, precision="bf16")
    return {"outputs": [low] * len(got["outputs"])}
