"""Judge of the rndmem_65536 configuration's stream: the playheads the
window ends in and the probes of its checked blocks, against the closed
form and the plain gather of ``rndmem_65536.py``.

``playhead_mismatch`` counts the voices whose playhead after the window
is not the reference's; ``probe_err`` is the largest relative gap of a
checked block's probe (each checked block is an item), 0 where every
checked block was gathered bit for bit. Both limits are 0: the gather
is exact.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from rtbench.spec import load_module

base = load_module("reference", "rndmem_65536")

LIMITS = {"playhead_mismatch": 0, "probe_err": 0.0}
ITEM = "probe_err"


def program_state(carry) -> Dict[str, np.ndarray]:
    """The playheads in the program's carry, on the host."""
    return {"playheads": carry.cpu().numpy().astype(np.int64)}


def judge(inputs, conf, got: Dict, device) -> Dict:
    want = base.stream_outputs(inputs, conf, got["blocks"], got["checked"],
                               device)
    mismatch = int(np.count_nonzero(got["state"]["playheads"]
                                    != want["state"]["playheads"]))
    errs = [abs(got["probes"][b] - p) / abs(p)
            for b, p in want["probes"].items()]
    return {"numbers": {"playhead_mismatch": mismatch,
                        "probe_err": max(errs)},
            "items": errs}


def control(inputs, conf, got: Dict, device) -> Dict:
    """The probes of the checked blocks gathered from the pool rounded to
    bfloat16; the playheads as the reference has them."""
    low = base.stream_outputs(inputs, conf, got["blocks"], got["checked"],
                              device, precision="bf16")
    return dict(got, state=low["state"], probes=low["probes"])
