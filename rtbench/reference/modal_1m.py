"""Plain reference of the modal_1m configuration, in float64.

Each mode m is a phasor z0 = amp (re + i im) rotated once a sample by
w = cos_w + i sin_w, rotating first: sample n of the stream (n = 1, 2,
...) adds Re(z0 w^n) onto output track m mod T_out. The reference takes
the float32 tables that the benchmark made and works in float64 on
them: the rotation of those exact float32 numbers, |w| included, which
is not exactly 1, so the program's state may grow or decay with it. A
block's entry state is the closed-form power z0 w^(b S), never a
repeated product, and the block's S samples are then stepped in float64.
It runs in blocks of modes on whichever device it is given and imports
nothing of the program. How a cell's outputs are judged against it is
``modal_1m.<kind>.py``.

``precision="bf16"`` is the control: the same arithmetic on tables
rounded to bfloat16 first, with the rotation's modulus kept as the
float32 tables give it, so that only the angle, the amplitude and the
state lose precision. That is the least a bfloat16 path would change: a
rotation with the rounded modulus itself grows or decays by about
10^-3 a sample and overflows float64 within a stream's window.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

TABLES = ("amp", "cos_w", "sin_w", "state_re", "state_im")
CHUNK = 1 << 18  # modes a pass; a multiple of every T_out dividing 32

def make_inputs(conf, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The mode tables from ``seed``, drawn on ``device`` in one call as the
    upstream draws them: amp in [0, 1), frequency in [0, 0.45) cycles a
    sample, the state's parts in [-1, 1); cos and sin of 2 pi f in
    float32."""
    m = conf["modes"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    r = torch.rand((4, m), generator=g, device=device, dtype=torch.float32)
    w = (2.0 * math.pi) * (r[1] * 0.45)
    return {
        "amp": r[0].contiguous(),
        "cos_w": torch.cos(w),
        "sin_w": torch.sin(w),
        "state_re": (r[2] * 2.0 - 1.0).contiguous(),
        "state_im": (r[3] * 2.0 - 1.0).contiguous(),
    }


def _tables(inputs, precision: str, lo: int, hi: int, device):
    out = {k: torch.as_tensor(inputs[k][lo:hi]).to(device).to(torch.float64)
           for k in TABLES}
    if precision == "bf16":
        mod = torch.hypot(out["cos_w"], out["sin_w"])
        out = {k: v.to(torch.bfloat16).to(torch.float64) for k, v in out.items()}
        scale = mod / torch.hypot(out["cos_w"], out["sin_w"])
        out["cos_w"], out["sin_w"] = out["cos_w"] * scale, out["sin_w"] * scale
    return out


def _power(c: torch.Tensor, s: torch.Tensor, n: int):
    """(c + i s)^n in float64 by its modulus and angle."""
    log_mod = 0.5 * torch.log1p(c * c + s * s - 1.0)
    ang = torch.atan2(s, c) * float(n)
    mod = torch.exp(log_mod * float(n))
    return mod * torch.cos(ang), mod * torch.sin(ang)


def _entry(t, n: int):
    """amp (re + i im) w^n of a pass's modes."""
    pr, pi = _power(t["cos_w"], t["sin_w"], n)
    zr, zi = t["amp"] * t["state_re"], t["amp"] * t["state_im"]
    return zr * pr - zi * pi, zr * pi + zi * pr


def block_output(inputs, conf, block: int, device, precision: str = "f64") -> np.ndarray:
    """The (S, T_out) output of stream block ``block`` (0 = the first)."""
    m, s, t_out = conf["modes"], conf["buffer_size"], conf["output_tracks"]
    out = torch.zeros((s, t_out), dtype=torch.float64, device=device)
    for lo in range(0, m, CHUNK):
        t = _tables(inputs, precision, lo, min(m, lo + CHUNK), device)
        c, sn = t["cos_w"], t["sin_w"]
        re, im = _entry(t, block * s)
        pad = -re.shape[0] % t_out  # zero modes to whole tracks
        for j in range(s):
            re, im = re * c - im * sn, re * sn + im * c
            row = torch.nn.functional.pad(re, (0, pad)) if pad else re
            out[j] += row.view(-1, t_out).sum(dim=0)
    return out.cpu().numpy()


def probe(out: np.ndarray) -> float:
    """The stream's probe of a block, mean |value|."""
    return float(np.abs(out).mean())


def stream_outputs(inputs, conf, blocks: int, checked: Sequence[int], device,
                   precision: str = "f64") -> Dict:
    """What the stream should hold after ``blocks`` blocks (the states
    re, im of every mode) and the probes of the ``checked`` blocks."""
    m, s = conf["modes"], conf["buffer_size"]
    re = np.empty(m, np.float64)
    im = np.empty(m, np.float64)
    for lo in range(0, m, CHUNK):
        hi = min(m, lo + CHUNK)
        t = _tables(inputs, precision, lo, hi, device)
        r, i = _entry(t, blocks * s)
        re[lo:hi], im[lo:hi] = r.cpu().numpy(), i.cpu().numpy()
    probes = {b: probe(block_output(inputs, conf, b, device, precision))
              for b in checked}
    return {"state": {"re": re, "im": im}, "probes": probes}
