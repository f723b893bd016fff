"""Auralize the FDTD room: render its impulse response to a WAV file.

The port's copy of the repo-level ``examples/room_impulse.py``. The
FDTD3D benchmark times a 52-cell-cubed wave-equation room (3 leapfrog
substeps per audio sample, reflective walls with a lossy boundary ring;
``ops/fdtd3d.py``). This example uses the same block step as a ROOM
SIMULATOR: inject one impulse at the source cell, keep stepping with
silent input, and record the receiver cell -- the room impulse response
(RIR) that a convolution reverb would apply. Echo density and ring-down
come out of the physics; nothing here is a designed filter.

Each block is ``ops.fdtd3d.fdtd3d_block_div``, the divergence form that
carries (pressure, velocity divergence) across blocks as the benchmark's
streaming mode does: at room 50 the cluster kernel (``csrc/fdtd3d.cu``)
on a CUDA tensor, its plain twin only on a CPU tensor.

Run:  python -m gpuaudiobench_tpu_torch.examples.room_impulse
          [--seconds 1.0] [--out <temp dir>/rir.wav] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch

from gpuaudiobench_tpu_torch.examples.streaming_synth import (
    BLOCK,
    FS,
    write_wav,
)


def render(n_blocks: int, dev: torch.device,
           room: int = 50) -> np.ndarray:
    """The receiver's (n_blocks * BLOCK,) response to a unit impulse in
    the first sample of block 0, the room at rest before it; ``room``
    places the source and receiver at the benchmark's room fractions
    (the example renders the benchmark's room 50)."""
    from gpuaudiobench_tpu_torch.ops import fdtd3d

    cells = fdtd3d.source_pos(room), fdtd3d.receiver_pos(room)
    p, div = fdtd3d.zero_fields_div(fdtd3d.grid_n(room), dev)
    impulse = torch.zeros((1, BLOCK), dtype=torch.float32, device=dev)
    impulse[0, 0] = 1.0
    silence = torch.zeros_like(impulse)
    blocks = []
    for k in range(n_blocks):
        out, p, div = fdtd3d.fdtd3d_block_div(impulse if k == 0 else silence,
                                              p, div, *cells)
        blocks.append(out[0])
    return torch.cat(blocks).cpu().numpy()


def physics(rir: np.ndarray):
    """(first sample the direct path reaches, early RMS, late RMS,
    stable). The gate is STABILITY, not monotone decay: over short
    renders the reflective room is still building echo density, so late
    RMS may sit slightly above early RMS; a broken stencil blows up
    exponentially instead (orders of magnitude, and non-finite fast)."""
    nz = np.nonzero(np.abs(rir) > 1e-9 * np.abs(rir).max())[0]
    first = int(nz[0]) if len(nz) else -1
    half = len(rir) // 2
    e_early = float(np.sqrt(np.mean(rir[:half] ** 2)))
    e_late = float(np.sqrt(np.mean(rir[half:] ** 2)))
    stable = bool(np.isfinite(rir).all()) and e_late < 5.0 * e_early
    return first, e_early, e_late, stable


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(), "rir.wav"))
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from gpuaudiobench_tpu_torch.utils import device as dv

    n_blocks = max(1, int(args.seconds * FS / BLOCK))
    rir = render(n_blocks, dv.device(args.device))
    write_wav(args.out, rir)
    # The receiver sits |SOURCE-RECEIVER| cells away; sound in this
    # discretization travels at most 1 cell per substep.
    first, e_early, e_late, stable = physics(rir)
    print(f"wrote {args.out}: {len(rir) / FS:.2f} s room impulse response "
          f"(52^3 cells, 3 substeps/sample)")
    print(f"direct path arrives at sample {first}; "
          f"early/late RMS = {e_early:.3e}/{e_late:.3e} "
          f"({'stable' if stable else 'UNSTABLE'})")
    return 0 if (first >= 0 and stable) else 1


if __name__ == "__main__":
    sys.exit(main())
