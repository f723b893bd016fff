"""Run the struck bell through a convolution reverb, block-streamed
through the PartConv engine, and prove the stream equals the offline
convolution.

The port's copy of the repo-level ``examples/reverb.py``: the
user-facing shape of the PartConv extension benchmark. A long
decaying-noise room IR is split into bufferSize partitions and streamed
through the frequency-domain delay line one 512-sample block at a time
-- exactly the per-block step the benchmark times, in any of the three
FDL forms (``--form ring | shift | nupols``; nupols is the two-level
Gardner long-IR scheme), cuFFT through ``torch.fft`` on the card. The
bell itself comes from the modal kernel (``examples/streaming_synth.py``).
At the end, the streamed wet signal is checked against one offline
float64 FFT convolution of the whole dry take: the block-by-block engine
and the one-shot convolution must agree to float32 rounding
(peak-relative), which makes the benchmark's latency a real reverb's
latency.

Run:  python -m gpuaudiobench_tpu_torch.examples.reverb [--seconds 3]
          [--rt60 1.2] [--form ring] [--out <temp dir>/bell_hall.wav]
          [--device cuda|cpu]
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
    bell_modes,
    make_stream,
    write_wav,
)


def render_dry(seconds: float, modes: int, f0: float,
               dev: torch.device) -> np.ndarray:
    stream, carry = make_stream(*bell_modes(modes, f0), dev)
    return stream.run(carry, max(1, int(seconds * FS / BLOCK)))[1]


def stream_reverb(dry: np.ndarray, ir: np.ndarray, dev: torch.device,
                  form: str = "ring", tail_chunk: int = 8) -> np.ndarray:
    """Stream dry (1-D) through the partitioned FDL, block by block, the
    benchmark's exact step, in any of the three forms."""
    from gpuaudiobench_tpu_torch.ops import partconv as pc

    n_blocks = len(dry) // BLOCK
    p = pc.num_partitions(ir.shape[1], BLOCK)
    xs = torch.from_numpy(
        np.ascontiguousarray(dry[: n_blocks * BLOCK])).to(dev).view(
            n_blocks, 1, BLOCK)
    ir_d = torch.from_numpy(ir).to(dev)
    zeros = torch.zeros((1, p, BLOCK + 1), dtype=torch.float32, device=dev)

    if form == "nupols":
        m = pc.nupols_tail_partitions(ir.shape[1], BLOCK, tail_chunk)
        if m == 0:
            raise SystemExit("--form nupols needs irLength > "
                             f"{tail_chunk * BLOCK} taps (the K-block "
                             "head); use --rt60 >= "
                             f"{tail_chunk * BLOCK / FS + 0.1:.2f}")
        (hh_re, hh_im), (ht_re, ht_im) = pc.nupols_spectra(ir_d, BLOCK,
                                                           tail_chunk)
        nblock = pc.make_partconv_block_nupols(BLOCK, tail_chunk, m)
        state = pc.state_to_device(
            pc.nupols_init_state(1, BLOCK, tail_chunk, m), dev)

        def step(x):
            nonlocal state
            y, state = nblock(x, state, hh_re, hh_im, ht_re, ht_im)
            return y
    elif form == "ring":
        h_re, h_im = pc.ring_aligned_spectra(
            *pc.partition_spectra(ir_d, BLOCK))
        ring = [torch.zeros((1, BLOCK), device=dev), p - 1, zeros,
                zeros.clone()]

        def step(x):
            y, *ring[1:] = pc.partconv_block_ring(x, *ring, h_re, h_im)
            ring[0] = x
            return y
    else:  # shift
        h_re, h_im = pc.partition_spectra(ir_d, BLOCK)
        shift = [torch.zeros((1, BLOCK), device=dev), zeros, zeros]

        def step(x):
            y, *shift[1:] = pc.partconv_block(x, *shift, h_re, h_im)
            shift[0] = x
            return y

    wet = torch.cat([step(xs[k]) for k in range(n_blocks)], dim=1)
    return wet.cpu().numpy().ravel()


def offline(dry: np.ndarray, ir: np.ndarray) -> np.ndarray:
    """One float64 FFT convolution of the whole take, cut to its length."""
    n = len(dry)
    size = 1
    while size < n + ir.shape[1]:
        size <<= 1
    return np.fft.irfft(
        np.fft.rfft(dry.astype(np.float64), size)
        * np.fft.rfft(ir[0].astype(np.float64), size), size)[:n]


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--rt60", type=float, default=1.2,
                    help="reverb time (s); IR length = rt60 * 48000")
    ap.add_argument("--modes", type=int, default=2048)
    ap.add_argument("--f0", type=float, default=220.0)
    ap.add_argument("--mix", type=float, default=0.35,
                    help="wet/dry mix (0 = dry, 1 = wet)")
    ap.add_argument("--form", default="ring",
                    choices=("ring", "shift", "nupols"),
                    help="FDL form; nupols = the two-level Gardner "
                         "long-IR scheme (--tail-chunk blocks/partition)")
    ap.add_argument("--tail-chunk", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "bell_hall.wav"))
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from gpuaudiobench_tpu_torch.utils import device as dv
    from gpuaudiobench_tpu_torch.utils.data import reverb_impulse_responses

    dev = dv.device(args.device)
    dry = render_dry(args.seconds, args.modes, args.f0, dev)
    ir = reverb_impulse_responses(1, max(BLOCK, int(args.rt60 * FS)))
    wet = stream_reverb(dry, ir, dev, args.form, args.tail_chunk)
    n = len(wet)
    ref = offline(dry[:n], ir)
    err = float(np.abs(wet - ref).max())
    peak = float(np.abs(ref).max()) or 1.0
    stream_ok = err <= 1e-4 * peak

    write_wav(args.out, (1.0 - args.mix) * dry[:n] + args.mix * wet)

    print(f"wrote {args.out}: {n / FS:.2f} s, rt60 {args.rt60:.2f} s "
          f"({ir.shape[1]} taps = "
          f"{-(-ir.shape[1] // BLOCK)} partitions, {args.form} FDL), "
          f"mix {args.mix}")
    print(f"streamed convolution matches offline: {stream_ok} "
          f"(max err {err:.2e} vs peak {peak:.3f})")
    return 0 if stream_ok else 1


if __name__ == "__main__":
    sys.exit(main())
