"""Run a plucked-string DI riff through the NeuralAmp TCN, block by
block, and prove the stream equals one-shot offline inference.

The port's copy of the repo-level ``examples/ampsim.py``: the
user-facing shape of the NeuralAmp extension benchmark. A Karplus-Strong
guitar line is streamed through the dilated-TCN amp model one
512-sample block at a time -- exactly the per-block step the benchmark
times -- with the per-layer receptive-field tails carried across blocks
(``ops.neuralamp.tcn_block``; its taps are full-FP32 GEMMs on the
card). At the end, the streamed output is checked against running the
ENTIRE take through the same network as one giant block from zero
state: block-streaming with carried context must reproduce offline
inference to float32 rounding, which makes the benchmark's ms/block a
real amp plugin's latency.

The network weights are the benchmark's seeded random initialization,
so the "amp" is an arbitrary (but fixed) nonlinear residual stack -- the
tanh layers add drive-like waveshaping; the point is the engine, not a
trained tone.

Run:  python -m gpuaudiobench_tpu_torch.examples.ampsim [--seconds 4]
          [--layers 8] [--out <temp dir>/riff_amp.wav] [--device cuda|cpu]
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


def pluck(n: int, f0: float, fs: int = FS, seed: int = 42) -> np.ndarray:
    """Karplus-Strong pluck: noise burst in a lowpass-damped delay
    line (the classic plucked-string physical model)."""
    period = max(2, int(round(fs / f0)))
    rng = np.random.default_rng(seed)
    buf = rng.uniform(-1.0, 1.0, period)
    out = np.empty(n)
    idx = 0
    for i in range(n):
        cur = buf[idx]
        nxt = buf[(idx + 1) % period]
        out[i] = cur
        buf[idx] = 0.996 * 0.5 * (cur + nxt)
        idx = (idx + 1) % period
    return out


def render_riff(seconds: float) -> np.ndarray:
    """A four-note DI line (A2 D3 E3 A3), one pluck per half second."""
    n = max(BLOCK, int(seconds * FS))
    riff = np.zeros(n)
    notes = [110.0, 146.83, 164.81, 220.0]
    step = FS // 2
    for k, f0 in enumerate(notes):
        start = k * step
        if start >= n:
            break
        riff[start:] += pluck(n - start, f0, seed=42 + k)
    peak = float(np.abs(riff).max()) or 1.0
    return (0.7 * riff / peak).astype(np.float32)


def _tcn(params, layers: int, dev: torch.device):
    from gpuaudiobench_tpu_torch.ops import neuralamp as na

    cp = na.cast_params(params, "f32", dev)
    tails = na.init_tails(1, params["w_in"].shape[0], layers, "f32", dev)
    return cp, tails


def stream_amp(dry: np.ndarray, params, layers: int,
               dev: torch.device) -> np.ndarray:
    """Stream dry (1-D) through the TCN block by block, carrying the
    receptive-field tails -- the benchmark's exact step."""
    from gpuaudiobench_tpu_torch.ops import neuralamp as na

    cp, tails = _tcn(params, layers, dev)
    n_blocks = len(dry) // BLOCK
    xs = torch.from_numpy(
        np.ascontiguousarray(dry[: n_blocks * BLOCK])).to(dev).view(
            n_blocks, 1, BLOCK)
    wet = []
    for k in range(n_blocks):
        y, tails = na.tcn_block(xs[k], tails, cp, layers=layers, dtype="f32")
        wet.append(y)
    return torch.cat(wet, dim=1).cpu().numpy().ravel()


def offline_amp(dry: np.ndarray, params, layers: int,
                dev: torch.device) -> np.ndarray:
    """The same network applied to the whole take as ONE block from zero
    state (offline inference, no streaming)."""
    from gpuaudiobench_tpu_torch.ops import neuralamp as na

    cp, tails = _tcn(params, layers, dev)
    x = torch.from_numpy(np.ascontiguousarray(dry[None, :])).to(dev)
    y, _ = na.tcn_block(x, tails, cp, layers=layers, dtype="f32")
    return y.cpu().numpy().ravel()


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "riff_amp.wav"))
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from gpuaudiobench_tpu_torch.ops import neuralamp as na
    from gpuaudiobench_tpu_torch.utils import device as dv

    dev = dv.device(args.device)
    dry = render_riff(args.seconds)
    params = na.init_params(args.seed, args.channels, args.layers)
    wet = stream_amp(dry, params, args.layers, dev)
    n = len(wet)
    ref = offline_amp(dry[:n], params, args.layers, dev)
    err = float(np.abs(wet - ref).max())
    peak = float(np.abs(ref).max()) or 1.0
    stream_ok = err <= 1e-4 * peak

    write_wav(args.out, wet)
    rf = na.receptive_field(args.layers)
    print(f"wrote {args.out}: {n / FS:.2f} s through a depth-"
          f"{args.layers} TCN ({args.channels} ch, receptive field "
          f"{rf} samples = {1000.0 * rf / FS:.1f} ms)")
    print(f"streamed inference matches offline: {stream_ok} "
          f"(max err {err:.2e} vs peak {peak:.3f})")
    return 0 if stream_ok else 1


if __name__ == "__main__":
    sys.exit(main())
