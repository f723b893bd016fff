"""Mix a multi-track bell chord through the full DAWSessionMix graph,
block-streamed, and prove the stream equals the offline render.

The port's copy of the repo-level ``examples/session.py``: the
user-facing shape of the DAWSessionMix extension benchmark. Every
512-sample block runs the whole session's core
(``models.session.session_block``): per-track biquad EQ cascades (the
systolic cascade kernel of ``csrc/iir.cu`` on the card), post-fader
sends summed into a stereo partitioned-convolution reverb bus (cuFFT
through ``torch.fft``), constant-power pan mixdown -- with all state (EQ
z's, previous bus block, the reverb's frequency-domain delay line)
carried across blocks. Unlike the benchmark (which repeats one block to
keep its golden closed-form), this streams REAL varying program
material: a chord of decaying bell notes from the modal kernel, one note
per track.

At the end the streamed stereo mix is checked against an offline render
of the identical console: float32 sample-loop EQ over the whole take
(``models.iir.iir_reference``, the op-order-exact recurrence), one
float64 FFT convolution of the whole bus signal, the same pan/wet
algebra. Block-by-block engine and one-shot render must agree to
float32 rounding (peak-relative).

Run:  python -m gpuaudiobench_tpu_torch.examples.session [--seconds 3]
          [--tracks 6] [--rt60 1.0] [--eq-stages 4]
          [--out <temp dir>/chord_mix.wav] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import wave
from typing import List, Optional

import numpy as np
import torch

from gpuaudiobench_tpu_torch.examples.streaming_synth import (
    BLOCK,
    FS,
    bell_modes,
    make_stream,
)


def render_tracks(seconds: float, n_tracks: int, modes: int, f0: float,
                  dev: torch.device) -> np.ndarray:
    """(T, N) dry take: one bell note per track, a stacked-fourths
    chord (f0 * 4/3 per step) so the tracks are genuinely distinct."""
    n_blocks = max(1, int(seconds * FS / BLOCK))
    takes = []
    for t in range(n_tracks):
        stream, carry = make_stream(
            *bell_modes(modes, f0 * (4.0 / 3.0) ** t, seed=7 + t), dev)
        takes.append(stream.run(carry, n_blocks)[1])
    return np.stack(takes)


def stream_session(tracks: np.ndarray, stage_coeffs, send, pan2,
                   ir: np.ndarray, dev: torch.device) -> np.ndarray:
    """(2, N) streamed mix: the benchmark's exact per-block core over the
    take's blocks, state carried."""
    from gpuaudiobench_tpu_torch.models.session import session_block
    from gpuaudiobench_tpu_torch.ops.partconv import (
        num_partitions,
        partition_spectra,
    )

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    t, n = tracks.shape
    n_blocks = n // BLOCK
    p = num_partitions(ir.shape[1], BLOCK)
    xs = put(tracks[:, : n_blocks * BLOCK].reshape(t, n_blocks, BLOCK))
    h_re, h_im = partition_spectra(put(ir), BLOCK)
    coeffs = put(np.array(stage_coeffs, np.float32))
    send_d, pan2_d = put(send), put(pan2)
    eq = torch.zeros((len(stage_coeffs), t, 2), dtype=torch.float32,
                     device=dev)
    prev = torch.zeros((2, BLOCK), dtype=torch.float32, device=dev)
    fre = torch.zeros((2, p, BLOCK + 1), dtype=torch.float32, device=dev)
    fim = torch.zeros_like(fre)
    mixes = []
    for k in range(n_blocks):
        mix, eq, prev, fre, fim = session_block(
            xs[:, k].contiguous(), coeffs, eq, send_d, pan2_d, prev, fre,
            fim, h_re, h_im)
        mixes.append(mix)
    return torch.cat(mixes, dim=1).cpu().numpy()


def offline_session(tracks: np.ndarray, stage_coeffs, send, pan2,
                    ir: np.ndarray, wet: float) -> np.ndarray:
    """(2, N) one-shot render of the identical console: f32 sample-loop
    EQ, one f64 FFT convolution of the whole bus, same mix algebra."""
    from gpuaudiobench_tpu_torch.models.iir import iir_reference

    t, n = tracks.shape
    y = tracks
    for c in stage_coeffs:
        y, _ = iir_reference(y, c, np.zeros((t, 2), np.float32))
    bus = send.astype(np.float64) @ y.astype(np.float64)  # (N,)
    nfft = n + ir.shape[1]
    rev = np.fft.irfft(
        np.fft.rfft(bus, nfft)[None]
        * np.fft.rfft(ir.astype(np.float64), nfft, axis=1),
        nfft, axis=1)[:, :n]
    dry = pan2.astype(np.float64) @ y.astype(np.float64)
    return (dry + wet * rev).astype(np.float32)


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--tracks", type=int, default=6)
    ap.add_argument("--modes", type=int, default=1024)
    ap.add_argument("--f0", type=float, default=165.0)
    ap.add_argument("--rt60", type=float, default=1.0,
                    help="reverb time (s); IR length = rt60 * 48000")
    ap.add_argument("--eq-stages", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "chord_mix.wav"))
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from gpuaudiobench_tpu_torch.models.session import (
        WET_GAIN,
        session_mix_params,
    )
    from gpuaudiobench_tpu_torch.utils import device as dv
    from gpuaudiobench_tpu_torch.utils.data import (
        biquad_lowpass_coefficients,
        reverb_impulse_responses,
    )

    dev = dv.device(args.device)
    tracks = render_tracks(args.seconds, args.tracks, args.modes, args.f0,
                           dev)
    n = (tracks.shape[1] // BLOCK) * BLOCK
    tracks = tracks[:, :n]
    stage_coeffs = [biquad_lowpass_coefficients(0.25 - 0.0125 * k)
                    for k in range(args.eq_stages)]
    send, pan2 = session_mix_params(args.tracks, seed=42)
    ir = reverb_impulse_responses(2, max(BLOCK, int(args.rt60 * FS)))

    mix = stream_session(tracks, stage_coeffs, send, pan2, ir, dev)
    ref = offline_session(tracks, stage_coeffs, send, pan2, ir, WET_GAIN)
    peak = float(np.abs(ref).max())
    err = float(np.abs(mix - ref).max())
    stream_ok = err <= 1e-4 * max(peak, 1e-12)

    scale = max(1e-9, float(np.abs(mix).max())) / 0.9
    pcm = (np.clip(mix / scale, -1, 1) * 32767.0).astype("<i2")
    with wave.open(args.out, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(FS)
        w.writeframes(pcm.T.reshape(-1).tobytes())  # interleave L/R

    print(f"wrote {args.out}: {n / FS:.2f} s stereo, {args.tracks} strips "
          f"x {args.eq_stages}-stage EQ, rt60 {args.rt60:.2f} s "
          f"({ir.shape[1]} taps = {-(-ir.shape[1] // BLOCK)} partitions)")
    print(f"streamed session matches offline: {stream_ok} "
          f"(max err {err:.2e} vs peak {peak:.3f})")
    return 0 if stream_ok else 1


if __name__ == "__main__":
    sys.exit(main())
