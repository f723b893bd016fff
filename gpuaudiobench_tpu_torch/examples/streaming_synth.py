"""Render a struck bell to a WAV file with the modal synthesis engine,
streaming block by block with carried phasor state, a second strike
injected mid-stream, and a checkpoint/resume bit-equality proof.

The port's copy of the repo-level ``examples/streaming_synth.py``: the
user-facing shape of the suite's flagship workload (ModalFilterBank,
the DAFx-24 poster's tab4 headline). The benchmark measures this exact
per-block step; here it makes sound:

  * ``ops.modal.modal_folded_step`` -- the chainable one-block step on
    amp-prefolded phasors (re, im), folded onto one output track: the
    rotation kernel (``csrc/modal_bank.cu``) on a CUDA tensor, its plain
    twin only on a CPU tensor.
  * ``harness.checkpoint.save_stream_state`` / ``load_stream_state`` --
    the structure-validated .npz persistence the soak uses. The carry is
    the same two float32 leaves the JAX example writes, so a checkpoint
    written by either example resumes in the other.

Each block is one kernel launch from Python; the strike edits the carry
between two launches.

Run:  python -m gpuaudiobench_tpu_torch.examples.streaming_synth
          [--seconds 4] [--modes 2048] [--out <temp dir>/bell.wav]
          [--device cuda|cpu]
The render finishes, then the second half is re-rendered from the
mid-stream checkpoint and compared bit for bit -- the guarantee
``tools/soak.py --resume`` relies on.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import wave
from typing import List, Optional, Tuple

import numpy as np
import torch

FS = 48_000
BLOCK = 512  # samples per streamed block (the benchmark's default)
CHECKPOINT_NAME = "streaming_synth_example"


def bell_modes(n_modes: int, f0: float = 220.0, seed: int = 7):
    """Inharmonic struck-bell bank: partials at f0*k*sqrt(1+B*k^2)
    (stiff-string/bell stretching), 1/f amplitude rolloff, faster decay
    for higher partials, and a cluster of micro-detuned modes per
    partial for shimmer. Returns (amp, cos_w, sin_w, re0, im0) float32.

    Decay is encoded in the ROTATION MAGNITUDE: the benchmark's bank
    rotates by a unit phasor (sustained sinusoids, Metal parity); a
    musical voice uses |rotation| = exp(-1/(FS*tau)) < 1 so each mode
    rings down exponentially. The kernel is agnostic to the magnitude.
    """
    g = np.random.default_rng(seed)
    per = max(1, n_modes // 32)  # micro-modes per partial
    k = np.repeat(np.arange(1, n_modes // per + 1), per)[:n_modes]
    detune = 1.0 + 0.0012 * g.standard_normal(n_modes)  # ~2 cents spread
    freq = f0 * k * np.sqrt(1.0 + 1.2e-4 * k * k) * detune
    freq = np.clip(freq, 20.0, 0.45 * FS)  # keep below the fold
    amp = (1.0 / k ** 1.1) * (0.7 + 0.6 * g.random(n_modes))
    tau = 5.0 / (1.0 + 0.12 * k)  # seconds to 1/e, shorter up high
    r = np.exp(-1.0 / (FS * tau))
    w = 2.0 * np.pi * freq / FS
    phase = 2.0 * np.pi * g.random(n_modes)
    return (
        amp.astype(np.float32),
        (r * np.cos(w)).astype(np.float32),
        (r * np.sin(w)).astype(np.float32),
        np.cos(phase).astype(np.float32),
        np.sin(phase).astype(np.float32),
    )


Carry = Tuple[torch.Tensor, torch.Tensor]


class Stream:
    """The bank's chainable block step on ``dev``: ``carry0`` is the
    amp-prefolded phasor (re, im), ``run(carry, n)`` -> (carry', audio
    (n * BLOCK,) on the host)."""

    def __init__(self, amp, cos_w, sin_w, re0, im0, dev: torch.device):
        self.dev = dev
        self.cos_w = torch.from_numpy(cos_w).to(dev)
        self.sin_w = torch.from_numpy(sin_w).to(dev)
        self.carry0 = self.put((amp * re0, amp * im0))

    def put(self, pair) -> Carry:
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)
                     for a in pair)

    def run(self, carry: Carry, n: int) -> Tuple[Carry, np.ndarray]:
        from gpuaudiobench_tpu_torch.ops.modal import modal_folded_step

        re, im = carry
        blocks: List[torch.Tensor] = []
        for _ in range(n):
            out, re, im = modal_folded_step(self.cos_w, self.sin_w, re, im,
                                            BLOCK, 1)
            blocks.append(out[:, 0])
        audio = (torch.cat(blocks).cpu().numpy() if blocks
                 else np.zeros(0, np.float32))
        return (re, im), audio


def make_stream(amp, cos_w, sin_w, re0, im0,
                dev: torch.device) -> Tuple[Stream, Carry]:
    stream = Stream(amp, cos_w, sin_w, re0, im0, dev)
    return stream, stream.carry0


def strike(amp: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The second strike's kick to the carry, 0.7x a fresh-phase strike
    (float32, as the JAX example adds it): a real mallet does not
    reproduce the first strike's phase alignment, and re-adding the
    initial phasors verbatim comb-filters against the rotated state.
    Deterministic seed, so a resumed render reproduces it exactly."""
    g2 = np.random.default_rng(11)
    ph2 = 2.0 * np.pi * g2.random(amp.shape[0]).astype(np.float32)
    hit = (amp * np.cos(ph2).astype(np.float32),
           amp * np.sin(ph2).astype(np.float32))
    return tuple(0.7 * s for s in hit)


def kicked(carry: Carry, kick) -> Carry:
    return tuple(c + torch.from_numpy(k).to(c.device)
                 for c, k in zip(carry, kick))


def blocks_for(seconds: float) -> Tuple[int, int]:
    """(blocks, the block of the checkpoint and the second strike)."""
    n_blocks = max(2, int(seconds * FS / BLOCK))
    return n_blocks, n_blocks // 2


def resume(ckpt: str, stream: Stream, kick, n: int) -> np.ndarray:
    """The render after a checkpoint: restore the carry from ``ckpt``
    (written by this example or by the JAX one), strike, run n blocks."""
    from gpuaudiobench_tpu_torch.harness.checkpoint import load_stream_state

    template = stream.put(tuple(np.zeros_like(k) for k in kick))
    restored, _ = load_stream_state(ckpt, template,
                                    benchmark=CHECKPOINT_NAME)
    return stream.run(kicked(restored, kick), n)[1]


def render(seconds: float, modes: int, f0: float, ckpt: str,
           dev: torch.device) -> Tuple[np.ndarray, bool]:
    """(audio, resumed bit-exact): the first half, a checkpoint at the
    block boundary, the second strike, the second half; then the second
    half again from the checkpoint."""
    from gpuaudiobench_tpu_torch.harness.checkpoint import save_stream_state

    amp, cos_w, sin_w, re0, im0 = bell_modes(modes, f0)
    stream, carry = make_stream(amp, cos_w, sin_w, re0, im0, dev)
    kick = strike(amp)
    n_blocks, half = blocks_for(seconds)
    carry, first = stream.run(carry, half)
    save_stream_state(ckpt, carry, benchmark=CHECKPOINT_NAME)
    # The strike lands after the save, so a resumed render repeats it.
    _, second = stream.run(kicked(carry, kick), n_blocks - half)
    again = resume(ckpt, stream, kick, n_blocks - half)
    return np.concatenate([first, second]), np.array_equal(again, second)


def write_wav(path: str, audio: np.ndarray) -> float:
    """Mono 16-bit WAV of ``audio`` normalized to its peak; returns it."""
    peak = float(np.abs(audio).max()) or 1.0
    pcm = (np.clip(audio / peak, -1, 1) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(FS)
        w.writeframes(pcm.tobytes())
    return peak


def main(argv: Optional[List[str]] = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--modes", type=int, default=2048)
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(), "bell.wav"))
    ap.add_argument("--f0", type=float, default=220.0)
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from gpuaudiobench_tpu_torch.utils import device as dv

    ckpt = os.path.splitext(args.out)[0] + ".state.npz"
    audio, resumed_ok = render(args.seconds, args.modes, args.f0, ckpt,
                               dv.device(args.device))
    peak = write_wav(args.out, audio)
    half = blocks_for(args.seconds)[1]
    print(f"wrote {args.out}: {len(audio) / FS:.2f} s, {args.modes} modes, "
          f"peak {peak:.3f}, strike #2 at {half * BLOCK / FS:.2f} s")
    print(f"checkpoint/resume bit-exact: {resumed_ok} ({ckpt})")
    return 0 if resumed_ok else 1


if __name__ == "__main__":
    sys.exit(main())
