"""Deterministic test data and filter design.

A copy of the pieces of ``gpuaudiobench_tpu/utils/data.py`` that the
port reads, so it never imports the reference package;
``tests/test_torch_iir_bench.py``, ``test_torch_conv.py`` and
``test_torch_rndmem.py`` hold each copy equal to its original, bit for
bit:

* ``generate_random_audio``: uniform [-1, 1) float32 from NumPy's
  MT19937 stream (the reference's seeded test signal,
  cuda/bench_utils.cu:238-245).
* ``generate_uniform01``: uniform [0, 1) float32 from the same stream
  (RndMemRead's sample pool, bench_rndmem.cu:143).
* ``biquad_lowpass_coefficients``: RBJ/Butterworth lowpass at a
  normalized frequency, Q = 0.707, a0-normalized
  (cuda/bench_iir.cu:199-226).
* ``conv1d_impulse_responses``: the per-track windowed-sinc IR bank of
  Conv1D and Conv1D_accel (cuda/bench_conv1d.cu:159-181).
* ``reverb_impulse_responses``: PartConv's and DAWSessionMix's decaying
  noise IRs (``tests/test_torch_partconv.py`` holds it bit for bit).
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.MT19937(seed))


def generate_random_audio(n: int, seed: int = 42) -> np.ndarray:
    """Uniform [-1, 1) float32 audio samples."""
    g = _rng(seed)
    return (g.random(n, dtype=np.float32) * 2.0 - 1.0).astype(np.float32)


def generate_uniform01(n: int, seed: int = 42) -> np.ndarray:
    """Uniform [0, 1) float32 samples."""
    return _rng(seed).random(n, dtype=np.float32)


def conv1d_impulse_responses(track_count: int, ir_length: int) -> np.ndarray:
    """Per-track windowed-sinc IR bank, (tracks, ir_length) float32."""
    tracks = np.arange(track_count, dtype=np.float32)[:, None]
    i = np.arange(ir_length, dtype=np.float32)[None, :]
    freq = 0.1 + 0.05 * tracks / np.float32(track_count)
    t = i - np.float32(ir_length) / 2.0
    window = 0.54 - 0.46 * np.cos(
        2.0 * np.float32(np.pi) * i / np.float32(ir_length - 1)
    )
    arg = 2.0 * np.float32(np.pi) * freq * t
    sinc = np.where(t == 0.0, np.float32(1.0),
                    np.sin(arg) / np.where(arg == 0.0, 1.0, arg))
    return (window * sinc / np.float32(ir_length)).astype(np.float32)


def biquad_lowpass_coefficients(normalized_frequency: float, q: float = 0.707):
    """2nd-order Butterworth lowpass biquad as (b0, b1, b2, a1, a2)
    float32."""
    omega = 2.0 * np.pi * normalized_frequency
    cos_w = np.cos(omega)
    sin_w = np.sin(omega)
    alpha = sin_w / (2.0 * q)
    b0 = (1.0 - cos_w) / 2.0
    b1 = 1.0 - cos_w
    b2 = (1.0 - cos_w) / 2.0
    a0 = 1.0 + alpha
    a1 = -2.0 * cos_w
    a2 = 1.0 - alpha
    return tuple(np.float32(v / a0) for v in (b0, b1, b2, a1, a2))


def reverb_impulse_responses(track_count: int, ir_length: int,
                             seed: int = 42) -> np.ndarray:
    """(T, L) exponentially decaying noise IRs (60 dB over the full
    length, T60 = L/fs), L2-normalized per track."""
    g = _rng(seed)
    noise = (g.random((track_count, ir_length), dtype=np.float32) * 2.0
             - 1.0)
    t = np.arange(ir_length, dtype=np.float32)
    decay = np.exp(np.float32(np.log(1e-3)) * t
                   / np.float32(max(ir_length - 1, 1)))
    ir = noise * decay[None, :]
    norm = np.sqrt((ir.astype(np.float64) ** 2).sum(axis=1, keepdims=True))
    return (ir / np.maximum(norm, 1e-12)).astype(np.float32)
