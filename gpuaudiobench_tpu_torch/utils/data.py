"""Deterministic test data and filter design.

A copy of the pieces of ``gpuaudiobench_tpu/utils/data.py`` that the
port reads, so it never imports the reference package;
``tests/test_torch_iir_bench.py`` holds each copy equal to its original,
bit for bit:

* ``generate_random_audio``: uniform [-1, 1) float32 from NumPy's
  MT19937 stream (the reference's seeded test signal,
  cuda/bench_utils.cu:238-245).
* ``biquad_lowpass_coefficients``: RBJ/Butterworth lowpass at a
  normalized frequency, Q = 0.707, a0-normalized
  (cuda/bench_iir.cu:199-226).
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.MT19937(seed))


def generate_random_audio(n: int, seed: int = 42) -> np.ndarray:
    """Uniform [-1, 1) float32 audio samples."""
    g = _rng(seed)
    return (g.random(n, dtype=np.float32) * 2.0 - 1.0).astype(np.float32)


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
