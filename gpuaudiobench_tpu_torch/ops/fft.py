"""Batched real FFT: the cuFFT path through ``torch.fft``.

PyTorch counterpart of ``gpuaudiobench_tpu/ops/fft.py`` (FFTBenchmark,
cuda/bench_fft.cu: a batched real-to-complex FFT of fixed size 1024,
cufftPlan1d R2C over nTracks, bench_fft.cu:104-110). The JAX package
runs it on XLA's FFT; there is no Pallas kernel, and ``torch.fft.rfft``
is cuFFT on the card.
"""

from __future__ import annotations

import torch

FFT_SIZE = 1024  # bench_fft.cuh:440 (FFT_SIZE = 1024)


def rfft_interleaved(x: torch.Tensor, fft_size: int = FFT_SIZE) -> torch.Tensor:
    """x (tracks, fft_size) pre-padded real input -> float32
    (tracks, fft_size//2 + 1, 2): per bin [re, im], the cufftComplex
    layout (a view of the complex result, no copy)."""
    return torch.view_as_real(torch.fft.rfft(x, n=fft_size, dim=-1))
