"""FFT1D: batched real-to-complex FFT of fixed size 1024 (cuda/bench_fft.cu).

PyTorch counterpart of ``gpuaudiobench_tpu/models/fft.py``. The input is
the seeded +-1 signal per track, zero-padded when bufferSize < 1024 and
truncated above (bench_fft.cu:33-42). The spectrum comes back in one
copy as (tracks, 513, 2) float32, per bin [re, im]: the cufftComplex
layout. Golden: NumPy's float64 rfft; error |d_re| + |d_im| <= 1e-3
(bench_fft.cu:79-98).
"""

from __future__ import annotations

import numpy as np
import torch

from gpuaudiobench_tpu_torch.config import BenchConfig
from gpuaudiobench_tpu_torch.harness.validation import ValidationData, compare_complex
from gpuaudiobench_tpu_torch.models.common import StandardBufferBenchmark
from gpuaudiobench_tpu_torch.ops.fft import FFT_SIZE, rfft_interleaved
from gpuaudiobench_tpu_torch.utils.data import generate_random_audio


class FFTBenchmark(StandardBufferBenchmark):
    name = "FFT1D"
    tolerance = 1e-3  # bench_fft.cu:93

    def __init__(self, cfg: BenchConfig, device: torch.device):
        super().__init__(cfg, device)
        self.fft_size = FFT_SIZE
        self.bins = self.fft_size // 2 + 1

    def setup(self) -> None:
        t, s = self.track_count, self.buffer_size
        n = min(s, self.fft_size)
        data = generate_random_audio(t * n, self.cfg.seed).reshape(t, n)
        self.host_input = np.zeros((t, self.fft_size), np.float32)
        self.host_input[:, :n] = data
        self.setup_sharding(t)
        self._resident_input = self.put_input(self.host_input)
        self.track_alloc("inputBuffers", self.host_input.nbytes * 2)
        self.track_alloc("outputBuffers", t * self.bins * 8 * 2)
        spec = np.fft.rfft(self.host_input.astype(np.float64), axis=-1)
        self.golden_re = spec.real.astype(np.float32)
        self.golden_im = spec.imag.astype(np.float32)
        self.host_re = None
        self.host_im = None
        self.iterate()

    def iterate(self) -> None:
        x = self.put_input(self.host_input)
        buf = self.to_host(rfft_interleaved(x, self.fft_size))
        self.host_re = buf[..., 0]
        self.host_im = buf[..., 1]

    def device_iterate(self) -> None:
        rfft_interleaved(self._resident_input, self.fft_size)

    def stream_body(self):
        return self.stateless_stream(
            lambda x: rfft_interleaved(x, self.fft_size))

    def overlap_body(self):
        return self.stateless_overlap(
            lambda x: rfft_interleaved(x, self.fft_size))

    def validate(self) -> ValidationData:
        return compare_complex(
            self.host_re, self.host_im, self.golden_re, self.golden_im,
            self.tolerance, mode=self.cfg.verification,
            limit=self.cfg.spot_sample_limit, label=self.name,
        )

    def total_elements(self) -> int:
        return self.track_count * self.fft_size

    def bytes_processed(self) -> int:
        # real input + complex output (bench_fft.cu buffer sizes)
        return self.track_count * (self.fft_size * 4 + self.bins * 8)

    def cost_model(self):
        import math

        t, f = self.track_count, self.fft_size
        return {
            "flops": int(t * 2.5 * f * math.log2(f)),
            "hbm_bytes": t * (f * 4 + self.bins * 8),
            "unit": "vpu",
        }

    def metadata(self):
        return {"fftSize": self.fft_size, "bins": self.bins}

    def transfer_model(self):
        """Real frames up, (bins, re+im) spectra down."""
        return {"h2d_bytes": self.track_count * self.fft_size * 4,
                "d2h_bytes": self.track_count * self.bins * 2 * 4}
