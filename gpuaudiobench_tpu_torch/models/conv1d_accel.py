"""Conv1D_accel: FFT (fast) convolution (cuda/bench_conv1d_accel.cu).

PyTorch counterpart of ``gpuaudiobench_tpu/models/conv1d_accel.py``. The
IR length defaults to 512 (bench_conv1d_accel.cuh:506); fftSize =
nextPow2(irLen + bufferSize - 1) (bench_conv1d_accel.cu:52). The IR
spectra are computed once at set-up and stay on the device; per
iteration: zero-pad, rfft, pointwise complex multiply, irfft, first
bufferSize samples, all on ``torch.fft`` (cuFFT on the card), written
*interleaved* out[nTracks*i + track] (ExtractRealPartKernel,
bench_conv1d_accel.cu:41-46). The interleave is a transpose on the device
before the one readback.

Golden: the time-domain convolution clamped within each track
(conv1DCPUReference, bench_conv1d_accel.cu:230-252), at 1e-3 relative to
its peak. Like the JAX package, this computes the correctly normalised
fast convolution, not the reference's ExtractRealPartKernel, which reads
the unnormalised C2R output through a stride-2 complex view (a reference
bug). Under spot verification the golden is computed for the tracks the
spot check reads only, and the peak is taken over those tracks.
"""

from __future__ import annotations

import numpy as np
import torch

from gpuaudiobench_tpu_torch.harness.validation import (
    ValidationData,
    compare_rel,
    spot_indices,
)
from gpuaudiobench_tpu_torch.models.common import (
    StandardBufferBenchmark,
    expand_rows,
)
from gpuaudiobench_tpu_torch.models.conv1d import conv1d_reference
from gpuaudiobench_tpu_torch.ops.conv import conv1d_fft, precompute_ir_spectra
from gpuaudiobench_tpu_torch.utils import device as dev
from gpuaudiobench_tpu_torch.utils.data import conv1d_impulse_responses

DEFAULT_IR_LENGTH = 512  # bench_conv1d_accel.cuh:506


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class Conv1DAccelBenchmark(StandardBufferBenchmark):
    name = "Conv1D_accel"
    tolerance = 1e-3  # relative, bench_conv1d_accel.cu:310

    def __init__(self, cfg, device: torch.device):
        super().__init__(cfg, device)
        self.ir_length = cfg.ir_length or DEFAULT_IR_LENGTH

    def setup(self) -> None:
        self.setup_standard_buffers()
        self.load_data(self.host_input, conv1d_impulse_responses(
            self.track_count, self.ir_length))

    def load_data(self, host_input: np.ndarray, ir: np.ndarray) -> None:
        """Take the input block and the (tracks, L) IR bank (e.g. a JAX
        benchmark's ``host_input`` and ``ir``), compute the IR spectra on
        the device and run one iteration."""
        if host_input is not self.host_input:
            self.set_input(host_input)
        if ir.dtype != np.float32 or ir.ndim != 2 or ir.shape[0] != self.track_count:
            raise ValueError(
                f"{self.name}: need a float32 ({self.track_count}, L) IR "
                f"bank, got {ir.dtype} {ir.shape}")
        self.ir = ir
        self.ir_length = ir.shape[1]
        self.fft_size = next_pow2(self.ir_length + self.buffer_size - 1)
        self._ir_spec_dev = precompute_ir_spectra(
            dev.to_device(ir, self.device), self.fft_size)
        self.track_alloc("irSpectra",
                         self.track_count * (self.fft_size // 2 + 1) * 8)
        self.golden = None
        self.iterate()

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d_fft(x, self._ir_spec_dev, self.fft_size,
                          self.buffer_size)

    def iterate(self) -> None:
        y = self._run(self.put_input(self.host_input))
        self.host_output = dev.from_device(y.t().contiguous()).ravel()

    def device_iterate(self) -> None:
        self._run(self._resident_input)

    def stream_body(self):
        return self.stateless_stream(self._run)

    def validate(self) -> ValidationData:
        # Relative-to-peak metric (error <= tol * max|golden|, the DSP
        # full-scale convention): a per-sample relative metric diverges
        # at the output's zero crossings, where f32 FFT rounding is
        # unbounded relative to a ~0 golden.
        if self.cfg.verification == "none":
            return compare_rel(self.host_output, self.host_output,
                               self.tolerance, mode="none", label=self.name)
        t, s = self.host_input.shape
        rows = None
        if self.cfg.verification == "spot":
            idx = spot_indices(t * s, self.cfg.spot_sample_limit)
            rows = np.unique(idx % t)
        g = expand_rows(conv1d_reference(self.host_input, self.ir, "clamp",
                                         rows), rows, (t, s))
        self.golden = g.T.ravel()  # out[T*i + t]
        floor = float(np.nanmax(np.abs(self.golden)))
        return compare_rel(
            self.host_output, self.golden, self.tolerance,
            mode=self.cfg.verification, limit=self.cfg.spot_sample_limit,
            label=self.name, floor=floor,
        )

    def cost_model(self):
        import math

        t, s, f = self.track_count, self.buffer_size, self.fft_size
        fft_flops = 2.5 * f * math.log2(f)  # real-FFT flop model, per track
        bins = f // 2 + 1
        return {
            "flops": int(t * (2 * fft_flops + 6 * bins)),
            "hbm_bytes": (t * s * 2 + t * bins * 2) * 4,
            "unit": "fp32",
        }

    def metadata(self):
        return {"irLength": self.ir_length, "fftSize": self.fft_size}
